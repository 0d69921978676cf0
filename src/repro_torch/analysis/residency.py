"""Residency / schedule-legality pass over lowered phase programs.

The sharded interpreter (`core/distributed.ProgramCapability`) executes
whatever the phase program declares — so the program must actually be
executable under its contract.  This pass recomputes every derived fact
from the raw phase list (never trusting the ``schedule`` / ``capability``
/ ``fused`` / ``cuda`` properties it is checking) and verifies:

  * **phase grammar** — known (op, variant) pairs, exactly one trailing
    ``commit``, at least one ``draw`` before the first ``score``;
  * **residency legality** — ``v_prev`` operands exist only on ``score``
    phases (the interpreter only routes the verify/score superstep to
    owner(v_prev); a draw or gather at v_prev has no executor), and only
    under the ``two_phase`` / ``chunked_loop`` schedules;
  * **carry discipline** — a cross-residency split needs a task-word
    payload produced at owner(v_curr) before owner(v_prev) consumes it:
    ``candidates`` ⇒ a ``gather`` precedes the v_prev ``score``;
    ``reservoir`` ⇒ the looping chunk ``gather`` precedes the v_prev
    fold; single-residency programs must carry ``none`` (task words are
    sized from the carry — an oversized carry wastes the wire format, a
    missing one drops the payload);
  * **width plumbing** — a multi-candidate ``score`` consumes a
    ``gather`` of the same width, and the ``draw`` provides at least as
    many uniforms as the widest consumer;
  * **derived-flag honesty** — the ``schedule`` / ``capability`` /
    ``cuda`` (the one-hop walk-step kernels' coverage; the reference's
    ``pallas``) properties equal their recomputation, and ``fused`` stays
    total (the fused engine has no plain-superstep fallback);
  * **requires completeness** — each gather segment declares its graph
    payload (``alias`` / ``typed`` / ``chunk``→``weights``).
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.report import Finding
from repro_torch.core.phase_program import (PhaseProgram, _default_spec,
                                           lower)
from repro_torch.core.samplers import KINDS

_OPS = {("draw", ""), ("gather", "alias"), ("gather", "typed"),
        ("gather", "csr"), ("gather", "chunk"),
        ("score", "pick_uniform"), ("score", "alias_accept"),
        ("score", "first_accept"), ("score", "es_reservoir"),
        ("commit", "")}
_GATHER_REQUIRES = {"alias": "alias", "typed": "typed", "chunk": "weights"}


def check_program(prog: PhaseProgram) -> List[Finding]:
    findings = []
    kind = prog.kind

    def flag(site, msg):
        findings.append(Finding("residency", f"{kind}.{site}", msg))

    phases = prog.phases
    # ---- phase grammar --------------------------------------------------
    for n, ph in enumerate(phases):
        if (ph.op, ph.variant) not in _OPS:
            flag(f"phases[{n}]", f"unknown phase ({ph.op!r}, "
                 f"{ph.variant!r}) — no executor in any backend")
        if ph.residency not in ("v_curr", "v_prev"):
            flag(f"phases[{n}]", f"unknown residency {ph.residency!r}")
    commits = [n for n, ph in enumerate(phases) if ph.op == "commit"]
    if commits != [len(phases) - 1]:
        flag("phases", f"program must end with exactly one commit "
             f"(found commit at {commits or 'nowhere'}) — column access "
             f"and hop advance are engine-owned and run last")
    scores = [n for n, ph in enumerate(phases) if ph.op == "score"]
    draws = [n for n, ph in enumerate(phases) if ph.op == "draw"]
    if scores and (not draws or draws[0] > scores[0]):
        flag(f"phases[{scores[0]}]", "score precedes any draw — its "
             "uniforms are never produced")

    # ---- residency legality --------------------------------------------
    vprev = [n for n, ph in enumerate(phases) if ph.residency == "v_prev"]
    for n in vprev:
        if phases[n].op != "score":
            flag(f"phases[{n}]", f"{phases[n].op} phase at v_prev — the "
                 f"sharded interpreter only routes score phases to "
                 f"owner(v_prev); move the operand materialization to "
                 f"v_curr and thread it through the carry")

    # ---- recomputed schedule / capability / cuda ------------------------
    expect_schedule = ("chunked_loop" if prog.loop else
                       "two_phase" if vprev else "single_phase")
    if prog.schedule != expect_schedule:
        flag("schedule", f"declares {prog.schedule!r} but the phase "
             f"facts imply {expect_schedule!r}")
    expect_cap = {"single_phase": "first_order", "two_phase": "two_phase",
                  "chunked_loop": "chunked_reservoir"}[expect_schedule]
    if prog.capability != expect_cap:
        flag("capability", f"declares {prog.capability!r} but schedule "
             f"{expect_schedule!r} implies {expect_cap!r} — the "
             f"dispatch key must be recomputed, not trusted")
    if not prog.fused:
        flag("fused", "program opts out of the fused kernel — the "
             "fused engine has no plain-superstep fallback; every program "
             "must lower to the device-resident superstep")
    expect_cuda = not vprev and not prog.loop and (
        "typed" not in prog.requires)
    if prog.cuda != expect_cuda:
        flag("cuda", f"declares cuda={prog.cuda} but the one-hop walk-step "
             f"kernels cover exactly single-residency loop-free "
             f"non-typed programs (⇒ {expect_cuda})")

    # ---- carry discipline ----------------------------------------------
    if vprev or prog.loop:
        if prog.carry == "none":
            flag("carry", f"schedule {expect_schedule!r} splits the hop "
                 f"across owners but carry='none' — the verify/fold "
                 f"superstep would receive no payload; declare "
                 f"'candidates' or 'reservoir'")
        else:
            gathers = [n for n, ph in enumerate(phases)
                       if ph.op == "gather"]
            consumer = vprev[0] if vprev else (scores[0] if scores
                                               else len(phases))
            if not gathers or gathers[0] > consumer:
                flag("carry", f"carry {prog.carry!r} consumed at "
                     f"phases[{consumer}] but no gather produces it "
                     f"earlier — payloads must be produced at "
                     f"owner(v_curr) before owner(v_prev) consumes them")
        if prog.loop and prog.carry != "reservoir":
            flag("carry", f"chunked_loop requires the 'reservoir' carry "
                 f"(running E-S maximum + chunk counter), got "
                 f"{prog.carry!r}")
    elif prog.carry != "none":
        flag("carry", f"single-residency program declares carry "
             f"{prog.carry!r} — task words are sized from the carry; "
             f"drop it")

    # ---- width plumbing -------------------------------------------------
    draw_width = max((phases[n].width for n in draws), default=0)
    for n in scores:
        ph = phases[n]
        if ph.width <= 1:
            continue
        feeding = [phases[m] for m in range(n) if phases[m].op == "gather"
                   and phases[m].width == ph.width]
        if not feeding:
            flag(f"phases[{n}]", f"score width {ph.width} but no "
                 f"preceding gather stages {ph.width} candidates")
        if draw_width < ph.width:
            flag(f"phases[{n}]", f"score consumes {ph.width} candidates "
                 f"but the draw provides only {draw_width} uniforms")

    # ---- requires completeness -----------------------------------------
    for n, ph in enumerate(phases):
        need = _GATHER_REQUIRES.get(ph.variant) if ph.op == "gather" \
            else None
        if need and need not in prog.requires:
            flag(f"phases[{n}]", f"gather:{ph.variant} needs the "
                 f"{need!r} graph payload but requires={prog.requires}")
    return findings


def check_repo() -> List[Finding]:
    findings = []
    for kind in KINDS:
        findings += check_program(lower(_default_spec(kind)))
    return findings
