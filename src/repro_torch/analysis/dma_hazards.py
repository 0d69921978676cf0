"""DMA hazard pass: prove every declared kernel schedule pipeline-safe.

Input is the ``dma_schedule()`` declaration a kernel that issues
asynchronous copies exports beside its loop (`kernels/common.DmaOp`
sequences in program order).  In the port that is the fused kernel's
reservoir chunk loop, whose (lane, chunk) items stream the chunk's
columns and weights through a ``cp.async`` ping-pong in shared memory
(`kernels/fused_superstep/schedule.py`).  The checker is the reference's
(`repro/analysis/dma_hazards.py`), finding for finding: a single forward
scan holding per-``(buffer, slot)`` state:

  * **read-before-arrival** — a ``read`` is legal only when the latest
    copy issued on its slot has been waited (and some copy ever filled
    the slot);
  * **overwrite-while-in-flight** — a ``start`` or ``write`` on a slot
    with an un-waited copy clobbers data the copy engine is still moving;
  * **malformed wait** — a ``wait`` must name the copy currently in
    flight on its slot (waiting a never-started / already-waited /
    wrong-slot copy means the group accounting is off by one);
  * **un-drained copy** — every copy started must be waited before the
    kernel returns;
  * **phantom copy** — a ``start`` targeting a launch-resident buffer
    (one the schedule reads with ``tier="vmem"``, or tagged so itself):
    a cache hit path that still copies from device memory.

``read`` ops with ``tier="vmem"`` are cache-hit reads: they touch on-chip
memory only, so no dominating wait is required and they participate in
no slot state.  ``visit`` ops are checked against the output-revisit
contract of a grid-scheduled kernel (revisits consecutive, the first
visit flag on exactly the first visit of each block); no kernel of the
port declares one, but the pass keeps the check and its fixtures.

Because the staged loop is slot-periodic with period 2, the small unrolls
the declarations use (n ≥ 3) exhaust the reachable state space.  What
the kernel really issues is held to the declaration on the card: a traced
launch (`kernels/fused_superstep/ops.trace_schedule`) records one warp's
ops, and ``chip_smoke.py`` phase 9 checks them with this pass and against
``dma_schedule`` op for op.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.report import Finding
from repro_torch.kernels.common import DmaOp

Slot = Tuple[str, int]


def check_schedule(ops: Sequence[DmaOp], name: str = "kernel"
                   ) -> List[Finding]:
    """Forward-scan hazard check of one declared DMA schedule."""
    findings = []
    in_flight: Dict[Slot, int] = {}   # slot -> un-waited copy id
    copy_slot: Dict[int, Slot] = {}   # copy id -> slot it was issued on
    filled: Dict[Slot, bool] = {}     # slot has waited-arrived contents
    visits: List[DmaOp] = []

    def flag(i, op, msg):
        findings.append(Finding("dma", f"{name}[{i}]", f"{op.kind} "
                                f"{op.buffer}/slot{op.slot}: {msg}"))

    # Buffers the schedule declares launch-resident (cache tier): any read
    # at tier="vmem" marks its buffer as on-chip for the whole schedule.
    vmem_bufs = {op.buffer for op in ops
                 if getattr(op, "tier", "hbm") == "vmem"}

    for i, op in enumerate(ops):
        slot = (op.buffer, op.slot)
        if op.kind == "read" and getattr(op, "tier", "hbm") == "vmem":
            continue  # on-chip read: no copy, no slot state
        if op.kind == "start":
            if op.tier == "vmem" or op.buffer in vmem_bufs:
                flag(i, op, "DMA start into a VMEM-resident cache buffer "
                            "(phantom copy) — cached hit paths must serve "
                            "from on-chip memory without issuing copies")
                continue
            if slot in in_flight:
                flag(i, op, f"re-issued while copy {in_flight[slot]} is "
                            f"still un-waited (overwrite-while-in-flight)"
                            f" — wait the prior copy before reusing the "
                            f"slot")
            in_flight[slot] = op.copy
            copy_slot[op.copy] = slot
            filled[slot] = False
        elif op.kind == "wait":
            if op.copy not in copy_slot:
                flag(i, op, f"waits copy {op.copy} that was never "
                            f"started")
            elif copy_slot[op.copy] != slot:
                b, s = copy_slot[op.copy]
                flag(i, op, f"waits copy {op.copy} on the wrong slot "
                            f"(started on {b}/slot{s})")
            elif in_flight.get(slot) != op.copy:
                flag(i, op, f"waits copy {op.copy} which is not in "
                            f"flight there (already waited, or a newer "
                            f"copy {in_flight.get(slot)} superseded it)")
            else:
                del in_flight[slot]
                filled[slot] = True
        elif op.kind == "read":
            if slot in in_flight:
                flag(i, op, f"read while copy {in_flight[slot]} is "
                            f"un-waited (read-before-arrival) — insert "
                            f"the copy-wait before consuming the slot")
            elif not filled.get(slot, False):
                flag(i, op, "read of a slot no waited copy ever filled "
                            "(read-before-arrival)")
        elif op.kind == "write":
            if slot in in_flight:
                flag(i, op, f"overwritten while copy {in_flight[slot]} "
                            f"is un-waited (overwrite-while-in-flight) — "
                            f"reclaim the staging slot with its delayed "
                            f"wait first")
            filled[slot] = True
        elif op.kind == "visit":
            visits.append(op)
        else:
            flag(i, op, f"unknown op kind {op.kind!r}")

    for slot, cid in sorted(in_flight.items()):
        findings.append(Finding(
            "dma", f"{name}[end]",
            f"copy {cid} on {slot[0]}/slot{slot[1]} never waited — "
            f"drain all outstanding copies before the kernel returns"))
    findings += _check_visits(visits, name)
    return findings


def _check_visits(visits: Sequence[DmaOp], name: str) -> List[Finding]:
    """Output-revisit contract over ``visit`` ops (grid-order block
    sequence with declared first/live flags)."""
    findings = []
    closed = set()    # blocks already left
    initialized = set()
    current = None
    for i, op in enumerate(visits):
        block = op.slot
        site = f"{name}.visit[{i}]"
        if block != current:
            if current is not None:
                closed.add(current)
            if block in closed:
                findings.append(Finding(
                    "dma", site,
                    f"output block {block} revisited non-consecutively "
                    f"(left after an earlier visit) — Pallas revisits "
                    f"must be consecutive; sort segments / fix the "
                    f"index_map clamp"))
            current = block
        if op.first:
            if block in initialized:
                findings.append(Finding(
                    "dma", site,
                    f"first_visit set on a revisit of block {block} — "
                    f"would zero a partially accumulated output block"))
            initialized.add(block)
        elif op.live and block not in initialized:
            findings.append(Finding(
                "dma", site,
                f"live accumulation into block {block} before any "
                f"first_visit zero-init — reads uninitialized output"))
    return findings


def kernel_schedules():
    """Name → declared op list of every schedule a kernel of the port
    declares: the fused kernel's reservoir chunk loop, uncached and fully
    hit.  The other kernels and fused kinds issue no asynchronous copy and
    declare none (imported lazily, as the reference does)."""
    from repro_torch.kernels.fused_superstep.schedule import dma_schedule
    return {"fused_superstep.reservoir_n2v": dma_schedule("reservoir_n2v"),
            "fused_superstep.reservoir_n2v.cached": dma_schedule(
                "reservoir_n2v", cached=True)}


def check_repo() -> List[Finding]:
    findings = []
    for name, ops in kernel_schedules().items():
        findings += check_schedule(ops, name)
    return findings
