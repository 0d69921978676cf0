"""Tuning orchestration: cache -> model -> (optional) measurement.

Two entry points:

* :func:`resolve` — what ``walker/compile.py`` calls when an
  ``ExecutionConfig`` carries ``"auto"`` sentinels (or a reservoir spec
  carries ``adaptive_chunks="auto"``).  **Never times anything**: it
  answers from the tuning cache, falling back to the analytical model
  (`repro_torch.tune.model`) on a miss — so binding a Walker stays
  deterministic.  Populate the cache with measured entries via
  ``python -m repro_torch.tune``.

* :func:`autotune` — the full measurement-driven loop: enumerate the
  valid knob grid, measure a small *anchor* set, fit the roofline
  coefficients from those samples, model-prune the grid to ``keep``
  candidates, measure the survivors interleaved, and pick the winner.
  The default configuration is always kept in the measured set and the
  winner must beat it by ``min_gain`` — so a tuned config can never
  lose to the default it replaced (the tuned-vs-default benchmark
  invariant).  Pass an :class:`~repro_torch.tune.measure.InjectedMeasurer`
  to run the whole loop deterministically (tests), or
  ``measurer=None`` for model-only mode (``--no-measure``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.tune import model as _model
from repro_torch.tune.cache import (TuningCache, cache_key,
                                    default_cache_path, graph_signature)
from repro_torch.tune.space import (EXEC_KNOBS, Candidate, default_candidate,
                                    enumerate_candidates, knobs_for)


def _device_kind(graph) -> str:
    """The machine axis of the cache key: the name of the card the graph
    lives on, or ``cpu`` for a graph on the host."""
    if graph.device.type == "cuda":
        return torch.cuda.get_device_name(graph.device)
    return "cpu"


def _key(graph, sig, program, execution, backend, num_queries) -> str:
    # The interpret flag stays 0: the port has no interpreter, and the key
    # keeps the reference's shape.
    return cache_key(sig, program.spec.kind, backend, execution.step_impl,
                     _device_kind(graph), False, num_queries)


def needs_resolution(program, execution) -> bool:
    """Does this (program, execution) carry any unresolved sentinel?"""
    if getattr(execution, "has_auto", False):
        return True
    return (program.spec.kind == "reservoir_n2v"
            and program.spec.adaptive_chunks == "auto")


@dataclasses.dataclass
class TuneResult:
    """Outcome of one tuning run (see :func:`autotune`)."""

    candidate: Candidate
    program: object
    execution: object
    key: str
    signature: object
    source: str                        # "cache" | "model" | "measured"
    measured: Dict[Candidate, float]
    predicted: Dict[Candidate, float]
    coeffs: Optional[_model.CostCoeffs] = None


def _filter_to_known(knobs: dict, program, execution, backend: str,
                     include_resampling: bool) -> dict:
    """Keep only cached knob values that are valid axes here and now."""
    valid = {k.name: k for k in knobs_for(program, execution, backend)}
    out = {}
    for name, val in knobs.items():
        k = valid.get(name)
        if k is None:
            continue
        if not include_resampling and not k.path_preserving:
            continue
        out[name] = val
    return out


def _complete(partial: dict, program, execution, backend: str) -> Candidate:
    """Fill unassigned knobs with the default-candidate values."""
    knobs = knobs_for(program, execution, backend)
    vals = default_candidate(program, execution, knobs).to_dict()
    vals.update(partial)
    return Candidate.of(**vals)


def _build_runners(graph, program, execution, backend, candidates,
                   num_queries, seed, runners=None):
    """Zero-arg closed-run callables, one per candidate, each returning
    with the graph's device idle."""
    from repro_torch.walker.compile import compile as compile_walker
    n = int(graph.num_vertices)
    starts = (torch.arange(int(num_queries), dtype=torch.int64,
                           device=graph.device) % n).to(torch.int32)
    on_card = graph.device.type == "cuda"
    runners = dict(runners or {})
    for cand in candidates:
        if cand in runners:
            continue
        prog_c, ex_c = cand.apply(program, execution)
        walker = compile_walker(prog_c, backend=backend, execution=ex_c)

        def run(walker=walker):
            out = walker.run(graph, starts, seed=seed)
            if on_card:
                torch.cuda.synchronize(graph.device)
            return out

        runners[cand] = run
    return runners


def _anchors(candidates, default: Candidate) -> Tuple[Candidate, ...]:
    """Small fit set: the default plus one-knob-at-an-extreme variants.

    Varying one knob at a time to its grid extremes spreads the feature
    matrix enough for the least-squares fit without measuring the grid.
    """
    cand_set = {c.items for c in candidates}
    out = [default]
    base = default.to_dict()
    by_knob: Dict[str, list] = {}
    for c in candidates:
        d = c.to_dict()
        diff = [k for k, v in d.items() if base.get(k) != v]
        if len(diff) == 1:
            by_knob.setdefault(diff[0], []).append((d[diff[0]], c))
    for _name, vals in sorted(by_knob.items()):
        vals.sort(key=lambda t: (str(type(t[0])), t[0]))
        for pick in (vals[0][1], vals[-1][1]):
            if pick.items in cand_set and pick not in out:
                out.append(pick)
    return tuple(out)


def autotune(graph, program, execution=None, backend: str = "single", *,
             num_queries: int = 256, seed: int = 0, measurer=None,
             cache: Optional[TuningCache] = None, keep: int = 6,
             include_resampling: bool = False, min_gain: float = 0.02,
             coeffs: Optional[_model.CostCoeffs] = None,
             use_cache: bool = True) -> TuneResult:
    """Tune the knob grid for (graph, program, execution, backend).

    ``measurer=None`` ranks purely by the analytical model (the
    ``--no-measure`` mode); otherwise ``measurer`` is any
    `repro_torch.tune.measure.Measurer`, which times runs on the graph's
    device.  Returns a :class:`TuneResult` whose
    ``program``/``execution`` are the chosen concrete configs.
    """
    from repro_torch.walker.execution import ExecutionConfig
    execution = execution or ExecutionConfig()
    sig = graph_signature(graph)
    base_coeffs = coeffs or _model.DEFAULT_COEFFS
    key = _key(graph, sig, program, execution, backend, num_queries)
    cache = cache if cache is not None else TuningCache(default_cache_path())

    if use_cache:
        rec = cache.get(key)
        if rec is not None:
            known = _filter_to_known(rec["knobs"], program, execution,
                                     backend, include_resampling)
            cand = _complete(known, program, execution, backend)
            prog_c, ex_c = cand.apply(program, execution)
            return TuneResult(cand, prog_c, ex_c, key, sig, "cache", {}, {})

    default = _complete({}, program, execution, backend)
    if measurer is None:
        # Model-only: the adaptive-reservoir axis is decided by the skew
        # gate, not the byte model (the model cannot see the dynamic
        # loop-bound overhead, so it would always prefer adaptive).
        cands = enumerate_candidates(program, execution, backend,
                                     include_resampling=include_resampling,
                                     exclude=("adaptive_chunks",))
        preds = _model.predictions(program, execution, sig, num_queries,
                                   cands, base_coeffs)
        chosen = min(cands, key=lambda c: (preds[c], c != default))
        gate = {}
        if any(k.name == "adaptive_chunks"
               for k in knobs_for(program, execution, backend)):
            gate["adaptive_chunks"] = _model.adaptive_chunk_gate(
                sig, int(chosen.get("num_slots")),
                int(chosen.get("reservoir_chunk",
                               program.spec.reservoir_chunk)))
        chosen = _complete({**chosen.to_dict(), **gate}, program, execution,
                           backend)
        measured: Dict[Candidate, float] = {}
        fitted = None
        source = "model"
    else:
        cands = enumerate_candidates(program, execution, backend,
                                     include_resampling=include_resampling)
        anchors = _anchors(cands, default)
        runners = _build_runners(graph, program, execution, backend,
                                 anchors, num_queries, seed)
        anchor_cost = measurer(anchors, runners)
        rows, ys = [], []
        for c in anchors:
            prog_c, ex_c = c.apply(program, execution)
            rows.append(_model.features(prog_c, ex_c, sig, num_queries))
            ys.append(anchor_cost[c])
        fitted = _model.fit(rows, ys, base=base_coeffs)
        pruned = _model.prune(program, execution, sig, num_queries, cands,
                              keep=keep, coeffs=fitted,
                              always_keep=(default,))
        runners = _build_runners(graph, program, execution, backend, pruned,
                                 num_queries, seed, runners=runners)
        measured = dict(anchor_cost)
        measured.update(measurer(pruned, runners))
        best = min(measured, key=lambda c: (measured[c], c != default))
        # Hysteresis: deviate from the default only for a real win.
        if measured[best] > (1.0 - min_gain) * measured[default]:
            best = default
        chosen = best
        preds = _model.predictions(program, execution, sig, num_queries,
                                   [chosen, default], fitted)
        source = "measured"

    meta = {"source": source, "kind": program.spec.kind,
            "backend": backend, "step_impl": execution.step_impl,
            "num_queries": int(num_queries)}
    if measured:
        meta["measured_s"] = float(measured[chosen])
        meta["default_s"] = float(measured[default])
    cache.put(key, chosen.to_dict(), meta=meta)
    if use_cache:
        cache.save()
    prog_c, ex_c = chosen.apply(program, execution)
    return TuneResult(chosen, prog_c, ex_c, key, sig, source, measured,
                      dict(preds), fitted)


def resolve(program, execution, graph, backend: str = "single",
            num_queries: Optional[int] = None,
            cache: Optional[TuningCache] = None):
    """Resolve every ``"auto"`` sentinel to a concrete value.

    Cache hit -> the committed tuned value; miss -> analytical-model
    argmin (and the skew gate for ``adaptive_chunks``).  No wall-clock
    on any path, so binding a Walker stays deterministic; run
    ``python -m repro_torch.tune`` to fill the cache with measured
    entries.
    Returns the concrete ``(program, execution)`` pair.
    """
    if not needs_resolution(program, execution):
        return program, execution
    sig = graph_signature(graph)
    if cache is None:
        path = getattr(execution, "tune_cache", None) or default_cache_path()
        cache = TuningCache(path)
    key = _key(graph, sig, program, execution, backend, num_queries)
    rec = cache.get(key)
    cached = dict(rec["knobs"]) if rec else {}

    auto_names = tuple(execution.auto_knobs)
    chosen = {k: v for k, v in cached.items()
              if k in auto_names and k in EXEC_KNOBS}
    missing = [n for n in auto_names if n not in chosen]
    if missing:
        cands = enumerate_candidates(program, execution, backend,
                                     only=missing,
                                     exclude=("adaptive_chunks",))
        nq = num_queries or max(int(sig.num_vertices), 1)
        preds = _model.predictions(program, execution, sig, nq, cands)
        best = min(cands, key=lambda c: preds[c])
        chosen.update({k: v for k, v in best.to_dict().items()
                       if k in missing})
    ex2 = execution.resolved(**{k: v for k, v in chosen.items()
                                if k in EXEC_KNOBS})

    prog2 = program
    spec = program.spec
    if spec.kind == "reservoir_n2v" and spec.adaptive_chunks == "auto":
        if "adaptive_chunks" in cached:
            adaptive = bool(cached["adaptive_chunks"])
        else:
            adaptive = _model.adaptive_chunk_gate(sig, int(ex2.num_slots),
                                                  int(spec.reservoir_chunk))
        prog2 = dataclasses.replace(
            program, spec=dataclasses.replace(spec,
                                              adaptive_chunks=adaptive))
    return prog2, ex2
