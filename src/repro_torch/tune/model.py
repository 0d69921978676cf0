"""Analytical cost model for walk-engine runs.

A closed-batch drain is priced as

    cost = S·a  +  S·W·b  +  S·W·B·c  +  launches·d

where ``S`` is the superstep count the drain needs, ``W`` the lane-pool
width, ``B`` the per-lane **bytes read from device memory per hop** —
counted off the loads of the fused CUDA kernel
(`kernels/fused_superstep/csrc/fused_superstep.cu`) — and ``launches``
the host rounds of the drain:
``ceil(S / hops_per_launch)`` under the fused superstep, ``S`` under the
per-hop impls (``torch``, ``cuda``), whose drain is a host loop of one
round a superstep (`core/walk_engine.py::make_superstep_runner`).  The
four coefficients ``(a, b, c, d)`` form a :class:`CostCoeffs`; they can
be *fit* from measured samples per sampler kind (:func:`fit`) and are
used to rank and prune the candidate grid before any timing
(:func:`prune`).

The model also owns the **degree-adaptive reservoir gate**: the live
max degree of a W-lane pool on a skewed graph concentrates around the
degree-weighted quantile at ``q = 0.5**(1/W)`` (each of W roughly
independent lanes sits below d with probability F_w(d)), so the
expected chunk-loop trip count of the adaptive scan is predictable from
the graph signature alone — no timing needed to decide the
``adaptive_chunks="auto"`` sentinel.

No clock here: everything is arithmetic over the
:class:`~repro_torch.tune.cache.GraphSignature` and the kernel's loads
(`repro_torch.tune.measure` is the only module allowed to time
anything).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.samplers import bisect_iters, es_num_chunks
from repro_torch.tune.cache import PLAIN_QS, WEIGHTED_QS, GraphSignature
from repro_torch.tune.space import Candidate

#: The largest hot-vertex block the fused kernel keeps in shared memory on
#: an H100 (224 KiB of the 227 KiB opt-in limit a block; the kernel's own
#: staging takes the rest: `kernels/fused_superstep/ops.py::cache_tier`).
#: A larger block is read in place from device memory, so a hit there
#: reads as many device bytes as a miss.
SHARED_BLOCK_BYTES = 229_376


@dataclasses.dataclass(frozen=True)
class CostCoeffs:
    """Fitted roofline coefficients, all in microseconds per unit."""

    superstep_us: float = 30.0   # fixed dispatch/bookkeeping per superstep
    lane_us: float = 0.02        # per lane-hop of compute
    byte_us: float = 0.002       # per lane-byte gathered
    launch_us: float = 150.0     # per host->device kernel dispatch

    def as_array(self) -> np.ndarray:
        """(4,) coefficient vector matching :func:`features` columns."""
        return np.array([self.superstep_us, self.lane_us, self.byte_us,
                         self.launch_us], dtype=np.float64)


#: The model's coefficients when nothing was fitted: the card's, fitted by
#: ``chip_smoke.py`` phase 7 (``tune_card_coeffs``: least squares over 14
#: fused URW runs on the WG stand-in at scale 20, 65,536 queries — the
#: measured autotune's candidates and the hops_per_launch sweep) on an
#: ``NVIDIA H100 80GB HBM3, 700.00 W`` (nvidia-smi name, power limit); the
#: run is in PERF.md section 6.  The fit clips the lane and byte terms to
#: 0: there, a run costs its supersteps and its launches.  The field
#: defaults above are the reference package's values.
DEFAULT_COEFFS = CostCoeffs(superstep_us=3.61023, lane_us=0.0, byte_us=0.0,
                            launch_us=32.0495)


def expected_walk_len(program) -> float:
    """E[L] under the program's stop rule (geometric, capped)."""
    stop = float(getattr(program.spec, "stop_prob", 0.0))
    max_hops = float(program.max_hops)
    if stop <= 0.0:
        return max_hops
    return min(max_hops, 1.0 / stop)


@functools.lru_cache(maxsize=256)
def _kernel_bytes(kind: str, rounds: int, bisect: int, trips: int,
                  chunk: int, record_paths: bool,
                  cached: bool = False) -> float:
    """Per-lane bytes of one hop that the fused kernel reads from (or
    writes to) device memory, by sampler kind, counted off its loads
    (``fused_superstep.cu``, in 4-byte words):

      * row access, ``process_lane`` (:402): the row-pointer pair of
        v_curr, 8; uniform / PPR then read the column, 4 (12);
      * alias: prob and alias at the drawn offset, then the column (20);
      * metapath: the schedule entry, the typed pair ``type_offsets[v,
        t:t+2]`` and the column (24);
      * rejection Node2Vec, ``process_lane_rejection`` (:626): the pairs
        of v_curr and v_prev, 16, then per round a proposed column, 4,
        and its membership test in N(v_prev), ``bisect`` (:538): one
        probe a halving and the final read, 4·(bisect + 1) — as the
        bias ``n2v_bias`` (:572) needs; all ``rounds`` rounds are priced
        (the kernel stops at the first accept, which only the data
        decides);
      * reservoir Node2Vec: the two pairs, 16, then per chunk trip
        ``reservoir_chunk`` (:800) candidates, each a column and a
        weight, 8, and its membership test, 4·(bisect + 1); then the
        chosen column, 4;
      * with ``record_paths``, ``finish_lane`` (:371) writes the path
        record and the length, 8.

    ``cached=True`` prices a lane whose row is in a hot-vertex block in
    shared memory: the reads keyed on v_curr (its row pointers, columns,
    alias tables, typed offsets, weights) come from the block, and what
    the cached lane pass still reads from device memory stays — the
    schedule entry, the v_prev pair and the bisection probes of
    N(v_prev), and the path write.  (For a block in device memory the
    uncached count holds: :data:`SHARED_BLOCK_BYTES`.)  Arithmetic only:
    the counts agree with the bound ``chip_smoke.py`` computes for a
    launch (``fused_bound``, ``n2v_work``).
    """
    member = 4.0 * (bisect + 1)             # a bisection of N(v_prev)
    if kind == "uniform":
        total = 0.0 if cached else 12.0
    elif kind == "alias":
        total = 0.0 if cached else 20.0
    elif kind == "metapath":
        total = 4.0 if cached else 24.0
    elif kind == "rejection_n2v":
        per_round = member if cached else 4.0 + member
        total = (8.0 if cached else 16.0) + rounds * per_round
    elif kind == "reservoir_n2v":
        per_cand = member if cached else 8.0 + member
        total = ((8.0 if cached else 20.0)
                 + trips * chunk * per_cand)
    else:
        raise ValueError(f"unknown sampler kind {kind!r}")
    return total + (8.0 if record_paths else 0.0)


def bytes_per_hop(spec, sig: GraphSignature,
                  chunk_trips: Optional[int] = None,
                  record_paths: bool = False,
                  cached: bool = False) -> float:
    """Per-lane bytes moved per hop for ``spec`` on a ``sig`` graph
    (:func:`_kernel_bytes`).

    ``chunk_trips`` overrides the reservoir chunk-loop trip count (the
    adaptive scan runs fewer trips than the static
    ``es_num_chunks(max_degree, CH)`` bound).  ``cached=True`` prices a
    hop whose row is in a shared-memory hot-vertex block (residual
    device-memory traffic only); blend the two with
    :func:`predicted_hit_rate` for the effective per-hop bytes.
    """
    trips = 1
    if spec.kind == "reservoir_n2v":
        trips = (int(chunk_trips) if chunk_trips is not None
                 else es_num_chunks(sig.max_degree, spec.reservoir_chunk))
    return _kernel_bytes(spec.kind, int(spec.rejection_rounds),
                         bisect_iters(sig.max_degree), max(1, trips),
                         int(spec.reservoir_chunk), bool(record_paths),
                         bool(cached))


@functools.lru_cache(maxsize=64)
def _spec_payloads(spec) -> Tuple[str, ...]:
    from repro_torch.core.phase_program import lower
    return lower(spec).cache_payloads


def predicted_hit_rate(sig: GraphSignature, budget_bytes: int,
                       payloads: Sequence[str]) -> float:
    """Modeled hit rate of a hot-vertex cache sized to ``budget_bytes``.

    The builder admits vertices in descending-degree order, and a
    walking lane occupies a vertex with probability proportional to its
    degree (stationary distribution), so the hit rate of a cache that
    covers every vertex of degree > d is the *edge-mass* fraction above
    d — read off the signature's degree-weighted quantile ladder, while
    the plain ladder prices the directory overhead (vertex count above
    d).  We scan the candidate thresholds both ladders store and keep
    the largest mass fraction whose modeled footprint fits the budget.
    Arithmetic over the signature only — no adjacency access, no clock.
    """
    budget = int(budget_bytes)
    if budget <= 0:
        return 0.0
    from repro_torch.graph.hot_cache import (edge_payload_bytes,
                                             vertex_overhead_bytes)
    payloads = tuple(payloads)
    per_edge = max(edge_payload_bytes(payloads), 4)
    # The signature does not store the edge-type count; 2 is the floor
    # for a typed graph and only perturbs the per-vertex directory term.
    per_vert = vertex_overhead_bytes(
        payloads, 2 if "type_offsets" in payloads else 0)
    # Anchor both ladders at degree 0 (zero mass / zero vertices below).
    dq = np.concatenate(([0.0], np.asarray(sig.deg_q, np.float64)))
    pq = np.concatenate(([0.0], np.asarray(PLAIN_QS, np.float64)))
    dwq = np.concatenate(([0.0], np.asarray(sig.deg_wq, np.float64)))
    wq = np.concatenate(([0.0], np.asarray(WEIGHTED_QS, np.float64)))
    thresholds = np.unique(np.concatenate((dq, dwq)))
    best = 0.0
    for d in thresholds:
        vert_frac = 1.0 - float(np.interp(d, dq, pq))
        mass_frac = 1.0 - float(np.interp(d, dwq, wq))
        need = (vert_frac * sig.num_vertices * per_vert
                + mass_frac * sig.num_edges * per_edge)
        if need <= budget:
            best = max(best, mass_frac)
    return float(min(max(best, 0.0), 1.0))


# ------------------------------------------------------------------ gate


def live_max_degree(sig: GraphSignature, num_slots: int) -> int:
    """Predicted max degree among ``num_slots`` live lanes.

    A walking lane occupies a vertex with probability proportional to
    its degree (stationary distribution of an undirected random walk),
    so the max over W lanes concentrates at the degree-weighted quantile
    ``q = 0.5**(1/W)`` — interpolated over the signature's stored
    weighted-quantile ladder.
    """
    w = max(int(num_slots), 1)
    q = 0.5 ** (1.0 / w)
    qs = np.asarray(WEIGHTED_QS)
    vals = np.asarray(sig.deg_wq, dtype=np.float64)
    return int(round(float(np.interp(q, qs, vals))))


def adaptive_chunk_gate(sig: GraphSignature, num_slots: int, chunk: int,
                        margin: float = 0.75) -> bool:
    """Should the degree-adaptive reservoir scan be on for this graph?

    The adaptive scan bounds the E-S chunk loop by the live lanes' max
    degree instead of the graph's ``max_degree``; its win is the trip
    ratio, its cost a dynamic loop bound.  Gate it on only when the
    predicted trips fall below ``margin`` of the static bound — on
    balanced graphs the ratio is ~1 and the gate keeps the fixed scan,
    so the adaptive path can no longer lose to it.
    """
    ch = max(int(chunk), 1)
    t_live = -(-live_max_degree(sig, num_slots) // ch)
    t_fixed = es_num_chunks(sig.max_degree, ch)
    return max(1, t_live) <= margin * t_fixed


# ----------------------------------------------------------- prediction


def _reservoir_trips(spec, sig: GraphSignature, num_slots: int,
                     adaptive) -> Optional[int]:
    if spec.kind != "reservoir_n2v":
        return None
    if adaptive:
        live = live_max_degree(sig, num_slots)
        return max(1, -(-live // max(int(spec.reservoir_chunk), 1)))
    return es_num_chunks(sig.max_degree, spec.reservoir_chunk)


def features(program, execution, sig: GraphSignature,
             num_queries: int) -> np.ndarray:
    """(4,) feature vector [S, S·W, S·W·B, launches] of a closed run."""
    ex = execution.resolved()
    spec = program.spec
    w = int(ex.num_slots)
    length = expected_walk_len(program)
    q = max(int(num_queries), 1)
    supersteps = max(length, math.ceil(q * length / max(w, 1)))
    adaptive = spec.adaptive_chunks
    if adaptive == "auto":
        adaptive = adaptive_chunk_gate(sig, w, spec.reservoir_chunk)
    trips = _reservoir_trips(spec, sig, w, adaptive)
    b = bytes_per_hop(spec, sig, chunk_trips=trips,
                      record_paths=ex.record_paths)
    cb = ex.cache_budget
    if ex.step_impl == "fused" and cb > 0:
        # Gather hierarchy: a hit hop in a shared-memory block moves only
        # the residual device bytes, so the effective per-hop traffic is
        # the hit-rate blend of the two counts; a block read from device
        # memory saves no device bytes.
        h = predicted_hit_rate(sig, cb, _spec_payloads(spec))
        b_hit = (bytes_per_hop(spec, sig, chunk_trips=trips,
                               record_paths=ex.record_paths, cached=True)
                 if cb <= SHARED_BLOCK_BYTES else b)
        b = (1.0 - h) * b + h * b_hit
    if ex.step_impl == "fused":
        launches = math.ceil(supersteps / max(int(ex.hops_per_launch), 1))
    else:
        launches = supersteps   # per-hop drain: one host round a superstep
    return np.array([supersteps, supersteps * w, supersteps * w * b,
                     launches], dtype=np.float64)


def predict_us(program, execution, sig: GraphSignature, num_queries: int,
               coeffs: CostCoeffs = DEFAULT_COEFFS) -> float:
    """Modeled wall-time (microseconds) of one closed-batch run."""
    return float(features(program, execution, sig, num_queries)
                 @ coeffs.as_array())


def fit(feature_rows: Sequence[np.ndarray],
        measured_us: Sequence[float],
        base: CostCoeffs = DEFAULT_COEFFS) -> CostCoeffs:
    """Fit :class:`CostCoeffs` from measured samples (least squares,
    clipped non-negative).  With fewer samples than coefficients the
    system is underdetermined — fall back to uniformly rescaling
    ``base`` so total predicted time matches total measured time (the
    ranking the pruner needs survives a global rescale)."""
    X = np.asarray(list(feature_rows), dtype=np.float64)
    y = np.asarray(list(measured_us), dtype=np.float64)
    if X.ndim != 2 or X.shape[0] == 0 or X.shape[0] != y.shape[0]:
        raise ValueError(
            f"fit needs matching non-empty samples, got X{X.shape} "
            f"y{y.shape}")
    if X.shape[0] >= X.shape[1]:
        sol, *_ = np.linalg.lstsq(X, y, rcond=None)
        sol = np.clip(sol, 0.0, None)
        if sol.any():
            return CostCoeffs(*sol.tolist())
    pred = X @ base.as_array()
    scale = float(y.sum() / pred.sum()) if pred.sum() > 0 else 1.0
    c = base.as_array() * max(scale, 1e-9)
    return CostCoeffs(*c.tolist())


def prune(program, execution, sig: GraphSignature, num_queries: int,
          candidates: Sequence[Candidate], keep: int = 6,
          coeffs: CostCoeffs = DEFAULT_COEFFS,
          always_keep: Sequence[Candidate] = ()) -> Tuple[Candidate, ...]:
    """Model-ranked top-``keep`` candidates (plus ``always_keep``).

    Ranking is by :func:`predict_us` of the candidate applied to
    ``(program, execution)``; ties break toward the earlier candidate so
    pruning is deterministic.  ``always_keep`` (typically the default
    candidate) survives regardless of rank — the guarantee that tuning
    can never select something worse than what it was allowed to keep.
    """
    scored = []
    for i, cand in enumerate(candidates):
        prog_c, ex_c = cand.apply(program, execution)
        scored.append((predict_us(prog_c, ex_c, sig, num_queries, coeffs),
                       i, cand))
    scored.sort(key=lambda t: (t[0], t[1]))
    kept = [c for _, _, c in scored[:max(int(keep), 1)]]
    for cand in always_keep:
        if cand not in kept:
            kept.append(cand)
    return tuple(kept)


def predictions(program, execution, sig: GraphSignature, num_queries: int,
                candidates: Sequence[Candidate],
                coeffs: CostCoeffs = DEFAULT_COEFFS) -> Dict[Candidate, float]:
    """Modeled cost of every candidate (the ``--no-measure`` ranking)."""
    out = {}
    for cand in candidates:
        prog_c, ex_c = cand.apply(program, execution)
        out[cand] = predict_us(prog_c, ex_c, sig, num_queries, coeffs)
    return out
