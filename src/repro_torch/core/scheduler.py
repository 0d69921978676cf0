"""Zero-bubble scheduling theory (paper §VI).

Theorem VI.1 (bulk-service M/M/1[N] with delayed feedback): with N
servers of service rate μ tasks/cycle and availability feedback delayed by
at most C cycles, a dispatch queue of depth ``D = N + ceil(μ·C·N)`` keeps
every server busy whenever the system is backlogged.  Here the servers are
the W lanes of the slot pool (μ = 1 hop/superstep) and C is the injection
latency in supersteps; `min_queue_depth` sizes the engine's stage-ahead
watermark.

`analyze_run` turns WalkStats into the utilization metrics (bubble ratio,
starved ratio, occupancy, MSteps/s); `analyze_service` folds a walk
service's per-request sojourns into the open-system metrics
(`ServiceAnalysis`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.tasks import WalkStats


def min_queue_depth(num_servers: int, mu: float = 1.0, delay: int = 0) -> int:
    """Theorem VI.1: D = N + O(μ·C·N). We use the explicit constant 1."""
    return int(num_servers + math.ceil(mu * delay * num_servers))


def butterfly_feedback_delay(num_pipelines: int) -> int:
    """Paper §VI-D: tasks traverse log N Dispatchers + log N Mergers, each
    ≤ 2 cycles, plus the scheduler↔pipeline round trip: C ≤ 4·log2 N."""
    n = max(2, num_pipelines)
    return int(4 * math.ceil(math.log2(n)))


def per_pipeline_fifo_depth(num_pipelines: int) -> int:
    """Paper §VI-D: D = N + 4·N·log N total → 1 + 4·log N per pipeline."""
    n = max(2, num_pipelines)
    return int(1 + 4 * math.ceil(math.log2(n)))


@dataclasses.dataclass
class RunAnalysis:
    steps: int
    supersteps: int
    slot_steps: int
    bubbles: int
    starved: int
    bubble_ratio: float
    starved_ratio: float
    occupancy: float
    terminations: int
    route_waits: int
    drops: int
    msteps_per_s: float = float("nan")
    launches: int = 0
    supersteps_per_launch: float = float("nan")

    @property
    def zero_bubble(self) -> bool:
        """True iff no lane ever starved while work existed (Thm VI.1)."""
        return self.starved == 0


def analyze_run(stats: WalkStats,
                wall_time_s: float | None = None) -> RunAnalysis:
    s = {k: int(v) for k, v in stats._asdict().items()}
    ratio = s["bubbles"] / max(s["slot_steps"], 1)
    sratio = s["starved"] / max(s["slot_steps"], 1)
    msteps = float("nan")
    if wall_time_s and wall_time_s > 0:
        msteps = s["steps"] / wall_time_s / 1e6
    return RunAnalysis(
        steps=s["steps"], supersteps=s["supersteps"],
        slot_steps=s["slot_steps"], bubbles=s["bubbles"], starved=s["starved"],
        bubble_ratio=ratio, starved_ratio=sratio, occupancy=1.0 - ratio,
        terminations=s["terminations"], route_waits=s["route_waits"],
        drops=s["drops"], msteps_per_s=msteps, launches=s["launches"],
        supersteps_per_launch=s["supersteps"] / max(s["launches"], 1),
    )


@dataclasses.dataclass
class ServiceAnalysis:
    """Open-system (streaming service) metrics: the queuing-theoretic view
    of Theorem VI.1 — requests arrive continuously at offered load λ and
    each observes a *sojourn time* (submit → last walk completed).

    ``offered_load`` is λ in walks/superstep; ``utilization`` is the
    fraction of lane service capacity demanded, ρ = λ·E[L] / W (ρ ≥ 1 means
    the system is overloaded and sojourn grows with the backlog).

    ``*_admission_wait`` isolates the *host-side* queueing component of the
    sojourn: supersteps from submit to injection into the device slot ring.
    Under the ring-buffer economy a request waits only while fewer free
    slots exist than it needs, so admission wait is the backlog signal and
    ``sojourn - admission_wait`` is pure device time."""

    offered_load: float
    utilization: float
    requests: int
    walks: int
    supersteps: int
    throughput: float        # hops per superstep (lane-work actually done)
    p50_sojourn: float       # supersteps, per-request
    p99_sojourn: float
    mean_sojourn: float
    bubble_ratio: float
    starved_ratio: float
    msteps_per_s: float = float("nan")
    p50_admission_wait: float = float("nan")  # supersteps, submit -> inject
    p99_admission_wait: float = float("nan")
    mean_admission_wait: float = float("nan")
    # Online chunk-adaptation trace (serve.scheduler.AdaptationEvent
    # tuples) when the service runs with an adaptive supersteps-per-
    # launch controller; empty for fixed-chunk services.
    adaptation: tuple = ()


def sojourn_percentiles(sojourns, qs=(50.0, 99.0)):
    """Percentiles of per-request sojourn times (supersteps); NaN for an
    empty list."""
    s = np.asarray(list(sojourns), float)
    if s.size == 0:
        return tuple(float("nan") for _ in qs)
    return tuple(float(np.percentile(s, q)) for q in qs)


def analyze_service(sojourns, stats: WalkStats, num_slots: int,
                    offered_load: float = float("nan"),
                    mean_walk_len: float = float("nan"),
                    wall_time_s: float | None = None,
                    admission_waits=None,
                    adaptation=()) -> ServiceAnalysis:
    """Fold per-request sojourns (+ optional admission waits) and engine
    WalkStats (int64 counters, tensors or host ints) into service metrics.
    ``adaptation`` is the service's online chunk-adaptation trace, passed
    through verbatim."""
    base = analyze_run(stats, wall_time_s)
    s = np.asarray(list(sojourns), float)
    p50, p99 = sojourn_percentiles(s)
    mean = float(s.mean()) if s.size else float("nan")
    util = offered_load * mean_walk_len / max(num_slots, 1)
    aw50 = aw99 = aw_mean = float("nan")
    if admission_waits is not None:
        aw = np.asarray(list(admission_waits), float)
        aw50, aw99 = sojourn_percentiles(aw)
        aw_mean = float(aw.mean()) if aw.size else float("nan")
    return ServiceAnalysis(
        offered_load=offered_load,
        utilization=util,
        requests=int(s.size),
        walks=base.terminations,
        supersteps=base.supersteps,
        throughput=base.steps / max(base.supersteps, 1),
        p50_sojourn=p50,
        p99_sojourn=p99,
        mean_sojourn=mean,
        bubble_ratio=base.bubble_ratio,
        starved_ratio=base.starved_ratio,
        msteps_per_s=base.msteps_per_s,
        p50_admission_wait=aw50,
        p99_admission_wait=aw99,
        mean_admission_wait=aw_mean,
        adaptation=tuple(adaptation),
    )


def peak_random_access_bandwidth(f_mem_hz: float, t_rrd_cycles: float,
                                 num_channels: int, bits: int = 64) -> float:
    """Paper Eq. (1): B_peak = f_mem / t_RRD × N_chn × bits/8  [bytes/s],
    with t_RRD the row-to-row delay in memory-clock cycles (each walk step
    is assumed to be a DRAM row-buffer miss).  The paper's FPGA analysis;
    the port's bounds use the card's published memory rate instead."""
    return f_mem_hz / t_rrd_cycles * num_channels * (bits / 8)
