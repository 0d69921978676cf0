"""Zero-bubble scheduling theory (paper §VI).

Theorem VI.1 (bulk-service M/M/1[N] with delayed feedback): with N
servers of service rate μ tasks/cycle and availability feedback delayed by
at most C cycles, a dispatch queue of depth ``D = N + ceil(μ·C·N)`` keeps
every server busy whenever the system is backlogged.  Here the servers are
the W lanes of the slot pool (μ = 1 hop/superstep) and C is the injection
latency in supersteps; `min_queue_depth` sizes the engine's stage-ahead
watermark.

`analyze_run` turns WalkStats into the utilization metrics (bubble ratio,
starved ratio, occupancy, MSteps/s).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.tasks import WalkStats


def min_queue_depth(num_servers: int, mu: float = 1.0, delay: int = 0) -> int:
    """Theorem VI.1: D = N + O(μ·C·N). We use the explicit constant 1."""
    return int(num_servers + math.ceil(mu * delay * num_servers))


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
