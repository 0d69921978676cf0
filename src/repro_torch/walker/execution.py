"""Execution configuration (the machine half of the walker API).

Everything here is a machine knob — lane count, scheduling mode,
injection latency, step implementation.  None of it changes which walks
are sampled: paths depend only on ``(seed, query_id, hop)``, so one
:class:`WalkProgram` runs bit-identically under any ExecutionConfig.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.walk_engine import (EngineConfig, MODES as _MODES,
                                          check_step_impl)

#: The tuning sentinel of the reference; resolving it is not ported yet.
AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Machine knobs for compiled walkers on the single backend.

    Attributes:
      num_slots:        W — walker lanes.
      record_paths:     keep per-query path buffers.
      mode:             ``zero_bubble`` (per-superstep compaction+refill)
                        or ``static`` (bulk-synchronous batches).
      injection_delay:  C — host→device staging latency in supersteps.
      queue_depth_factor: × the Theorem VI.1 stage-ahead depth D.
      max_supersteps:   safety bound for the drain loop.
      step_impl:        ``torch`` (plain tensor superstep), ``cuda`` (the
                        hand-written one-hop walk-step kernel; kinds it
                        does not cover run the plain superstep) or
                        ``fused`` (the hand-written kernel that runs
                        ``hops_per_launch`` whole supersteps per launch;
                        every sampler kind).
      hops_per_launch:  ``fused`` only — supersteps per kernel launch
                        (``stats.launches`` counts the launches).
      cache_budget:     ``fused`` only — byte budget of the hot-vertex
                        adjacency cache (0 disables it).  The kernel keeps
                        a block that fits in a thread block's shared
                        memory there, and reads a larger one from device
                        memory; either way only the three cache counters
                        of the stats change.
    """

    num_slots: int = 1024
    record_paths: bool = True
    mode: str = "zero_bubble"
    injection_delay: int = 0
    queue_depth_factor: float = 1.0
    max_supersteps: int = 1 << 20
    step_impl: str = "torch"
    hops_per_launch: int = 16
    cache_budget: int = 0

    def __post_init__(self):
        for knob in ("num_slots", "queue_depth_factor", "hops_per_launch",
                     "cache_budget"):
            if getattr(self, knob) == AUTO:
                raise NotImplementedError(
                    f"{knob}='auto' needs the tuner, which is not ported yet: "
                    "ROADMAP.md queue 1 item 8")
        if self.num_slots <= 0:
            raise ValueError(
                f"num_slots must be a positive lane count, got "
                f"{self.num_slots}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got "
                             f"{self.mode!r}")
        check_step_impl(self.step_impl)
        if self.injection_delay < 0:
            raise ValueError(
                f"injection_delay is a latency in supersteps and cannot be "
                f"negative, got {self.injection_delay}")
        if self.queue_depth_factor <= 0:
            raise ValueError(
                f"queue_depth_factor must be positive (it scales the "
                f"Theorem VI.1 depth), got {self.queue_depth_factor}")
        if self.max_supersteps <= 0:
            raise ValueError(f"max_supersteps must be positive, got "
                             f"{self.max_supersteps}")
        if self.hops_per_launch <= 0:
            raise ValueError(f"hops_per_launch must be positive, got "
                             f"{self.hops_per_launch}")
        if self.cache_budget < 0:
            raise ValueError(
                f"cache_budget is a byte budget and cannot be negative, got "
                f"{self.cache_budget}")

    def engine_config(self, program) -> EngineConfig:
        """Single-device engine view of these knobs for ``program``."""
        return EngineConfig(
            num_slots=self.num_slots,
            max_hops=program.max_hops,
            record_paths=self.record_paths,
            mode=self.mode,
            injection_delay=self.injection_delay,
            queue_depth_factor=self.queue_depth_factor,
            max_supersteps=self.max_supersteps,
            step_impl=self.step_impl,
            hops_per_launch=self.hops_per_launch,
            cache_budget=self.cache_budget,
        )
