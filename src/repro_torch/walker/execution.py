"""Execution configuration (the machine half of the walker API).

Everything here is a machine knob — lane count, scheduling mode,
injection latency, step implementation, shard count, routing capacities.
None of it changes which walks are sampled: paths depend only on
``(seed, query_id, hop)``, so one :class:`WalkProgram` runs bit-identically
under any ExecutionConfig and either backend.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.core.distributed import DistConfig
from repro_torch.core.walk_engine import (EngineConfig, MODES as _MODES,
                                          check_step_impl)

#: Sentinel accepted by the tunable knobs below: "resolve me from the
#: tuning cache / analytical model at graph-bind time" (repro_torch.tune).
AUTO = "auto"

#: Knobs that accept the AUTO sentinel.  All are path-preserving machine
#: knobs — resolution never changes which walks are sampled.
TUNABLE_KNOBS = ("num_slots", "hops_per_launch", "queue_depth_factor",
                 "cache_budget")


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Machine knobs for compiled walkers, on either backend.

    Single-device knobs map onto :class:`repro_torch.core.EngineConfig`;
    sharded knobs onto :class:`repro_torch.core.distributed.DistConfig`.

    ``num_slots``, ``queue_depth_factor``, ``hops_per_launch`` and
    ``cache_budget`` also accept the string ``"auto"``: the Walker
    resolves them per graph at bind time through the tuning cache /
    analytical model (`repro_torch.tune.resolve`) — see ``tune_cache``
    below.  A config with unresolved sentinels cannot be lowered
    (``engine_config`` raises); use :meth:`resolved` to pin values
    manually.

    Attributes:
      num_slots:        W — total walker lanes (divided across shards on
                        the sharded backend unless ``slots_per_device`` is
                        given).
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
      num_devices:      sharded backend only — shard count (default: the
                        number of visible cards, at least 1; a
                        `PartitionedGraph` brings its own).  The shards
                        are placed by the mesh given to ``compile``, else
                        by `walker.compile.default_mesh`.
      slots_per_device: sharded backend only — W_loc override (default
                        ``num_slots // num_devices``).
      capacity_margin:  × Theorem VI.1 margin on routing bucket capacity.
      retention_factor: × the global live-task bound N·W_loc sizing the
                        router retention region; >= 1.0 is provably
                        lossless under the flow-controlled refill.
      log_capacity:     per-shard emission-log entries (path write-back).
      axis_name:        name of the shard axis (the reference's mesh axis).
      tune_cache:       optional path of a tuning-cache JSON consulted
                        when resolving ``"auto"`` knobs (default: the
                        ``RIDGEWALKER_TUNE_CACHE`` environment variable,
                        else model-only resolution).
    """

    num_slots: "int | str" = 1024
    record_paths: bool = True
    mode: str = "zero_bubble"
    injection_delay: int = 0
    queue_depth_factor: "float | str" = 1.0
    max_supersteps: int = 1 << 20
    step_impl: str = "torch"
    hops_per_launch: "int | str" = 16
    cache_budget: "int | str" = 0
    # ---- sharded backend ----
    num_devices: Optional[int] = None
    slots_per_device: Optional[int] = None
    capacity_margin: float = 2.0
    retention_factor: float = 1.0
    log_capacity: int = 1 << 16
    axis_name: str = "ch"
    tune_cache: Optional[str] = None

    def __post_init__(self):
        for knob in TUNABLE_KNOBS:
            v = getattr(self, knob)
            if isinstance(v, str) and v != AUTO:
                raise ValueError(
                    f"{knob} must be a number or the sentinel "
                    f"{AUTO!r}, got {v!r}")
        if self.num_slots != AUTO and self.num_slots <= 0:
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
        if self.queue_depth_factor != AUTO and self.queue_depth_factor <= 0:
            raise ValueError(
                f"queue_depth_factor must be positive (it scales the "
                f"Theorem VI.1 depth), got {self.queue_depth_factor}")
        if self.max_supersteps <= 0:
            raise ValueError(f"max_supersteps must be positive, got "
                             f"{self.max_supersteps}")
        if self.hops_per_launch != AUTO and self.hops_per_launch <= 0:
            raise ValueError(f"hops_per_launch must be positive, got "
                             f"{self.hops_per_launch}")
        if self.cache_budget != AUTO and self.cache_budget < 0:
            raise ValueError(
                f"cache_budget is a byte budget and cannot be negative, got "
                f"{self.cache_budget}")
        if self.num_devices is not None and self.num_devices <= 0:
            raise ValueError(f"num_devices must be positive, got "
                             f"{self.num_devices}")
        if self.slots_per_device is not None and self.slots_per_device <= 0:
            raise ValueError(f"slots_per_device must be positive, got "
                             f"{self.slots_per_device}")
        if self.capacity_margin <= 0 or self.retention_factor <= 0:
            raise ValueError(
                f"capacity_margin / retention_factor must be positive, got "
                f"{self.capacity_margin} / {self.retention_factor}")
        if self.log_capacity <= 0:
            raise ValueError(f"log_capacity must be positive, got "
                             f"{self.log_capacity}")

    # ------------------------------------------------------ auto sentinels

    @property
    def auto_knobs(self) -> tuple:
        """Names of knobs currently carrying the ``"auto"`` sentinel."""
        return tuple(k for k in TUNABLE_KNOBS if getattr(self, k) == AUTO)

    @property
    def has_auto(self) -> bool:
        """True while any tunable knob is still an unresolved sentinel."""
        return bool(self.auto_knobs)

    def resolved(self, **knobs) -> "ExecutionConfig":
        """Concrete copy: ``knobs`` override, remaining sentinels take
        the class defaults.

        This is the manual escape hatch and the primitive the tuner's
        candidate application uses; ``Walker`` resolves through
        `repro_torch.tune.resolve` instead (cache / model aware).
        """
        bad = set(knobs) - set(TUNABLE_KNOBS)
        if bad:
            raise ValueError(
                f"resolved() only accepts the tunable knobs "
                f"{TUNABLE_KNOBS}, got {sorted(bad)}")
        vals = dict(knobs)
        for k in TUNABLE_KNOBS:
            if k not in vals and getattr(self, k) == AUTO:
                vals[k] = type(self).__dataclass_fields__[k].default
        return dataclasses.replace(self, **vals) if vals else self

    def _require_concrete(self, what: str) -> None:
        if self.has_auto:
            raise ValueError(
                f"cannot build a {what} while {self.auto_knobs} are "
                f"'auto' — bind through Walker (which resolves them per "
                f"graph via repro_torch.tune) or call .resolved(...) first")

    # ---------------------------------------------------------- conversions

    def engine_config(self, program) -> EngineConfig:
        """Single-device engine view of these knobs for ``program``."""
        self._require_concrete("single-device EngineConfig")
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

    def dist_config(self, program, num_devices: int) -> DistConfig:
        """Sharded engine view of these knobs for ``program``."""
        self._require_concrete("sharded DistConfig")
        if self.mode != "zero_bubble" or self.step_impl != "torch":
            warnings.warn(
                f"mode={self.mode!r} / step_impl={self.step_impl!r} do not "
                "apply to the sharded backend (it always runs the "
                "zero-bubble plain torch superstep) and are ignored",
                RuntimeWarning, stacklevel=3)
        w_loc = self.slots_per_device or max(self.num_slots // num_devices, 1)
        return DistConfig(
            slots_per_device=w_loc,
            max_hops=program.max_hops,
            capacity_margin=self.capacity_margin,
            retention_factor=self.retention_factor,
            log_capacity=self.log_capacity,
            record_paths=self.record_paths,
            max_supersteps=self.max_supersteps,
            axis_name=self.axis_name,
        )

    @classmethod
    def from_engine_config(cls, cfg: EngineConfig, **kw) -> "ExecutionConfig":
        """Lift a legacy :class:`EngineConfig` (minus the program-level
        ``max_hops``) into an ExecutionConfig — the shim path."""
        return cls(
            num_slots=cfg.num_slots,
            record_paths=cfg.record_paths,
            mode=cfg.mode,
            injection_delay=cfg.injection_delay,
            queue_depth_factor=cfg.queue_depth_factor,
            max_supersteps=cfg.max_supersteps,
            step_impl=cfg.step_impl,
            hops_per_launch=cfg.hops_per_launch,
            cache_budget=cfg.cache_budget,
            **kw,
        )
