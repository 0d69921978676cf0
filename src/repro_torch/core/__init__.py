"""RidgeWalker core: stateless task decomposition, sampler phase-program
IR, zero-bubble slot-pool engine, queuing-theoretic scheduler."""
from repro_torch.core import phase_program, scheduler
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.tasks import (QueryQueue, WalkerSlots, WalkResult,
                                    WalkStats, empty_queue, empty_slots,
                                    make_queue, zero_stats)
from repro_torch.core.walk_engine import (EngineConfig, StreamState,
                                          build_engine, init_stream_state,
                                          inject_queries,
                                          make_superstep_runner)

__all__ = [
    "SamplerSpec", "WalkerSlots", "QueryQueue", "WalkStats", "WalkResult",
    "empty_slots", "empty_queue", "make_queue", "zero_stats",
    "EngineConfig", "StreamState", "init_stream_state", "inject_queries",
    "build_engine", "make_superstep_runner",
    "phase_program", "scheduler",
]
