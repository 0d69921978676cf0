"""RidgeWalker core: stateless task decomposition, sampler phase-program
IR, zero-bubble slot-pool engine, queuing-theoretic scheduler, sharded
routing."""
from repro_torch.core import corpus_ring, phase_program, scheduler
from repro_torch.core.corpus_ring import CorpusRing
from repro_torch.core.samplers import SamplerSpec, edge_exists
from repro_torch.core.tasks import (N2VSlots, QueryQueue, ReservoirSlots,
                                    WalkerSlots, WalkResult, WalkStats,
                                    empty_queue, empty_slots, make_queue,
                                    zero_stats)
from repro_torch.core.walk_engine import (EngineConfig, StreamState,
                                          build_engine, init_stream_state,
                                          inject_queries, make_engine,
                                          make_superstep_runner, run_walks)

__all__ = [
    "SamplerSpec", "edge_exists",
    "WalkerSlots", "N2VSlots", "ReservoirSlots", "QueryQueue", "WalkStats",
    "WalkResult",
    "empty_slots", "empty_queue", "make_queue", "zero_stats",
    "EngineConfig", "StreamState", "init_stream_state", "inject_queries",
    "build_engine", "make_engine", "make_superstep_runner", "run_walks",
    "phase_program", "scheduler",
    "corpus_ring", "CorpusRing",
]
