"""compile(program, backend=...) — the walker entry point.

:func:`compile` binds a :class:`~repro_torch.walker.WalkProgram` to a
backend and returns a :class:`Walker`:

    walker = compile(WalkProgram.deepwalk(), execution=ExecutionConfig(
        num_slots=4096, step_impl="cuda"))
    result = walker.run(graph, starts, seed=0)        # closed batch

The walk runs where the graph lives: on the card, ``step_impl="cuda"``
and ``"fused"`` launch their kernels; on the CPU they run the kernels'
plain versions.  Paths are a pure function of (seed, query_id, hop), so
they are bit-identical to the reference package for the same graph,
starts and seed, under every step implementation; the stats differ only
in ``launches`` (one per superstep, or one per fused launch).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import rng as task_rng
from repro_torch.core.tasks import WalkResult
from repro_torch.core.walk_engine import (Drain, build_engine,
                                          maybe_build_cache)
from repro_torch.walker.execution import ExecutionConfig
from repro_torch.walker.program import WalkProgram

BACKENDS = ("single", "sharded")


def compile(program: WalkProgram, backend: str = "single",
            execution: Optional[ExecutionConfig] = None) -> "Walker":
    """Bind ``program`` to an execution backend.

    backend:
      ``single``  — one device: slot-pool engine with zero-bubble refill.
      ``sharded`` — not ported yet (raises NotImplementedError).
    """
    if not isinstance(program, WalkProgram):
        raise TypeError(
            f"compile expects a WalkProgram, got {type(program).__name__}; "
            "build one with WalkProgram.urw()/ppr()/deepwalk() or "
            "WalkProgram(spec=...)")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "sharded":
        raise NotImplementedError(
            "backend='sharded' is not ported yet: ROADMAP.md queue 1 item 9")
    return Walker(program, backend, execution or ExecutionConfig())


class Walker:
    """A compiled walk program on the single backend."""

    def __init__(self, program: WalkProgram, backend: str,
                 execution: ExecutionConfig):
        self.program = program
        self.backend = backend
        self.execution = execution
        # (spec, engine config, id(graph) when a cache is wanted) ->
        # (engine, graph); see _single_engine.
        self._engines = {}
        #: Host timing of the last :meth:`run` (wall and per-superstep sync).
        self.last_drain: Optional[Drain] = None

    def run(self, graph, starts, seed=0) -> WalkResult:
        """Closed system: drain the batch of ``starts`` to completion on
        the graph's device (per superstep, or in fused launches of
        ``hops_per_launch`` supersteps).

        ``seed`` may be an int or a key pair (two 32-bit words, e.g.
        ``rng.stream_key(s, e)``)."""
        self.program.requires(graph)
        engine = self._single_engine(graph)
        if isinstance(starts, torch.Tensor):
            sv = starts.to(device=graph.device, dtype=torch.int32)
        else:
            sv = torch.as_tensor(np.asarray(starts, dtype=np.int32),
                                 device=graph.device)
        result, self.last_drain = engine(graph, sv, task_rng.stream_key(seed))
        return result

    def _single_engine(self, graph):
        """The engine for ``graph``, built once.  The hot-vertex cache is a
        function of the graph, so graph identity keys the memo whenever a
        cache would be built; the memo holds the graph, keeping its id()
        stable for the entry's lifetime."""
        spec = self.program.spec
        cfg = self.execution.engine_config(self.program)
        wants_cache = cfg.step_impl == "fused" and cfg.cache_budget > 0
        key = (spec, cfg, id(graph) if wants_cache else None)
        if key not in self._engines:
            cache = maybe_build_cache(spec, cfg, graph)
            self._engines[key] = (build_engine(spec, cfg, cache=cache), graph)
        return self._engines[key][0]

    def stream(self, graph, capacity: int = 4096, seed=0):
        """Open system — not ported yet."""
        raise NotImplementedError(
            "Walker.stream (the open system) is not ported yet: ROADMAP.md "
            "queue 1 item 3")

    def serve(self, graph, capacity: int = 4096, chunk: int = 16, seed=0):
        """Multi-tenant service — not ported yet."""
        raise NotImplementedError(
            "Walker.serve is not ported yet: ROADMAP.md queue 1 item 6")

    def train_embeddings(self, graph, **kwargs):
        """Walks → embeddings pipeline — not ported yet."""
        raise NotImplementedError(
            "Walker.train_embeddings is not ported yet: ROADMAP.md queue 1 "
            "item 7")
