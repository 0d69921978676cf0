"""compile(program, backend=...) — the walker entry point.

:func:`compile` binds a :class:`~repro_torch.walker.WalkProgram` to a
backend and returns a :class:`Walker`:

    walker = compile(WalkProgram.deepwalk(), execution=ExecutionConfig(
        num_slots=4096, step_impl="cuda"))
    result = walker.run(graph, starts, seed=0)        # closed batch
    out = walker.train_embeddings(graph, dim=128)     # walks → embeddings

The walk runs where the graph lives: on the card, ``step_impl="cuda"``
and ``"fused"`` launch their kernels; on the CPU they run the kernels'
plain versions.  Paths are a pure function of (seed, query_id, hop), so
they are bit-identical to the reference package for the same graph,
starts and seed, under every step implementation; the stats differ only
in ``launches`` (one per superstep, or one per fused launch).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import corpus_ring
from repro_torch.core import rng as task_rng
from repro_torch.core.tasks import WalkResult
from repro_torch.core.walk_engine import (Drain, build_engine,
                                          maybe_build_cache)
from repro_torch.models import embeddings as emb
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop
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

    def _single_engine(self, graph, cfg=None):
        """The engine for ``graph`` (under ``cfg``, default the execution's
        engine config), built once.  The hot-vertex cache is a function of
        the graph, so graph identity keys the memo whenever a cache would
        be built; the memo holds the graph, keeping its id() stable for the
        entry's lifetime."""
        spec = self.program.spec
        cfg = cfg or self.execution.engine_config(self.program)
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

    # ------------------------------------------------- walks → embeddings

    def train_embeddings(self, graph, *, seed: int = 0,
                         rounds: int = 4, walks_per_round: int = 64,
                         steps_per_round: int = 32, batch_size: int = 256,
                         dim: int = 32, window: int = 5,
                         num_negatives: int = 5,
                         ring_capacity: Optional[int] = None,
                         opt_cfg=None, overlap: bool = True,
                         use_kernel: bool = True,
                         ckpt_dir: Optional[str] = None,
                         ckpt_every: int = 0, log_every: int = 0,
                         batch_hook=None) -> dict:
        """Device-resident walks → embeddings pipeline (DeepWalk/node2vec),
        on the graph's device.

        Runs ``rounds`` walk-production rounds of ``walks_per_round`` walks
        each; completed paths land directly in a corpus ring on the device
        (`repro_torch.core.corpus_ring`) and ``steps_per_round`` SGNS grad
        steps a round consume (center, context, negatives) windows sampled
        straight from the ring — the paths never visit the host.  The
        steps' row gathers run on the embedding-bag kernel and their
        gradients on the segment-sum kernel (their plain versions on a CPU
        graph).  ``use_kernel`` is kept for the reference's signature and
        must be True: the port has no other gather, since plain indexing's
        backward on the card adds with atomics in no fixed order.

        ``overlap=True`` issues round ``r+1``'s walks before round ``r``'s
        grad steps, the reference's order; here that order runs nothing
        concurrently, since the engine's drain reads its progress on the
        host after every launch, so round ``r+1``'s walks are done before
        round ``r``'s first step is issued.  ``overlap=False`` is the
        serial baseline (a host round-trip of every round's paths and
        every batch, and a wait after every step), bit-identical in
        result.

        Round ``r``'s corpus is the closed batch of starts ``(r ·
        walks_per_round + i) % |V|`` under ``rng.stream_key(seed, r)``, a
        pure function of ``(seed, r)``, so a run checkpointed via
        ``ckpt_dir`` resumes bit-identically (rounds still to come are
        produced again, rounds in the ring are not).  The ring and every
        batch are bit-equal to the reference's for the same seed; the
        tables start from :func:`repro_torch.models.embeddings.init_params`
        (a ``torch.Generator`` seeded with ``seed``, which cannot give the
        reference's numbers).

        Returns ``{"params", "opt_state", "ring", "step", "history",
        "config"}`` — ``params`` are the trained embedding tables.
        """
        if walks_per_round <= 0 or rounds <= 0:
            raise ValueError(
                f"rounds ({rounds}) and walks_per_round ({walks_per_round}) "
                "must be positive")
        if not use_kernel:
            raise ValueError(
                "use_kernel=False is not supported: the gathers always run "
                "on the embedding-bag and segment-sum kernels (ROADMAP.md "
                "queue 3)")
        self.program.requires(graph)
        nv = int(graph.num_vertices)
        device = graph.device
        path_width = self.program.max_hops + 1

        # ------------------------------------------------------- producer
        engine = self._single_engine(graph, dataclasses.replace(
            self.execution.engine_config(self.program), record_paths=True))

        def produce(r: int):
            sv = torch.as_tensor(
                ((r * walks_per_round + np.arange(walks_per_round)) % nv)
                .astype(np.int32), device=device)
            res, _ = engine(graph, sv, task_rng.stream_key(seed, r))
            return res.paths, res.lengths

        # ------------------------------------------------------- consumer
        sg_cfg = emb.SkipGramConfig(num_vertices=nv, dim=dim,
                                    num_negatives=num_negatives,
                                    window=window)
        opt_cfg = opt_cfg or adamw.AdamWConfig(
            lr=1e-2, warmup_steps=max(1, rounds * steps_per_round // 10),
            total_steps=rounds * steps_per_round)
        params0 = emb.init_params(torch.Generator().manual_seed(seed), sg_cfg,
                                  device=device)
        state0 = (params0, adamw.init_state(params0))
        sampler = corpus_ring.make_batch_sampler(nv, batch_size, window,
                                                 num_negatives)
        base_key = task_rng.stream_key(seed)

        def sample(ring, step):
            return sampler(ring, base_key, step)

        sgns = emb.make_sgns_step(sg_cfg, opt_cfg)

        def step_fn(state, batch):
            params, opt = state
            if not overlap:
                # Serial baseline: the naive wiring stages every batch
                # through the host and waits on every grad step.
                corpus_ring.record_host_copy("train_embeddings.serial_batch")
                batch = tuple(x.cpu().to(device) for x in batch)
            params, opt, aux = sgns(params, opt, batch)
            if not overlap:
                train_loop.block_until_ready(params)
            return (params, opt), aux

        # ----------------------------------------------------------- ring
        cap = ring_capacity or 2 * walks_per_round
        ring0 = corpus_ring.init_ring(cap, path_width, device)
        state, ring, start_step = train_loop.resume_pipeline(
            ckpt_dir, state0, ring0)
        rounds_done = int(ring.tail) // walks_per_round

        if overlap:
            def append(ring, walks):
                return corpus_ring.append(ring, *walks)
        else:
            def append(ring, walks):
                # The naive hand-off the ring exists to delete: pull every
                # path to the host, upload it again, and wait.
                corpus_ring.record_host_copy("train_embeddings.serial")
                paths, lengths = (x.cpu() for x in walks)
                ring = corpus_ring.append(ring, paths.to(device),
                                          lengths.to(device))
                train_loop.block_until_ready(ring)
                return ring

        pcfg = train_loop.PipelineConfig(
            rounds=rounds, steps_per_round=steps_per_round, overlap=overlap,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, log_every=log_every)
        state, ring, step, history, _ = train_loop.run_pipelined(
            produce, append, sample, step_fn, state, ring, pcfg,
            start_step=start_step, rounds_done=rounds_done,
            batch_hook=batch_hook)
        params, opt_state = state
        return {"params": params, "opt_state": opt_state, "ring": ring,
                "step": step, "history": history, "config": sg_cfg}
