"""compile(program, backend=...) — the walker entry point.

:func:`compile` binds a :class:`~repro_torch.walker.WalkProgram` to a
backend and returns a :class:`Walker`:

    walker = compile(WalkProgram.deepwalk(), execution=ExecutionConfig(
        num_slots=4096, step_impl="cuda"))
    result = walker.run(graph, starts, seed=0)        # closed batch
    stream = walker.stream(graph, capacity=4096)      # open system
    service = walker.serve(graph, chunk=8)            # request service
    out = walker.train_embeddings(graph, dim=128)     # walks → embeddings

The walk runs where the graph lives: on the card, ``step_impl="cuda"``
and ``"fused"`` launch their kernels; on the CPU they run the kernels'
plain versions.  ``backend="sharded"`` partitions the graph into N shards
placed in groups over the mesh's devices (`repro_torch.core.distributed`:
per-phase butterfly routing, flow-controlled lossless refill; the plain
torch superstep) and offers the same four calls.  Paths are a pure
function of (seed, epoch, query_id, hop), so they are bit-identical to
the reference package for the same graph, starts and seed, under every
step implementation and either backend; on the single backend the stats
differ only in ``launches`` (one per superstep, or one per fused
launch).

Streams are continuous: query-id slots form a ring (a host-side free ring
hands slots to arrivals; ``release`` reclaims them after harvest with
``epoch + 1``), so an unbounded arrival stream runs in a bounded device
buffer with no drain barrier.  Epoch ``e`` of a stream equals
``Walker.run`` under ``rng.stream_key(seed, e)``.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import clock, corpus_ring
from repro_torch.core import rng as task_rng
from repro_torch.core.distributed import (DistLogs, assemble_paths,
                                          init_dist_stream_state,
                                          inject_stream_queries,
                                          make_distributed_engine,
                                          make_sharded_stream_engine,
                                          shard_starts)
from repro_torch.core.tasks import WalkResult, WalkStats
from repro_torch.core.walk_engine import (Drain, StreamState, build_engine,
                                          init_stream_state, inject_queries,
                                          make_superstep_runner,
                                          maybe_build_cache)
from repro_torch.distributed.mesh import (Mesh, card_groups, gather_first,
                                          reduce_first)
from repro_torch.graph.partition import PartitionedGraph, partition_graph
from repro_torch.models import embeddings as emb
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop
from repro_torch.walker.execution import ExecutionConfig
from repro_torch.walker.program import WalkProgram

BACKENDS = ("single", "sharded")


def _pad_block(n: int, floor: int = 16) -> int:
    """Next power of two >= n (>= floor): an injection uploads a block of
    this many entries, so its uploads take O(log capacity) sizes, as the
    reference's injections do (there it bounds the compiled shapes)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def compile(program: WalkProgram, backend: str = "single",
            execution: Optional[ExecutionConfig] = None,
            mesh: Optional[Mesh] = None) -> "Walker":
    """Bind ``program`` to an execution backend.

    backend:
      ``single``  — one device: slot-pool engine with zero-bubble refill.
      ``sharded`` — N shards (``mesh``, or ``execution.num_devices``, or
                    a `PartitionedGraph`'s own count): vertex-partitioned
                    graph, per-phase butterfly routing, flow-controlled
                    lossless refill.  The shards lie in groups, one a
                    device of ``mesh``; without one, as the reference's
                    ``jax.devices()[:N]``, over the largest G dividing N
                    that is at most the visible cards (:func:`default_mesh`;
                    one group on the graph's device on one card or the
                    CPU).  A `PartitionedGraph` keeps its own placement.
    """
    if not isinstance(program, WalkProgram):
        raise TypeError(
            f"compile expects a WalkProgram, got {type(program).__name__}; "
            "build one with WalkProgram.urw()/ppr()/deepwalk() or "
            "WalkProgram(spec=...)")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    return Walker(program, backend, execution or ExecutionConfig(), mesh)


def default_mesh(graph, num_shards: int) -> Mesh:
    """The mesh a sharded run takes when none is given: G groups on
    ``cuda:0`` … ``cuda:G-1``, G the largest divisor of ``num_shards``
    that is at most the number of visible cards; one group on the graph's
    device when G is 1 (one card, or a graph on the CPU).  Spread over
    cards the superstep is slower than on one card (on four H100s, URW at
    4 x 1,024 lanes took 2.2-2.5x one card's time over 2 cards and 4.1-5x
    over 4; ``PERF.md``): the spread buys room for the graph, not speed, and
    ``Mesh(num_shards, "cuda:0")`` keeps every shard on one card."""
    dev = graph.device
    groups = card_groups(num_shards) if dev.type == "cuda" else (dev,)
    return Mesh(num_shards, groups if len(groups) > 1 else dev)


class Walker:
    """A compiled walk program: one algorithm, four execution styles."""

    def __init__(self, program: WalkProgram, backend: str,
                 execution: ExecutionConfig, mesh: Optional[Mesh] = None):
        self.program = program
        self.backend = backend
        self.execution = execution
        self._mesh = mesh
        # sharded runners keyed by graph shape and resolved config; see
        # _dist_engine.
        self._dist_cache = {}
        # (spec, engine config, id(graph) when a cache is wanted) ->
        # (engine, graph); see _single_engine.
        self._engines = {}
        # (graph signature token, workload bucket) -> (program, execution);
        # see _bind.
        self._resolved = {}
        #: Host timing of the last :meth:`run` (wall and per-superstep sync).
        self.last_drain: Optional[Drain] = None
        #: Per-shard `WalkStats` (each field (N,)) of the last sharded run.
        self.last_shard_stats: Optional[WalkStats] = None

    def _bind(self, graph, num_queries: Optional[int] = None):
        """Concrete ``(program, execution)`` for this graph + workload.

        Resolves any ``"auto"`` knob sentinels (and a reservoir spec's
        ``adaptive_chunks="auto"``) through the tuning cache / analytical
        model (`repro_torch.tune.resolve`) — memoized per (graph
        signature, workload bucket), so repeat runs on a same-shaped
        graph reuse both the resolution and the engine.  With no
        sentinels present this is the identity.
        """
        from repro_torch import tune
        if not tune.needs_resolution(self.program, self.execution):
            return self.program, self.execution
        sig = tune.graph_signature(graph)
        key = (sig.token(), tune.workload_bucket(num_queries))
        if key not in self._resolved:
            self._resolved[key] = tune.resolve(
                self.program, self.execution, graph, backend=self.backend,
                num_queries=num_queries)
        return self._resolved[key]

    def _partition(self, graph) -> PartitionedGraph:
        """``graph`` as shards: a `PartitionedGraph` as it is, a `CSRGraph`
        partitioned over the mesh's shards and devices, or over
        ``execution.num_devices`` (default: the number of visible cards, at
        least 1) shards placed by :func:`default_mesh`."""
        if isinstance(graph, PartitionedGraph):
            return graph
        mesh = self._mesh
        if mesh is None:
            n = (self.execution.num_devices
                 or max(torch.cuda.device_count(), 1))
            mesh = default_mesh(graph, n)
        return partition_graph(graph, mesh.num_shards, mesh)

    def _requires_sharded(self, graph) -> None:
        if not isinstance(graph, PartitionedGraph):
            self.program.requires(graph)
        elif (self.program.spec.kind == "alias"
              and graph.groups[0].alias_prob is None):
            raise ValueError(
                "alias (DeepWalk) programs need alias tables on the "
                "partitioned graph — build the CSRGraph with alias tables "
                "before partition_graph")

    def _dist_engine(self, pg: PartitionedGraph, program, execution):
        """The closed sharded runner for graphs shaped like ``pg`` under
        the resolved ``(program, execution)``, built once, and its
        `DistConfig`."""
        grp = pg.groups[0]
        key = (pg.num_devices, pg.devices, pg.vertices_per_device,
               tuple(grp.col.shape), pg.max_degree, grp.weights is not None,
               grp.alias_prob is not None, program.spec, execution)
        if key not in self._dist_cache:
            cfg = execution.dist_config(program, pg.num_devices)
            self._dist_cache[key] = (
                make_distributed_engine(pg, program.spec, cfg, self._mesh),
                cfg)
        return self._dist_cache[key]

    def _run_sharded(self, graph, starts, seed) -> WalkResult:
        self._requires_sharded(graph)
        pg = self._partition(graph)
        starts_np = (starts.cpu().numpy() if isinstance(starts, torch.Tensor)
                     else np.asarray(starts)).astype(np.int32).reshape(-1)
        program, execution = self._bind(pg, starts_np.size)
        run, cfg = self._dist_engine(pg, program, execution)
        starts_sh, qcount = shard_starts(starts_np, pg.num_devices)
        log_q, log_h, log_v, cursor, stats = run(
            pg, starts_sh, qcount, task_rng.stream_key(seed))
        self.last_shard_stats = stats
        # Shards run the lockstep superstep loop the same number of times:
        # supersteps/launches are global clocks (max), the rest is additive.
        total = WalkStats(*(
            v.max() if name in ("supersteps", "launches") else v.sum()
            for name, v in zip(WalkStats._fields, stats)))
        if int(total.supersteps) >= cfg.max_supersteps:
            warnings.warn(
                f"sharded run hit max_supersteps={cfg.max_supersteps} before "
                "draining — walks may be truncated; raise "
                "ExecutionConfig.max_supersteps", RuntimeWarning,
                stacklevel=3)
        if int(total.drops) > 0:
            # Routing drops are structurally impossible (flow-controlled
            # refill), so any drop is an emission-log overflow: recorded
            # paths have holes.
            warnings.warn(
                f"{int(total.drops)} path records dropped (emission log "
                "overflow) — assembled paths are incomplete; raise "
                "ExecutionConfig.log_capacity", RuntimeWarning, stacklevel=3)
        if cfg.record_paths:
            logs = DistLogs(qid=log_q, hop=log_h, vertex=log_v, cursor=cursor)
            paths, lengths = assemble_paths(logs, starts_np,
                                            self.program.max_hops)
            return WalkResult(paths=paths, lengths=lengths, stats=total)
        dev = pg.devices[0]
        return WalkResult(
            paths=torch.full((1, 1), -1, dtype=torch.int32, device=dev),
            lengths=torch.zeros((1,), dtype=torch.int32, device=dev),
            stats=total)

    def run(self, graph, starts, seed=0) -> WalkResult:
        """Closed system: drain the batch of ``starts`` to completion on
        the graph's device (per superstep, or in fused launches of
        ``hops_per_launch`` supersteps).

        ``seed`` may be an int or a key pair (two 32-bit words, e.g.
        ``rng.stream_key(s, e)``).  On the sharded backend ``graph`` may be
        a ``CSRGraph`` (partitioned on the fly) or a ``PartitionedGraph``;
        the emission logs are assembled into the single backend's
        ``WalkResult`` layout on the mesh's first device, with the shards'
        stats folded (max of ``supersteps`` and ``launches``, sum of the
        rest)."""
        if self.backend == "sharded":
            return self._run_sharded(graph, starts, seed)
        self.program.requires(graph)
        if isinstance(starts, torch.Tensor):
            sv = starts.to(device=graph.device, dtype=torch.int32)
        else:
            sv = torch.as_tensor(np.asarray(starts, dtype=np.int32),
                                 device=graph.device)
        program, execution = self._bind(graph, int(sv.shape[0]))
        engine = self._single_engine(graph, program,
                                     execution.engine_config(program))
        result, self.last_drain = engine(graph, sv, task_rng.stream_key(seed))
        return result

    def _single_engine(self, graph, program, cfg):
        """The engine for ``program`` on ``graph`` under the engine config
        ``cfg`` (both resolved), built once.  The hot-vertex cache is a
        function of the graph, so graph identity keys the memo whenever a
        cache would be built; the memo holds the graph, keeping its id()
        stable for the entry's lifetime."""
        spec = program.spec
        wants_cache = cfg.step_impl == "fused" and cfg.cache_budget > 0
        key = (spec, cfg, id(graph) if wants_cache else None)
        if key not in self._engines:
            cache = maybe_build_cache(spec, cfg, graph)
            self._engines[key] = (build_engine(spec, cfg, cache=cache), graph)
        return self._engines[key][0]

    def stream(self, graph, capacity: int = 4096, seed=0):
        """Open system: a persistent stream on the graph's device that
        accepts injections between superstep chunks, with ring-buffer slot
        reclamation (``release``) for continuous operation.  ``seed`` may
        be an int or a key pair.

        A :class:`WalkStream` on the single backend, a
        :class:`ShardedWalkStream` on the sharded one; both expose the same
        inject / advance / harvest_ids / release surface, so `WalkService`
        runs unchanged over either."""
        if self.backend == "sharded":
            self._requires_sharded(graph)
            pg = self._partition(graph)
            program, execution = self._bind(pg, capacity)
            cfg = execution.dist_config(program, pg.num_devices)
            return ShardedWalkStream(program, cfg, pg, capacity, seed,
                                     self._mesh)
        self.program.requires(graph)
        program, execution = self._bind(graph, capacity)
        return WalkStream(program, execution, graph, capacity, seed)

    def serve(self, graph, capacity: int = 4096, chunk: int = 16,
              seed=0, adapt: bool = False, controller=None):
        """Multi-tenant request service over :meth:`stream` on the graph's
        device, on either backend (`repro_torch.serve.WalkService`, which
        speaks only the stream interface): requests of walks are
        admitted FIFO into free ring slots, advanced ``chunk`` supersteps
        at a time and harvested as each request completes.

        ``adapt=True`` attaches the Theorem VI.1 chunk controller
        (`repro_torch.serve.scheduler.HopsController`, overridable via
        ``controller``): the service adapts its supersteps per advance
        online from the engine's occupancy stats, trace exposed on
        ``ServiceAnalysis.adaptation``.
        """
        from repro_torch.serve.service import WalkService
        return WalkService(stream=self.stream(graph, capacity=capacity,
                                              seed=seed),
                           chunk=chunk, adapt=adapt, controller=controller)

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
        on the graph's device.  The single backend produces each round as a
        closed batch; the sharded backend through a stream (round r is the
        stream's epoch r), with the same walks.

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

        On the sharded backend the producer's shards lie in the mesh's
        device groups; the corpus ring, both tables and their AdamW
        moments lie whole on the first group's device, where each round's
        walks are harvested and every SGNS step runs its two kernels.  The
        step sees whole tables, as the reference's ``pallas_call`` (which
        has no sharding rule) does; the run is bit-equal to the one-group
        run.

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
        nv = int(graph.num_vertices)
        path_width = self.program.max_hops + 1

        # ------------------------------------------------------- producer
        stream = None
        if self.backend == "single":
            device = graph.device
            self.program.requires(graph)
            program, execution = self._bind(graph, walks_per_round)
            engine = self._single_engine(graph, program, dataclasses.replace(
                execution.engine_config(program), record_paths=True))

            def produce(r: int):
                sv = torch.as_tensor(
                    ((r * walks_per_round + np.arange(walks_per_round)) % nv)
                    .astype(np.int32), device=device)
                res, _ = engine(graph, sv, task_rng.stream_key(seed, r))
                return res.paths, res.lengths
        else:
            # The stream's epoch r is round r: its walks are the closed
            # batch under stream_key(seed, r), as on the single backend.
            stream = self.stream(graph, capacity=walks_per_round, seed=seed)
            device = stream.graph.devices[0]

            def produce(r: int):
                starts = (r * walks_per_round
                          + np.arange(walks_per_round)) % nv
                qids, epochs = stream.inject(starts)
                if int(epochs[0]) != r:
                    raise RuntimeError(
                        f"producer stream is at epoch {int(epochs[0])} but "
                        f"round {r} was requested (rounds must be produced "
                        "in order; use seek_epochs after a resume)")
                stream.drain()
                paths, lengths = stream.harvest_device(qids)
                stream.release(qids)
                return paths, lengths

        # ------------------------------------------------------- consumer
        sg_cfg = emb.SkipGramConfig(num_vertices=nv, dim=dim,
                                    num_negatives=num_negatives,
                                    window=window)
        opt_cfg = opt_cfg or adamw.AdamWConfig(
            lr=1e-2, warmup_steps=max(1, rounds * steps_per_round // 10),
            total_steps=rounds * steps_per_round)
        params0 = emb.init_params(task_rng.seeded_generator(seed), sg_cfg,
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
        if stream is not None:
            # A multiple of the shard count, as the reference rounds it to
            # shard the ring's rows; here the ring stays whole on the first
            # group's device.
            ndev = stream.graph.num_devices
            cap = -(-cap // ndev) * ndev
        ring0 = corpus_ring.init_ring(cap, path_width, device)
        state, ring, start_step = train_loop.resume_pipeline(
            ckpt_dir, state0, ring0)
        rounds_done = int(ring.tail) // walks_per_round
        if stream is not None:
            stream.seek_epochs(rounds_done)

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


class _StreamBase:
    """Host-side ring economy of a stream.

    The host owns the free ring: slot ids 0..capacity-1 start free, an
    injection pops slots FIFO and assigns each arrival ``(epoch, qid)``,
    and :meth:`release` returns harvested slots with ``epoch + 1`` so the
    next occupant samples an independent walk (`rng.task_fold` salts the
    derivation with the epoch).  The stream therefore never drains as a
    whole — slots individually complete, are harvested, and go around
    again.
    """

    capacity: int

    def _init_ring(self) -> None:
        self._free = deque(range(self.capacity))
        self._epochs = np.zeros((self.capacity,), np.int32)
        self._live = np.zeros((self.capacity,), bool)
        self._injected = 0

    # -- subclass hooks ----------------------------------------------------

    def _device_inject(self, qids: np.ndarray, starts: np.ndarray,
                       epochs: np.ndarray) -> None:
        raise NotImplementedError

    def advance(self, k: int = 16) -> int:
        """Run at most ``k`` supersteps on the persistent device state."""
        raise NotImplementedError

    def done_mask(self) -> np.ndarray:
        """Per-slot completion flags (capacity-sized, includes free slots)."""
        raise NotImplementedError

    def harvest_device(self, qids):
        """``(paths, lengths)`` for the given live query-id slots as
        tensors on the stream's device (no host copy) — the corpus-ring
        feed."""
        raise NotImplementedError

    # -- ring economy ------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Slots available for injection right now."""
        return len(self._free)

    @property
    def num_live(self) -> int:
        """Slots occupied by injected-but-not-released queries."""
        return self.capacity - len(self._free)

    @property
    def num_injected(self) -> int:
        """Total arrivals ever injected (monotone; exceeds capacity once
        slots recycle)."""
        return self._injected

    def epoch_of(self, qids) -> np.ndarray:
        """Current occupant epoch of each slot id."""
        return self._epochs[np.asarray(qids, np.int64)]

    def inject(self, starts, n_valid: Optional[int] = None):
        """Admit arrivals into free ring slots.

        Returns ``(qids, epochs)`` — the slot id and epoch assigned to each
        arrival, the identity under which its walk is sampled and
        harvested.  Raises if fewer than ``n_valid`` slots are free
        (``release`` harvested queries to make room).
        """
        sv = np.asarray(starts, np.int32).reshape(-1)
        n = int(sv.size if n_valid is None else n_valid)
        if not 0 < n <= sv.size:
            raise ValueError(
                f"n_valid={n} must be within [1, {sv.size}] (the injected "
                "block)")
        if n > len(self._free):
            raise ValueError(
                f"injecting {n} queries overflows the slot ring "
                f"({self.num_live}/{self.capacity} live, {len(self._free)} "
                "free); release harvested queries or raise capacity")
        qids = np.asarray([self._free.popleft() for _ in range(n)], np.int32)
        epochs = self._epochs[qids]
        self._live[qids] = True
        self._injected += n
        self._device_inject(qids, sv[:n], epochs)
        return qids, epochs

    def release(self, qids) -> None:
        """Return harvested slots to the free ring with ``epoch + 1``."""
        qids = np.asarray(qids, np.int64).reshape(-1)
        if np.unique(qids).size != qids.size:
            # A duplicate would enter the free ring twice and hand the same
            # (epoch, qid) identity to two future arrivals.
            raise ValueError("release with duplicate slot ids")
        if not self._live[qids].all():
            raise ValueError("release of a slot that is not live")
        done = self.done_mask()
        if not done[qids].all():
            raise ValueError(
                "release of an unfinished query: harvest only completed "
                "slots (done_mask) before recycling them")
        self._live[qids] = False
        self._epochs[qids] += 1
        self._free.extend(int(q) for q in qids)

    def seek_epochs(self, epoch: int) -> None:
        """Fast-forward every free slot's epoch (resume support): the next
        occupant of every slot samples round ``epoch``, bit-identical to a
        fresh stream that walked through the earlier rounds, because epoch
        ``e`` of a slot is a pure function of ``(seed, e, qid)``."""
        if self._live.any():
            raise RuntimeError("seek_epochs with live queries outstanding")
        if epoch < int(self._epochs.max(initial=0)):
            raise ValueError(
                f"seek_epochs({epoch}) would rewind a slot already past it "
                f"(max epoch {int(self._epochs.max(initial=0))}) and replay "
                "a used (epoch, qid) identity")
        self._epochs[:] = epoch

    def harvest_ids(self, qids):
        """``(paths, lengths)`` for the given live query-id slots as numpy
        (one recorded host round-trip over :meth:`harvest_device`)."""
        paths, lengths = self.harvest_device(qids)
        corpus_ring.record_host_copy("harvest_ids")
        return paths.cpu().numpy(), lengths.cpu().numpy()

    def done_live_mask(self) -> np.ndarray:
        """(capacity,) bool — live slots whose query has terminated (the
        harvestable set; released slots read False)."""
        return self.done_mask() & self._live

    def harvest(self, lo: int = 0, hi: Optional[int] = None):
        """Recorded (paths, lengths) for the contiguous slot range
        [lo, hi) as numpy.  Before any slot recycles, slots are handed out
        FIFO, so this matches injection order; under reuse prefer
        :meth:`harvest_ids` with the ids :meth:`inject` returned."""
        hi = min(self._injected, self.capacity) if hi is None else hi
        return self.harvest_ids(np.arange(lo, hi))

    def drain(self, chunk: int = 64, max_chunks: int = 100_000) -> None:
        """Advance until every live (injected, unreleased) query is done."""
        for _ in range(max_chunks):
            live = self._live
            if not live.any() or bool(self.done_mask()[live].all()):
                return
            self.advance(chunk)
        raise RuntimeError("stream did not drain (engine stalled?)")


class WalkStream(_StreamBase):
    """Persistent single-device open-system stream: inject → advance →
    harvest → release.

    A stateful handle over the superstep runner; all device state lives in
    one :class:`~repro_torch.core.StreamState` on the graph's device, whose
    shapes are fixed by (capacity, W, max_hops).  Under ``fused`` the state
    is packed with its control block once, when the stream is made (and
    again at :meth:`reset`), and keeps that block: injections write the
    arrival counter through the block's view and the runner re-arms the
    block's work word, so no launch re-packs.  ``host_read_s`` sums the
    seconds spent blocked in host reads of the device state (the runner's
    progress reads and :meth:`done_mask`) since the stream was made or
    reset.
    """

    def __init__(self, program: WalkProgram, execution: ExecutionConfig,
                 graph, capacity: int, seed):
        if capacity <= 0:
            raise ValueError(f"stream capacity must be positive, got "
                             f"{capacity}")
        self.program = program
        self.graph = graph
        self.seed = seed
        self.capacity = int(capacity)
        # Harvesting reads recorded paths, so recording is forced on.
        self._cfg = dataclasses.replace(
            execution.engine_config(program), record_paths=True)
        self._runner = make_superstep_runner(
            program.spec, self._cfg,
            cache=maybe_build_cache(program.spec, self._cfg, graph))
        self._fresh_state()

    def _fresh_state(self) -> None:
        self._key = task_rng.stream_key(self.seed)
        self.state: StreamState = init_stream_state(
            self._cfg, self.capacity, self.graph.device)
        self._block = None
        if self._cfg.step_impl == "fused":
            from repro_torch.kernels.fused_superstep import ops as fused_ops
            self.state, self._block = fused_ops.pack(self.state)
        self.host_read_s = 0.0
        self._init_ring()

    @property
    def num_slots(self) -> int:
        """W — walker lanes of the underlying engine."""
        return self._cfg.num_slots

    @property
    def max_hops(self) -> int:
        """The program's hop budget (path buffers are ``max_hops + 1``)."""
        return self.program.max_hops

    @property
    def cfg(self):
        """The lowered engine-layer config (:class:`EngineConfig`)."""
        return self._cfg

    def _device_inject(self, qids, starts, epochs) -> None:
        n = qids.shape[0]
        b = min(_pad_block(n), self.capacity)
        qb = np.full((b,), self.capacity, np.int32)  # capacity = inert pad
        sb = np.zeros((b,), np.int32)
        eb = np.zeros((b,), np.int32)
        qb[:n], sb[:n], eb[:n] = qids, starts, epochs
        self.state = inject_queries(self.state, qb, sb, eb, n)

    def advance(self, k: int = 16) -> int:
        """Run at most ``k`` supersteps; returns how many ran."""
        self.state, ran, sync_s = self._runner(self.graph, self.state,
                                               self._key, k, self._block)
        self.host_read_s += sync_s
        return ran

    def done_mask(self) -> np.ndarray:
        """(capacity,) bool — True where that slot's query terminated."""
        t = clock.now()
        done = self.state.done.cpu().numpy()
        self.host_read_s += clock.now() - t
        return done

    def harvest_device(self, qids):
        """Recorded (paths, lengths) rows for the given slot ids, on the
        stream's device."""
        idx = torch.as_tensor(np.asarray(qids, np.int64),
                              device=self.graph.device)
        return self.state.paths[idx], self.state.lengths[idx]

    def walk_stats(self) -> WalkStats:
        """Engine counters since construction/reset (host ints)."""
        return WalkStats(*torch.stack(tuple(self.state.stats)).tolist())

    def reset(self, seed=None) -> None:
        """Fresh state and ring (keeps the runner and the cache); pass a
        new ``seed`` to decorrelate from previous runs."""
        if self._live.any():
            raise RuntimeError("reset with live queries outstanding")
        if seed is not None:
            self.seed = seed
        self._fresh_state()


class ShardedWalkStream(_StreamBase):
    """Persistent sharded open-system stream (``backend="sharded"``).

    Same interface and same ring economy as :class:`WalkStream`, running
    over the capability-dispatched sharded superstep: arrivals are staged
    round-robin onto per-shard arrival rings and the butterfly router
    carries each new task to owner(start_vertex); the flow control admits
    injections only while global live tasks stay ≤ N·W_loc, so the closed
    engine's losslessness (drops == 0) carries over to the open system.
    Harvest max-folds the per-shard path windows (each hop is recorded by
    exactly the shard that executed it), over the groups on the first
    group's device.  ``states`` holds one
    `~repro_torch.core.distributed.DistStreamState` a group, on its
    device.  ``host_read_s`` sums the seconds spent blocked in host reads
    (the runner's work flag and :meth:`done_mask`) since the stream was
    made or reset.

    Bit-identity: the ``(epoch, qid)`` occupant samples exactly the walk
    ``Walker.run`` samples for query ``qid`` under ``rng.stream_key(seed,
    epoch)`` — identical across backends.
    """

    def __init__(self, program: WalkProgram, cfg, pg: PartitionedGraph,
                 capacity: int, seed, mesh: Optional[Mesh] = None):
        if capacity <= 0:
            raise ValueError(f"stream capacity must be positive, got "
                             f"{capacity}")
        self.program = program
        self.graph = pg
        self.seed = seed
        self.capacity = int(capacity)
        self._cfg = cfg
        self._runner = make_sharded_stream_engine(pg, program.spec, cfg,
                                                  mesh, self.capacity)
        self._fresh_state()

    def _fresh_state(self) -> None:
        self.states = init_dist_stream_state(self.graph, self.program.spec,
                                             self._cfg, self.capacity)
        self._base_key = task_rng.stream_key(self.seed)
        self._next_dev = 0  # round-robin staging cursor
        self.host_read_s = 0.0
        self._init_ring()

    @property
    def num_slots(self) -> int:
        """W — total lanes across the shards (shards × W_loc)."""
        return self.graph.num_devices * self._cfg.slots_per_device

    @property
    def max_hops(self) -> int:
        """The program's hop budget (path buffers are ``max_hops + 1``)."""
        return self.program.max_hops

    @property
    def cfg(self):
        """The lowered engine-layer config (:class:`DistConfig`)."""
        return self._cfg

    def _device_inject(self, qids, starts, epochs) -> None:
        n = qids.shape[0]
        N = self.graph.num_devices
        # Arrival i goes to shard (next + i) % N, at column i // N there.
        i = np.arange(n)
        r = (self._next_dev + i) % N
        b = -(-n // N)
        blocks = np.zeros((3, N, b), np.int32)
        blocks[:, r, i // N] = starts, qids, epochs
        cnt = np.bincount(r, minlength=N)
        self._next_dev = (self._next_dev + n) % N
        self.states = inject_stream_queries(self.states, *blocks, cnt)

    def advance(self, k: int = 16) -> int:
        """Run at most ``k`` supersteps; returns how many ran."""
        self.states, ran, sync_s = self._runner(self.graph, self.states,
                                                self._base_key, k)
        self.host_read_s += sync_s
        return ran

    def done_mask(self) -> np.ndarray:
        """(capacity,) bool — a slot is done once any shard terminated its
        occupant's walk (one host read)."""
        t = clock.now()
        done = reduce_first([st.done[:, :self.capacity]
                             for st in self.states], torch.any)[0]
        done = done.cpu().numpy()
        self.host_read_s += clock.now() - t
        return done

    def harvest_device(self, qids):
        """Max-fold the per-shard path windows for the given slot ids — a
        reduction over the shard axis, on the first group's device."""
        q = np.asarray(qids, np.int64)
        parts = []
        for st in self.states:
            idx = torch.as_tensor(q, device=st.paths.device)
            parts.append((st.paths[:, idx, :], st.lengths[:, idx]))
        return tuple(reduce_first(x, torch.amax)[0] for x in zip(*parts))

    def walk_stats(self) -> WalkStats:
        """Engine counters summed across shards (supersteps/launches are
        the global lockstep clock: max), as host ints."""
        shards = (gather_first(f) for f in zip(*(st.stats
                                                 for st in self.states)))
        return WalkStats(*(
            int(v.max()) if name in ("supersteps", "launches")
            else int(v.sum())
            for name, v in zip(WalkStats._fields, shards)))

    def reset(self, seed=None) -> None:
        """Fresh state and ring (keeps the runner); pass a new ``seed`` to
        decorrelate from previous runs."""
        if self._live.any():
            raise RuntimeError("reset with live queries outstanding")
        if seed is not None:
            self.seed = seed
        self._fresh_state()
