"""Single-device walk engine: out-of-order slot-pool execution with
zero-bubble refill (paper §V + §VI, on a SIMD superstep machine).

One *superstep* advances every live lane by one hop — Row Access →
Sampling → Column Access — then terminates finished walks and refills
freed lanes from the pending-query queue.  Each task is stateless and its
randomness derives from (seed, query_id, hop), so lanes are
interchangeable: which lane serves a hop does not change the path.

Two scheduling modes:
  * ``zero_bubble`` — per-superstep compaction + refill (RidgeWalker).
  * ``static``      — bulk-synchronous batches: the engine waits for the
    slowest walk of a batch before loading the next; early-terminating
    walks leave idle lanes, counted as bubbles.

The host→device injection latency is modeled by the queue's ``staged``
watermark, advanced by a feedback controller that observes ``head`` C
supersteps late; `scheduler.min_queue_depth` sizes the stage-ahead depth
(Theorem VI.1).

Three step implementations, bit-identical in every output but
``stats.launches``:
  * ``torch`` — the plain tensor superstep (row access, the sampler's
    phase program, column access);
  * ``cuda``  — the same superstep with row access, sampling and column
    access done by the hand-written one-hop kernel
    (`repro_torch.kernels.walk_step`) for the uniform and alias kinds
    (other kinds run the plain superstep, as the reference's ``pallas``
    does);
  * ``fused`` — ``hops_per_launch`` whole supersteps per launch of the
    device-resident kernel (`repro_torch.kernels.fused_superstep`): lane
    pool, RNG, termination, controller and refill stay on the device.
    With ``cache_budget > 0`` its gathers keyed on a lane's current
    vertex read the hottest vertices' rows from a packed copy
    (`repro_torch.graph.hot_cache`), which changes only the three cache
    counters of the stats.

Two systems share one superstep runner (:func:`make_superstep_runner`):
the closed batch (:func:`build_engine`) drains a fixed query batch; the
open system (``walker.WalkStream``) keeps one :class:`StreamState` alive,
injects arrivals into ring slots between chunks of supersteps
(:func:`inject_queries`) and harvests finished slots.  The per-hop impls
run a host loop that reads ``_work_left`` once per superstep and count one
launch per superstep; ``fused`` reads one (work left, supersteps) word
pair once per launch and counts one launch per launch.  Either way
``supersteps`` and ``slot_steps`` stay exact.  The per-hop superstep
writes the path buffers in place (they are the largest state, (Q,
max_hops+1) int32) and replaces every other tensor; the fused launch and
an injection update every state tensor they touch in place.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import clock, rng as task_rng, scheduler as sched
from repro_torch.core.phase_program import lower as lower_program, make_sampler
from repro_torch.core.rng import SALT_COLUMN, SALT_STOP
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.tasks import (QueryQueue, WalkerSlots, WalkResult,
                                    WalkStats, empty_queue, empty_slots,
                                    make_queue, zero_stats)
from repro_torch.graph.csr import CSRGraph, column_access, row_access
from repro_torch.kernels.walk_step import ops as walk_ops

MODES = ("zero_bubble", "static")
STEP_IMPLS = ("torch", "cuda", "fused")

# Draw streams the engine itself issues per task, outside any sampler
# phase program, for the static verifier (`repro_torch.analysis`).  The PPR
# stop draw shares the task's (seed, epoch, qid, hop) fold with the
# sampler's draws, so its salt must stay disjoint from every
# `PhaseProgram.draw_streams()` stream.  Every impl (the torch superstep,
# the sharded engine and the fused kernel's ``kSaltStop``) issues this one
# logical draw.
ENGINE_DRAW_STREAMS = (("engine.stop_draw", SALT_STOP, 1),)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 1024          # W — lane count (outstanding tasks)
    max_hops: int = 80             # paper §VIII-A4: query length 80
    record_paths: bool = True
    mode: str = "zero_bubble"      # zero_bubble | static
    injection_delay: int = 0       # C supersteps of host->device latency
    queue_depth_factor: float = 1.0  # × Theorem VI.1 depth D
    max_supersteps: int = 1 << 20  # safety bound for the drain loop
    step_impl: str = "torch"       # torch | cuda (one-hop kernel) | fused
                                   # (device-resident multi-hop kernel)
    hops_per_launch: int = 16      # fused only: supersteps per launch
    cache_budget: int = 0          # fused only: byte budget of the
                                   # hot-vertex adjacency cache (0 = off);
                                   # gathers on cached hubs read the packed
                                   # block, bit-identically

    def __post_init__(self):
        if self.num_slots <= 0:
            raise ValueError(
                f"num_slots must be a positive lane count (W), got "
                f"{self.num_slots}; a zero-width slot pool can do no work")
        if self.max_hops <= 0:
            raise ValueError(
                f"max_hops must be positive, got {self.max_hops}; a walk "
                "needs at least one hop of budget")
        if self.mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES}, got {self.mode!r}")
        check_step_impl(self.step_impl)
        if self.injection_delay < 0:
            raise ValueError(
                f"injection_delay is a latency in supersteps and cannot be "
                f"negative, got {self.injection_delay}")
        if self.queue_depth_factor <= 0:
            raise ValueError(
                f"queue_depth_factor must be positive (it scales the "
                f"Theorem VI.1 stage-ahead depth), got "
                f"{self.queue_depth_factor}")
        if self.max_supersteps <= 0:
            raise ValueError(
                f"max_supersteps must be positive, got {self.max_supersteps}")
        if self.hops_per_launch <= 0:
            raise ValueError(
                f"hops_per_launch must be a positive superstep count per "
                f"fused-kernel launch, got {self.hops_per_launch}")
        if self.cache_budget < 0:
            raise ValueError(
                f"cache_budget is a byte budget (0 disables the hot-vertex "
                f"cache) and cannot be negative, got {self.cache_budget}")


def check_step_impl(step_impl: str) -> None:
    """Raise unless ``step_impl`` is one this package runs."""
    if step_impl not in STEP_IMPLS:
        raise ValueError(
            f"step_impl must be one of {STEP_IMPLS}, got {step_impl!r} "
            "('torch' is the plain superstep, 'cuda' the one-hop kernel, "
            "'fused' the multi-superstep kernel)")


class StreamState(NamedTuple):
    """Engine state threaded through the supersteps of one run."""

    slots: WalkerSlots
    queue: QueryQueue
    paths: torch.Tensor      # (Q, max_hops+1) int32; (1, 1) when not recording
    lengths: torch.Tensor    # (Q,) int32; (1,) when not recording
    done: torch.Tensor       # (Q,) bool — query fully terminated
    stats: WalkStats
    head_hist: torch.Tensor  # (C+1,) int64 — delayed head observations


class Drain(NamedTuple):
    """Host-side timing of one closed-batch drain: its wall time (ending
    with the device idle) and the part of it spent blocked in the
    progress read (once per superstep, or once per launch for ``fused``)."""

    wall_s: float
    sync_s: float


class Chunk(NamedTuple):
    """What one call of a superstep runner did: the state it left, the
    supersteps it ran, and the seconds it spent blocked in the progress
    read."""

    state: StreamState
    supersteps: int
    sync_s: float


def _stage_depth(cfg: EngineConfig) -> int:
    d = sched.min_queue_depth(cfg.num_slots, mu=1.0, delay=cfg.injection_delay)
    return max(1, int(round(cfg.queue_depth_factor * d)))


def maybe_build_cache(spec: SamplerSpec, cfg: EngineConfig, graph: CSRGraph):
    """Hot-vertex cache for this (spec, cfg, graph), or ``None``.

    The cache only exists for the fused kernel with a positive byte
    budget; its payload set comes from the phase program's declared
    ``cache_payloads`` (columns always, plus weights / alias tables /
    typed offsets as the sampler's gather phases require).  Building is
    host-side numpy work — callers that rebind graphs should memoize on
    graph identity (`repro_torch.walker.compile` does).
    """
    if cfg.step_impl != "fused" or cfg.cache_budget <= 0:
        return None
    from repro_torch.graph.hot_cache import build_hot_cache
    payloads = lower_program(spec).cache_payloads
    return build_hot_cache(graph, payloads, cfg.cache_budget)


def _fresh_buffers(cfg: EngineConfig, num_queries: int, device):
    if cfg.record_paths:
        paths = torch.full((num_queries, cfg.max_hops + 1), -1,
                           dtype=torch.int32, device=device)
        lengths = torch.zeros((num_queries,), dtype=torch.int32, device=device)
    else:
        paths = torch.full((1, 1), -1, dtype=torch.int32, device=device)
        lengths = torch.zeros((1,), dtype=torch.int32, device=device)
    return paths, lengths


def _refill(slots: WalkerSlots, queue: QueryQueue, paths, lengths,
            cfg: EngineConfig, terminated: torch.Tensor):
    """Zero-bubble compaction + refill: freed lanes pull the next staged
    arrivals in lane order, ranked by a prefix sum over the free lanes.
    Only the lanes that take an arrival write its path's first vertex."""
    free = (~slots.active) | terminated
    if cfg.mode == "static":
        # Bulk-synchronous: only reload when the whole batch drained.
        free = free & free.all()
    avail = torch.clamp(queue.staged - queue.head, min=0)
    rank = torch.cumsum(free.to(torch.int32), 0) - 1   # rank among free lanes
    take = free & (rank < avail)
    pos = (queue.head + torch.clamp(rank, min=0)) % queue.capacity
    qid = queue.order[pos]
    start = queue.start_vertex[qid.long()]
    ep = queue.epoch[qid.long()]

    new_slots = WalkerSlots(
        v_curr=torch.where(take, start, slots.v_curr),
        v_prev=torch.where(take, -1, slots.v_prev),
        query_id=torch.where(take, qid,
                             torch.where(terminated, -1, slots.query_id)),
        hop=torch.where(take, 0, slots.hop),
        active=take | (slots.active & ~terminated),
        epoch=torch.where(take, ep, slots.epoch),
    )
    new_queue = queue._replace(head=queue.head + take.sum())
    if cfg.record_paths:
        q = qid[take].long()
        paths[q, 0] = start[take]
        lengths[q] = 1
    return new_slots, new_queue, paths, lengths


def _advance_controller(queue: QueryQueue, head_hist: torch.Tensor,
                        cfg: EngineConfig, depth: int):
    """Feedback-driven staging: observe head with a C-superstep delay and
    keep the staged watermark >= delayed_head + D (Theorem VI.1), clipped
    to the queries that have arrived (``tail``).  ``head_hist`` holds the
    last C+1 head observations; pushing the current head and reading
    index 0 yields the head of exactly C supersteps ago."""
    head_hist = torch.cat([head_hist[1:], queue.head.reshape(1)])
    target = torch.minimum(head_hist[0] + depth, queue.tail)
    return queue._replace(staged=torch.maximum(queue.staged, target)), head_hist


def _process(graph: CSRGraph, spec: SamplerSpec, cfg: EngineConfig, key,
             sample, slots: WalkerSlots, paths, lengths, done):
    """One hop for every live lane: Row Access → Sampling → Column Access →
    terminate.  Only advancing lanes write their path entry, and only
    terminating lanes set their done bit."""
    A = slots.active

    # PPR teleport/termination draw (before the hop; geometric walk length).
    if spec.stop_prob > 0.0:
        u_stop = task_rng.task_uniforms(key, slots.query_id, slots.hop, 1,
                                        SALT_STOP, epoch=slots.epoch)[:, 0]
        stop = A & (u_stop < float(np.float32(spec.stop_prob)))
    else:
        stop = torch.zeros_like(A)

    if cfg.step_impl == "cuda" and lower_program(spec).cuda:
        if spec.kind == "uniform":
            u = task_rng.task_uniforms(key, slots.query_id, slots.hop, 1,
                                       SALT_COLUMN, epoch=slots.epoch)
            v_next, deg = walk_ops.walk_step_uniform(
                slots.v_curr, u[:, 0].contiguous(), graph.row_ptr, graph.col)
        else:
            u = task_rng.task_uniforms(key, slots.query_id, slots.hop, 2,
                                       SALT_COLUMN, epoch=slots.epoch)
            v_next, deg = walk_ops.walk_step_alias(
                slots.v_curr, u[:, 0].contiguous(), u[:, 1].contiguous(),
                graph.row_ptr, graph.col, graph.alias_prob, graph.alias_idx)
        ok = deg > 0
    else:
        addr, deg = row_access(graph, slots.v_curr)           # stage 1
        idx, ok = sample(graph, addr, deg, slots, key)        # stage 2
        v_next = column_access(graph, addr, idx)              # stage 3

    adv = A & ~stop & ok
    dead = A & ~stop & ~ok
    new_hop = torch.where(adv, slots.hop + 1, slots.hop)
    reached_max = adv & (new_hop >= cfg.max_hops)
    terminated = stop | dead | reached_max

    new_slots = slots._replace(
        v_curr=torch.where(adv, v_next, slots.v_curr),
        v_prev=torch.where(adv, slots.v_curr, slots.v_prev),
        hop=new_hop,
    )
    if cfg.record_paths:
        q = slots.query_id[adv].long()
        h = new_hop[adv]
        paths[q, h.long()] = v_next[adv]
        lengths[q] = h + 1
    done[slots.query_id[terminated & A].long()] = True
    return new_slots, terminated, adv, paths, lengths, done


def _superstep(graph, spec, cfg, key, depth, sample,
               state: StreamState) -> StreamState:
    slots, queue, paths, lengths, done, stats, head_hist = state
    W = cfg.num_slots

    new_slots, terminated, adv, paths, lengths, done = _process(
        graph, spec, cfg, key, sample, slots, paths, lengths, done)

    idle = W - slots.active.sum()
    # Idle lanes while unserved queries exist upstream = scheduler
    # starvation (what Theorem VI.1 eliminates); idle lanes after the last
    # arrived query was issued = unavoidable tail drain.
    upstream = (queue.head < queue.tail).to(torch.int64)
    stats = stats._replace(
        steps=stats.steps + adv.sum(),
        slot_steps=stats.slot_steps + W,
        bubbles=stats.bubbles + idle,
        starved=stats.starved + idle * upstream,
        terminations=stats.terminations + (terminated & slots.active).sum(),
        supersteps=stats.supersteps + 1,
    )

    queue, head_hist = _advance_controller(queue, head_hist, cfg, depth)
    new_slots, queue, paths, lengths = _refill(new_slots, queue, paths,
                                               lengths, cfg, terminated)
    return StreamState(new_slots, queue, paths, lengths, done, stats,
                       head_hist)


def _count_launch(state: StreamState) -> StreamState:
    """One more device dispatch: after every superstep on the per-hop
    impls, once per launch of the fused kernel."""
    stats = state.stats
    return state._replace(stats=stats._replace(launches=stats.launches + 1))


def _work_left(state: StreamState) -> torch.Tensor:
    return (state.queue.head < state.queue.tail) | state.slots.active.any()


def init_state(cfg: EngineConfig, depth: int,
               start_vertices: torch.Tensor) -> StreamState:
    """The state a closed batch of ``start_vertices`` (a non-empty int32
    tensor, on the run's device) drains from: the queue staged to
    ``depth``, and the first lanes loaded (the initial injection, so that
    the lanes of superstep 1 are live)."""
    device = start_vertices.device
    num_queries = int(start_vertices.shape[0])
    paths, lengths = _fresh_buffers(cfg, num_queries, device)
    queue = make_queue(start_vertices, staged=min(depth, num_queries))
    head_hist = torch.zeros((cfg.injection_delay + 1,), dtype=torch.int64,
                            device=device)
    queue, head_hist = _advance_controller(queue, head_hist, cfg, depth)
    slots, queue, paths, lengths = _refill(
        empty_slots(cfg.num_slots, device), queue, paths, lengths, cfg,
        torch.zeros((cfg.num_slots,), dtype=torch.bool, device=device))
    return StreamState(
        slots=slots, queue=queue, paths=paths, lengths=lengths,
        done=torch.zeros((num_queries,), dtype=torch.bool, device=device),
        stats=zero_stats(device), head_hist=head_hist)


def init_stream_state(cfg: EngineConfig, capacity: int,
                      device) -> StreamState:
    """Empty open-system state on ``device``: a buffer with room for
    ``capacity`` queries, none of which have arrived yet (``tail == 0``)."""
    paths, lengths = _fresh_buffers(cfg, capacity, device)
    return StreamState(
        slots=empty_slots(cfg.num_slots, device),
        queue=empty_queue(capacity, device),
        paths=paths, lengths=lengths,
        done=torch.zeros((capacity,), dtype=torch.bool, device=device),
        stats=zero_stats(device),
        head_hist=torch.zeros((cfg.injection_delay + 1,), dtype=torch.int64,
                              device=device))


def inject_queries(state: StreamState, qids, new_starts=None, epochs=None,
                   n_valid=None) -> StreamState:
    """Admit arrivals into ring slots (host→device injection).

    ``qids`` are the slot ids the host popped from its free ring (a slot is
    free initially or once its previous occupant was harvested and
    released); ``epochs`` are the occupant epochs salting each slot's RNG
    stream.  The three are host arrays (numpy, lists or CPU tensors) of one
    length, which may be padded: only the first ``n_valid`` entries become
    queries, and nothing is written for the rest.  The arrival counter
    ``tail`` advances by ``n_valid`` and the new occupants are appended to
    the arrival-order ring that refill consumes, at ``(tail + i) %
    capacity``.  Recycled slots' ``done`` bits and recorded path rows are
    cleared, so a stale epoch never leaks into a harvest.  The host must
    hand out only free slots — `walker.WalkStream` owns that bookkeeping.

    Every tensor is written in place, ``tail`` included, so a fused
    stream's control block (which ``tail`` views) sees the arrivals; the
    fused runner re-arms the block's work word from the state before it
    reads it.  Returns ``state``.

    The pre-ring form ``inject_queries(state, new_starts, n_valid)``
    (append fresh queries at sequential slots from the tail, epoch 0)
    survives as a deprecated shim; it reads ``tail`` once on the host and
    then injects through the ring form, so out-of-range slots raise here
    too.
    """
    q = state.queue
    cap = q.capacity
    if epochs is None:  # legacy 3-arg form: (state, new_starts, n_valid)
        warnings.warn(
            "inject_queries(state, starts, n_valid) is deprecated; the ring "
            "engine takes (state, qids, starts, epochs, n_valid) — or use "
            "repro_torch.walker.compile(program).stream(graph), which owns "
            "the slot-ring bookkeeping", DeprecationWarning, stacklevel=2)
        starts = np.asarray(qids, np.int64).reshape(-1)
        n_valid = new_starts
        # Sequential fresh slots at the tail, epoch 0 — the old append
        # semantics (pad entries beyond n_valid are not written).
        qids = int(q.tail) + np.arange(starts.shape[0], dtype=np.int64)
        new_starts = starts
        epochs = np.zeros((starts.shape[0],), np.int64)
    block = np.stack([np.asarray(qids, np.int64).reshape(-1),
                      np.asarray(new_starts, np.int64).reshape(-1),
                      np.asarray(epochs, np.int64).reshape(-1)])
    n = int(n_valid)
    if not 0 <= n <= block.shape[1]:
        raise ValueError(f"n_valid={n} must be within [0, {block.shape[1]}] "
                         "(the injected block)")
    ids = block[0, :n]
    if n and not (0 <= ids.min() and ids.max() < cap):
        raise ValueError(f"slot ids must lie in [0, {cap}), got "
                         f"[{ids.min()}, {ids.max()}]")
    dev = q.start_vertex.device
    uploaded = torch.from_numpy(block.astype(np.int32)).to(dev)  # one copy
    qid, start, epoch = uploaded[:, :n].unbind()
    slot = qid.long()
    q.start_vertex[slot] = start
    q.epoch[slot] = epoch
    q.order[(q.tail + torch.arange(n, device=dev)) % cap] = qid
    state.done[slot] = False
    if state.paths.shape[0] == state.done.shape[0]:   # recording paths
        state.paths[slot] = -1
        state.lengths[slot] = 0
    q.tail.add_(n)
    return state


def make_superstep_runner(spec: SamplerSpec, cfg: EngineConfig, cache=None):
    """Build ``run_supersteps(graph, state, key, k, block=None) -> Chunk``.

    Advances ``state`` by at most ``k`` supersteps on the graph's device,
    stopping early when no work is left (no arrived query unissued and no
    live lane).  ``key`` is a base key pair (`rng.stream_key`).  The host
    injects arrivals between calls with :func:`inject_queries`.

    The per-hop impls run ``_superstep`` while work is left, reading the
    work flag once per superstep.  ``fused`` runs ``ceil(k /
    hops_per_launch)`` launches of the fused kernel (fewer when the work
    runs out), on a state packed with its control block
    (`kernels.fused_superstep.ops.pack`), which it takes as ``block``;
    it reads the block's progress pair once per launch and once before
    the first.  ``cache`` is the graph-specific hot-vertex cache from
    :func:`maybe_build_cache` (fused only); its packed block is copied to
    a run's device once, at the first run there.
    """
    if cfg.step_impl == "fused":
        from repro_torch.kernels.fused_superstep import ops as fused_ops
    sample = make_sampler(spec)
    depth = _stage_depth(cfg)
    blocks = {}   # the cache's packed block, per device

    def run_fused(graph, state, key, k, block):
        if block is None:
            raise ValueError("a fused runner advances a packed state: pass "
                             "the control block that fused_ops.pack returned")
        device = graph.device
        if cache is not None and device not in blocks:
            blocks[device] = fused_ops.cache_block(cache, device)
        cached = blocks.get(device)
        fused_ops.rearm(state, block)
        t = clock.now()
        more, first = fused_ops.progress(block)
        sync_s = clock.now() - t
        ran = 0
        while more and ran < k:
            state = fused_ops.fused_superstep(
                graph, spec, cfg, depth, state, key,
                min(cfg.hops_per_launch, k - ran), block, cache=cached)
            t = clock.now()
            more, supersteps = fused_ops.progress(block)   # per launch
            sync_s += clock.now() - t
            ran = supersteps - first
        return Chunk(state, ran, sync_s)

    def run_supersteps(graph: CSRGraph, state: StreamState, key, k: int,
                       block=None) -> Chunk:
        key = tuple(int(x) for x in key)
        if cfg.step_impl == "fused":
            return run_fused(graph, state, key, k, block)
        ran, sync_s = 0, 0.0
        while ran < k:
            t = clock.now()
            more = bool(_work_left(state))   # once per superstep
            sync_s += clock.now() - t
            if not more:
                break
            state = _count_launch(_superstep(graph, spec, cfg, key, depth,
                                             sample, state))
            ran += 1
        return Chunk(state, ran, sync_s)

    return run_supersteps


def build_engine(spec: SamplerSpec, cfg: EngineConfig, cache=None):
    """Build ``run(graph, start_vertices, key) -> (WalkResult, Drain)``: the
    closed system, draining a fixed query batch to completion on the
    graph's device with :func:`make_superstep_runner` (never past
    ``max_supersteps``).  ``key`` is a base key pair (`rng.stream_key`);
    ``cache`` is the graph-specific hot-vertex cache from
    :func:`maybe_build_cache` (ignored by the per-hop impls).
    """
    if cfg.step_impl == "fused":
        from repro_torch.kernels.fused_superstep import ops as fused_ops
    runner = make_superstep_runner(spec, cfg, cache=cache)
    depth = _stage_depth(cfg)

    def run(graph: CSRGraph, start_vertices: torch.Tensor, key):
        t0 = clock.now()
        device = graph.device
        sv = start_vertices.to(device=device, dtype=torch.int32)
        if sv.shape[0] == 0:
            paths, lengths = _fresh_buffers(cfg, 0, device)
            return (WalkResult(paths=paths, lengths=lengths,
                               stats=zero_stats(device)),
                    Drain(clock.now() - t0, 0.0))
        state, block = init_state(cfg, depth, sv), None
        if cfg.step_impl == "fused":
            state, block = fused_ops.pack(state)   # the drain's control block
        state, supersteps, sync_s = runner(graph, state, key,
                                           cfg.max_supersteps, block)
        if supersteps == cfg.max_supersteps and device.type == "cuda":
            # May have ended without a read: wait for this drain's own
            # stream, not the whole card.
            torch.cuda.current_stream(device).synchronize()
        result = WalkResult(paths=state.paths, lengths=state.lengths,
                            stats=state.stats)
        return result, Drain(clock.now() - t0, sync_s)

    return run


def make_engine(spec: SamplerSpec, cfg: EngineConfig):
    """Deprecated alias for :func:`build_engine` — prefer
    ``repro_torch.walker.compile(program).run(...)``."""
    warnings.warn(
        "make_engine is deprecated; use repro_torch.walker.compile(program)"
        ".run(graph, starts) (or build_engine when extending the engine)",
        DeprecationWarning, stacklevel=2)
    return build_engine(spec, cfg)


def _run_walks(graph: CSRGraph, start_vertices, spec: SamplerSpec,
               cfg: EngineConfig | None = None, seed=0) -> WalkResult:
    """One-shot closed-system run (engine-internal reference path)."""
    cfg = cfg or EngineConfig()
    sv = torch.as_tensor(np.asarray(start_vertices, dtype=np.int32))
    run = build_engine(spec, cfg, cache=maybe_build_cache(spec, cfg, graph))
    result, _ = run(graph, sv, task_rng.stream_key(seed))
    return result


def run_walks(graph: CSRGraph, start_vertices, spec: SamplerSpec,
              cfg: EngineConfig | None = None, seed=0) -> WalkResult:
    """Deprecated convenience one-shot API — prefer
    ``repro_torch.walker.compile(program).run(graph, starts)``."""
    warnings.warn(
        "run_walks is deprecated; use repro_torch.walker.compile(program)"
        ".run(graph, starts)",
        DeprecationWarning, stacklevel=2)
    return _run_walks(graph, start_vertices, spec, cfg, seed)
