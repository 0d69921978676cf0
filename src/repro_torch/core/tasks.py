"""Stateless task / slot-pool structures.

Each walk query decomposes into stateless one-hop tasks.  The lane pool is
a structure of arrays: ``W`` lanes, each holding one task word; a lane is
either live (carrying a task) or free, and the zero-bubble scheduler keeps
every lane live whenever work exists.  ``epoch`` salts the RNG of a reused
query slot; a closed batch carries epoch 0 everywhere.

All state is NamedTuples of tensors on one device; the per-hop engine
replaces fields rather than mutating them, except the path buffers, and
the fused launch updates every field in place (see
``core/walk_engine.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class WalkerSlots(NamedTuple):
    """Slot pool of stateless walk tasks (all tensors shape (W,))."""

    v_curr: torch.Tensor    # int32 — the task's current vertex
    v_prev: torch.Tensor    # int32 — previous vertex; -1 if none
    query_id: torch.Tensor  # int32 — query id; -1 = free
    hop: torch.Tensor       # int32 — hop count
    active: torch.Tensor    # bool  — lane holds a live task
    epoch: torch.Tensor     # int32 — slot-reuse epoch (RNG salt)

    @property
    def width(self) -> int:
        return self.v_curr.shape[-1]


def empty_slots(width: int, device) -> WalkerSlots:
    def full(v):
        return torch.full((width,), v, dtype=torch.int32, device=device)
    return WalkerSlots(
        v_curr=full(-1), v_prev=full(-1), query_id=full(-1), hop=full(0),
        active=torch.zeros((width,), dtype=torch.bool, device=device),
        epoch=full(0))


class QueryQueue(NamedTuple):
    """Device-resident pending-query ring (the Theorem VI.1 queue).

    ``head`` is the next arrival to issue; ``staged`` is the injection
    watermark (arrivals at or past it have not yet arrived from the host;
    the feedback controller advances it); ``tail`` counts arrivals.  All
    three are monotone 0-dim counters with ``head <= staged <= tail``.
    ``order[i % capacity]`` is the query id of the i-th arrival (the
    identity in a closed batch); ``start_vertex`` and ``epoch`` are indexed
    by query id.
    """

    start_vertex: torch.Tensor  # (Q,) int32
    head: torch.Tensor          # 0-dim int64
    staged: torch.Tensor        # 0-dim int64
    tail: torch.Tensor          # 0-dim int64
    order: torch.Tensor         # (Q,) int32
    epoch: torch.Tensor         # (Q,) int32

    @property
    def capacity(self) -> int:
        return self.start_vertex.shape[-1]


def make_queue(start_vertices: torch.Tensor, staged: int | None = None,
               tail: int | None = None) -> QueryQueue:
    """A queue of the given start vertices, on their device."""
    sv = start_vertices.to(torch.int32)
    q = sv.shape[-1]
    tail = q if tail is None else tail
    staged = tail if staged is None else staged
    if tail > q:
        raise ValueError(
            f"tail={tail} exceeds the queue buffer capacity {q}; only "
            f"queries that fit in the buffer can have arrived")
    if staged > tail:
        raise ValueError(
            f"staged={staged} exceeds tail={tail}: the injection watermark "
            f"cannot run ahead of the queries that actually arrived "
            f"(invariant head <= staged <= tail <= capacity)")
    dev = sv.device

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)
    return QueryQueue(
        start_vertex=sv, head=scalar(0), staged=scalar(staged),
        tail=scalar(tail),
        order=torch.arange(q, dtype=torch.int32, device=dev),
        epoch=torch.zeros((q,), dtype=torch.int32, device=dev))


def empty_queue(capacity: int, device) -> QueryQueue:
    """Open-system ring on ``device``: room for ``capacity`` live queries,
    none arrived yet; slot ids are handed out by the host's free ring at
    injection."""
    def scalar():
        return torch.zeros((), dtype=torch.int64, device=device)
    return QueryQueue(
        start_vertex=torch.zeros((capacity,), dtype=torch.int32,
                                 device=device),
        head=scalar(), staged=scalar(), tail=scalar(),
        order=torch.arange(capacity, dtype=torch.int32, device=device),
        epoch=torch.zeros((capacity,), dtype=torch.int32, device=device))


class WalkStats(NamedTuple):
    """Utilization counters (0-dim int64 tensors, equal in value to the
    reference's int32 counters)."""

    steps: torch.Tensor         # total hops executed (visited vertices)
    slot_steps: torch.Tensor    # total lane-supersteps elapsed
    bubbles: torch.Tensor       # lane-supersteps with no live task
    starved: torch.Tensor       # idle lane-supersteps while upstream work
                                # existed (what Theorem VI.1 drives to 0)
    terminations: torch.Tensor  # completed queries
    supersteps: torch.Tensor    # wall supersteps executed
    route_waits: torch.Tensor   # sharded backend only (0 here)
    drops: torch.Tensor         # tasks lost to capacity overflow (0)
    launches: torch.Tensor      # device dispatches: one per superstep on
                                # the per-hop paths, one per launch of k
                                # supersteps on the fused path
    cache_hits: torch.Tensor    # live leader lanes whose v_curr probe hit
                                # the hot-vertex cache (fused + cache only)
    cache_misses: torch.Tensor  # live leader lanes whose probe missed
    cache_coalesced: torch.Tensor  # live lanes that shared another lane's
                                # gather because their v_curr coincided
                                # within the superstep (same-vertex
                                # coalescing); all three 0 with no cache

    def bubble_ratio(self):
        return self.bubbles / torch.clamp(self.slot_steps, min=1)

    def occupancy(self):
        return 1.0 - self.bubble_ratio()

    def cache_hit_rate(self):
        """Fraction of cache probes (leader gathers) served from the
        cache."""
        return self.cache_hits / torch.clamp(
            self.cache_hits + self.cache_misses, min=1)


def zero_stats(device) -> WalkStats:
    return WalkStats(*(torch.zeros((), dtype=torch.int64, device=device)
                       for _ in WalkStats._fields))


class WalkResult(NamedTuple):
    """Collected walk paths: paths[q, t] = t-th vertex of query q, -1 padded."""

    paths: torch.Tensor    # (Q, max_len) int32
    lengths: torch.Tensor  # (Q,) int32 — number of vertices recorded
    stats: WalkStats

    def as_numpy(self):
        return self.paths.cpu().numpy(), self.lengths.cpu().numpy()

