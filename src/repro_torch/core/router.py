"""Data-aware task routing (paper §V-C: Task Router, butterfly interconnect).

Each superstep, every live task must reach the shard that owns the data its
next phase reads.  The paper's routing + backpressure, with fixed shapes
and no loss:

  * each shard's slot pool is ``[receive region (N·K) | retention (R)]``;
  * tasks are packed into per-destination buckets of capacity ``K`` (the
    receive region of the destination) via one stable sort on (destination,
    priority) — the O(1)-per-task Dispatcher/Merger cascade of §VI-C
    collapses into a vectorized rank computation;
  * bucket overflow (short-lived load skew, §IV-A) goes to the *retention*
    region and re-routes next superstep with **priority over fresh tasks**
    — the paper's Task Merger policy of prioritizing in-flight queries
    (§VI-C module 2);
  * retention overflow is dropped only if R is exhausted, and counted
    (``drops`` must be 0; capacity is provisioned by
    `scheduler.routing_capacity`, the Theorem VI.1 margin).

`pack_buckets` takes one shard's lanes ``(S, ...)`` or one group's shards'
lanes stacked ``(n, S, ...)``; the exchange is the mesh's tiled
all-to-all across the groups (`repro_torch.distributed.mesh`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tasks import WalkerSlots
from repro_torch.distributed import mesh


class RouteResult(NamedTuple):
    send: object            # (..., N*K) bucketed tasks, qid=-1 where empty
    retention: object       # (..., R) overflow tasks retained locally
    waits: torch.Tensor     # (...) — tasks that must wait a superstep
    drops: torch.Tensor     # (...) — tasks lost (must be 0)


def _empty_like(slots, lead: tuple, n: int):
    """Generic empty task tuple of ``n`` lanes: int fields -1 (qid = -1 is a
    free lane), bools False, floats 0 — for every task word."""
    def empty_field(f):
        shape = lead + (n,) + f.shape[len(lead) + 1:]
        if f.dtype == torch.bool:
            return torch.zeros(shape, dtype=torch.bool, device=f.device)
        if f.dtype.is_floating_point:
            return torch.zeros(shape, dtype=f.dtype, device=f.device)
        return torch.full(shape, -1, dtype=f.dtype, device=f.device)
    return type(slots)(*(empty_field(f) for f in slots))


def _scatter_slots(dst, idx: torch.Tensor, src, keep: torch.Tensor):
    """Scatter src lanes into dst at idx where keep.  ``dst`` is built one
    lane wider; the spare last lane absorbs the lanes not kept and is cut
    off (the reference's out-of-bounds drop)."""
    n = dst[0].shape[1] - 1
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    idx = torch.where(keep, idx, n).long()
    out = []
    for d, s in zip(dst, src):
        d[rows, idx] = s
        out.append(d[:, :n])
    return type(dst)(*out)


def _gather_slots(slots, order: torch.Tensor):
    rows = torch.arange(order.shape[0], device=order.device)[:, None]
    return type(slots)(*(f[rows, order] for f in slots))


def pack_buckets(slots: WalkerSlots, dest: torch.Tensor,
                 priority: torch.Tensor, num_devices: int, bucket_cap: int,
                 retention_cap: int) -> RouteResult:
    """Pack live tasks into per-destination buckets + retention overflow.

    dest:     (S,) or (N, S) destination shard of each lane (ignored if
              idle).
    priority: like ``dest`` (or broadcastable to it) — lower routes first
              (retained tasks use 0).
    """
    batched = dest.dim() == 2
    if not batched:
        slots = type(slots)(*(f[None] for f in slots))
        dest = dest[None]
    N, K, R = num_devices, bucket_cap, retention_cap
    B, S = dest.shape
    dev = dest.device
    valid = slots.active
    dest_s = torch.where(valid, dest, N).to(torch.int64)  # idle lanes last
    # One stable sort on the composite key (destination, priority) orders
    # lanes as the reference's lexsort: ties keep lane order.
    prio = torch.broadcast_to(priority, dest.shape).to(torch.int64)
    order = torch.sort((dest_s << 32) | (prio + (1 << 31)), dim=1,
                       stable=True).indices
    rows = torch.arange(B, device=dev)[:, None]
    d_sorted = dest_s[rows, order]
    v_sorted = valid[rows, order]
    sorted_slots = _gather_slots(slots, order)

    # Rank within each destination group (first occurrence via searchsorted).
    first = torch.searchsorted(d_sorted, d_sorted, side="left")
    pos = torch.arange(S, device=dev)[None, :] - first

    in_bucket = v_sorted & (pos < K) & (d_sorted < N)
    bucket_slot = d_sorted * K + pos
    send = _scatter_slots(_empty_like(slots, (B,), N * K + 1), bucket_slot,
                          sorted_slots, in_bucket)

    overflow = v_sorted & ~in_bucket & (d_sorted < N)
    ret_rank = torch.cumsum(overflow.to(torch.int64), 1) - 1
    ret_ok = overflow & (ret_rank < R)
    retention = _scatter_slots(_empty_like(slots, (B,), R + 1), ret_rank,
                               sorted_slots, ret_ok)

    waits = overflow.sum(1)
    drops = (overflow & ~ret_ok).sum(1)
    if not batched:
        send = type(send)(*(f[0] for f in send))
        retention = type(retention)(*(f[0] for f in retention))
        waits, drops = waits[0], drops[0]
    return RouteResult(send=send, retention=retention, waits=waits,
                       drops=drops)


def exchange(sends, axis_name: str = "ch"):
    """The butterfly hop: all-to-all the send buffers so bucket d of every
    shard lands on shard d.  ``sends`` holds each shard group's (n, N·K)
    buffers (one group: the stacked (N, N·K) buffers), and each group gets
    its incoming buckets back on its device.  Fixed shapes; one collective
    a task field per superstep.  ``axis_name`` is the mesh's (kept for the
    reference's signature; the shard axis is the leading one)."""
    fields = [mesh.all_to_all(list(f)) for f in zip(*sends)]
    return [type(sends[0])(*f) for f in zip(*fields)]
