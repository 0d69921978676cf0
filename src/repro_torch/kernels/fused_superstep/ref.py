"""Plain PyTorch version of the fused superstep kernel.

It is the per-hop engine's own superstep, run up to ``k`` times in one
"launch": what the CPU runs for ``step_impl="fused"``, and what the CUDA
kernel is held against on the card.

With a hot-vertex cache it adds each superstep's three cache counters
(:func:`cache_counts`) before running the superstep; the superstep itself
reads the graph, since the cache's packed block is a verbatim copy of the
graph's rows and so a cached read returns the same value.
"""
from __future__ import annotations

import torch

from repro_torch.core import walk_engine as engine
from repro_torch.core.phase_program import make_sampler


def cache_counts(v_curr, active, hot_ids, num_vertices):
    """(hits, misses, coalesced) of one superstep of the gather hierarchy
    over the lanes ``v_curr`` (W,), as the reference's
    ``_cached_row_access`` counts them.

    Every lane, idle ones included, takes ``vv = clamp(v_curr, 0, V-1)``
    and tag slot ``vv mod W``; the lane that keeps a slot is the smallest
    lane index that maps there.  Lane i is a *follower* iff that lane is
    not i and holds the same ``vv``; otherwise it leads, and its probe of
    the sorted ``hot_ids`` hits or misses.  Only lanes live at the
    superstep's start (``active``) are counted: leaders that hit, leaders
    that miss, and followers.  Returns three 0-dim int64 tensors."""
    W = v_curr.shape[0]
    lane = torch.arange(W, device=v_curr.device)
    vv = torch.clamp(v_curr, 0, num_vertices - 1).long()
    slot = vv % W
    first = torch.full((W,), W, dtype=torch.int64, device=v_curr.device)
    first = first.scatter_reduce(0, slot, lane, "amin")
    lead = first[slot]
    follower = (lead != lane) & (vv[lead] == vv)
    H = hot_ids.shape[0]
    pos = torch.searchsorted(hot_ids.long(), vv)
    hit = (pos < H) & (hot_ids[torch.clamp(pos, max=H - 1)].long() == vv)
    live = active.bool()
    leader = live & ~follower
    return ((leader & hit).sum(), (leader & ~hit).sum(),
            (live & follower).sum())


def fused_superstep_ref(graph, spec, cfg, depth, state, key, k, hot_ids=None):
    """Run the plain ``_superstep`` while work is left and fewer than ``k``
    have run, then count exactly one launch (not one per superstep).
    ``hot_ids`` is the sorted hot-vertex list of a cache (or ``None`` for
    none): each superstep then first adds its :func:`cache_counts`.

    Returns the new state; the path buffers are written in place, as the
    plain superstep writes them.
    """
    sample = make_sampler(spec)
    for _ in range(k):
        if not bool(engine._work_left(state)):
            break
        if hot_ids is not None:
            hits, misses, coal = cache_counts(state.slots.v_curr,
                                              state.slots.active, hot_ids,
                                              graph.num_vertices)
            st = state.stats
            state = state._replace(stats=st._replace(
                cache_hits=st.cache_hits + hits,
                cache_misses=st.cache_misses + misses,
                cache_coalesced=st.cache_coalesced + coal))
        state = engine._superstep(graph, spec, cfg, key, depth, sample, state)
    return engine._count_launch(state)
