"""Hot-vertex adjacency cache: the on-chip tier of the gather hierarchy.

Power-law graphs concentrate most gather traffic on a handful of hub
vertices (a walking lane occupies a vertex with probability proportional
to its degree, so hubs are over-represented *quadratically*: once in the
stationary distribution and once in payload size).  This module is the
host-side builder of a small adjacency cache for them; the fused kernel
keeps the packed block in shared memory when it fits there, else reads
it from device memory (`repro_torch.kernels.fused_superstep.ops`).

:func:`build_hot_cache` packs the top-``H`` highest-degree vertices'
adjacency payloads — columns, plus whatever per-kind payloads the phase
program declares via ``PhaseProgram.cache_payloads`` (edge weights,
alias tables, typed sub-segment offsets) — into one contiguous block
with an id → slot lookup (binary search over the sorted hot-id list).
``H`` is sized from a byte budget, greedily admitting vertices in
descending-degree order (ties broken toward the smaller vertex id, so
the cache contents are a deterministic function of (graph, payloads,
budget)).

The packed arrays are *verbatim copies* of the graph's own CSR slices:
``col[hot_off[slot] + j] == graph.col[row_ptr[v] + j]`` for every hot
vertex ``v`` and offset ``j < deg(v)``.  That is the whole bit-identity
argument of the cached fused superstep — a hit reads the same bytes from
a different memory tier, so no sampled walk can change.

The builder is numpy on the host; it reads the graph's ``row_ptr`` whole
and gathers only the cached entries of the edge arrays from the graph's
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["HotVertexCache", "build_hot_cache", "edge_payload_bytes",
           "vertex_overhead_bytes"]

# Per-edge payload arrays the cache can pack (4 bytes per entry each).
_EDGE_PAYLOADS = ("col", "weights", "alias_prob", "alias_idx")


def edge_payload_bytes(payloads: Sequence[str]) -> int:
    """Bytes per cached *edge* for this payload set (4 per array)."""
    return 4 * sum(1 for p in payloads if p in _EDGE_PAYLOADS)


def vertex_overhead_bytes(payloads: Sequence[str],
                          num_edge_types: int = 0) -> int:
    """Bytes per cached *vertex*: id + degree + prefix offset, plus the
    per-vertex typed sub-segment row when ``type_offsets`` is packed."""
    fixed = 12  # hot_ids + hot_deg + hot_off, 4 bytes each
    if "type_offsets" in payloads:
        fixed += 4 * (max(int(num_edge_types), 0) + 1)
    return fixed


@dataclasses.dataclass(frozen=True)
class HotVertexCache:
    """The packed block plus its id → slot directory.

    ``hot_ids`` is sorted ascending so the kernel's probe is a
    ``ceil(log2(H+1))``-trip binary search; ``hot_off`` is the exclusive
    prefix sum of ``hot_deg`` — slot ``s``'s payload occupies
    ``[hot_off[s], hot_off[s+1])`` of every packed edge array.
    ``type_offsets`` rows are packed verbatim — the graph stores them
    *row-relative* (sub-segment ``t`` of vertex ``v`` spans
    ``[type_offsets[v, t], type_offsets[v, t + 1])`` within the row), so
    the same offsets index the cached row relative to ``hot_off[s]``
    exactly as they index the graph's row relative to ``row_ptr[v]``.
    """

    hot_ids: np.ndarray                 # (H,) int32, sorted ascending
    hot_deg: np.ndarray                 # (H,) int32
    hot_off: np.ndarray                 # (H + 1,) int32 exclusive prefix
    col: np.ndarray                     # (P,) int32 packed columns
    weights: Optional[np.ndarray]       # (P,) float32 or None
    alias_prob: Optional[np.ndarray]    # (P,) float32 or None
    alias_idx: Optional[np.ndarray]     # (P,) int32 or None
    type_offsets: Optional[np.ndarray]  # (H, T + 1) int32 (row-relative)
    payloads: Tuple[str, ...]           # payload set the block packs
    budget_bytes: int                   # the budget it was sized under

    @property
    def num_hot(self) -> int:
        return int(self.hot_ids.shape[0])

    @property
    def num_entries(self) -> int:
        """Packed edge-payload length P (>= 1; padded when all-zero)."""
        return int(self.col.shape[0])

    @property
    def probe_trips(self) -> int:
        """Trip count of the kernel's binary-search probe."""
        return max(1, int(math.ceil(math.log2(self.num_hot + 1))))

    def nbytes(self) -> int:
        """Actual bytes of the packed block (directory + payloads)."""
        total = self.hot_ids.nbytes + self.hot_deg.nbytes + self.hot_off.nbytes
        for arr in (self.col, self.weights, self.alias_prob, self.alias_idx,
                    self.type_offsets):
            if arr is not None:
                total += arr.nbytes
        return int(total)

    def slot_of(self, v: int) -> int:
        """Cache slot of vertex ``v``, or -1 on a miss (host-side mirror
        of the kernel probe — same binary search over the same array)."""
        s = int(np.searchsorted(self.hot_ids, v))
        if s < self.num_hot and int(self.hot_ids[s]) == int(v):
            return s
        return -1


def _pack_indices(row_ptr: np.ndarray, chosen: np.ndarray,
                  lens: np.ndarray, total: int) -> np.ndarray:
    """Edge indices of every cached entry, in slot-major order."""
    if total == 0:
        return np.zeros((0,), np.int64)
    starts = row_ptr[chosen].astype(np.int64)
    base = np.repeat(starts - np.concatenate(
        ([0], np.cumsum(lens)[:-1])).astype(np.int64), lens)
    return base + np.arange(total, dtype=np.int64)


def build_hot_cache(graph, payloads: Sequence[str],
                    budget_bytes: int) -> Optional[HotVertexCache]:
    """Pack the largest degree-descending vertex prefix that fits.

    Vertices are admitted in descending-degree order (smaller id wins a
    degree tie); each costs its per-vertex directory overhead plus
    ``deg(v)`` entries of every packed edge payload.  Returns ``None``
    when the budget does not admit even the top vertex — the caller
    treats that as "cache off".
    """
    budget = int(budget_bytes)
    if budget <= 0:
        return None
    payloads = tuple(payloads)
    row_ptr = graph.row_ptr.cpu().numpy()
    deg = (row_ptr[1:] - row_ptr[:-1]).astype(np.int64)
    nv = deg.shape[0]
    if nv == 0:
        return None
    # Descending degree, ascending id on ties (lexsort: last key primary).
    order = np.lexsort((np.arange(nv), -deg))
    per_edge = edge_payload_bytes(payloads)
    per_vert = vertex_overhead_bytes(payloads, graph.num_edge_types or 0)
    cost = per_vert + per_edge * deg[order]
    h = int(np.searchsorted(np.cumsum(cost), budget, side="right"))
    if h == 0:
        return None
    chosen = np.sort(order[:h]).astype(np.int64)
    hot_deg = deg[chosen]
    hot_off = np.concatenate(([0], np.cumsum(hot_deg))).astype(np.int32)
    total = int(hot_off[-1])
    idx = torch.from_numpy(_pack_indices(row_ptr, chosen, hot_deg, total))

    def pack(src, fill, dtype):
        out = np.full((max(total, 1),), fill, dtype)
        out[:total] = src[idx.to(src.device)].cpu().numpy().astype(dtype)
        return out

    col = pack(graph.col, 0, np.int32)
    # A payload is only packable when the graph actually carries the
    # source array (e.g. the reservoir program declares `weights` but an
    # unweighted graph scores every edge at 1 — nothing to cache).
    weights = (pack(graph.weights, 0.0, np.float32)
               if "weights" in payloads and graph.weights is not None
               else None)
    alias_prob = (pack(graph.alias_prob, 0.0, np.float32)
                  if "alias_prob" in payloads and graph.alias_prob is not None
                  else None)
    alias_idx = (pack(graph.alias_idx, 0, np.int32)
                 if "alias_idx" in payloads and graph.alias_idx is not None
                 else None)
    type_offsets = None
    if "type_offsets" in payloads and graph.type_offsets is not None:
        # Row-relative in the graph, row-relative in the cache: verbatim.
        rows = torch.from_numpy(chosen).to(graph.type_offsets.device)
        type_offsets = graph.type_offsets[rows].cpu().numpy().astype(np.int32)
    return HotVertexCache(
        hot_ids=chosen.astype(np.int32), hot_deg=hot_deg.astype(np.int32),
        hot_off=hot_off, col=col, weights=weights, alias_prob=alias_prob,
        alias_idx=alias_idx, type_offsets=type_offsets, payloads=payloads,
        budget_bytes=budget)
