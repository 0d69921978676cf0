"""Vertex partitioning across shards (paper §IV-A/B).

The paper randomly partitions the CSR across HBM channels and encodes the
owning channel in each ``RP_entry``.  Here the channels are the shards of
the sharded backend: vertex v is owned by shard ``v % N`` (random-ish for
RMAT ids, as the paper's random partitioning), and each shard stores the
row pointers *and* neighbor lists of the vertices it owns, at local row
``v // N``.  A vertex's row entry and its neighbor list live on the same
shard, so a hop routes once.

The shards are placed in groups (`repro_torch.distributed.mesh.Mesh`):
group g holds the consecutive shards from ``g · N / G``, stacked along a
leading axis on the mesh's device g.  With one group (the graph's device,
the default) N shards are the paper's N pipelines on one card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.distributed.mesh import Mesh, check_devices

_ARRAYS = ("row_ptr", "col", "weights", "alias_prob", "alias_idx",
           "type_offsets")


class ShardGroup(NamedTuple):
    """The ``n`` consecutive shards from ``first_shard`` of a partition,
    stacked on one device; leading axis = shard (channel).

    row_ptr: (n, V_loc+1) int32  — per-shard local row pointers.
    col:     (n, E_loc)   int32  — neighbor lists (global vertex ids), padded.
    weights/alias_prob/alias_idx: optional per-edge payloads, same layout
        (padding: weight and accept probability 1, alias index 0).
    type_offsets: (n, V_loc, T+1) int32 or None — per-owned-vertex MetaPath
        sub-segment offsets (segment-relative, so they shard with the
        vertex: the values are copied verbatim from the global table).
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    weights: Optional[torch.Tensor]
    alias_prob: Optional[torch.Tensor]
    alias_idx: Optional[torch.Tensor]
    type_offsets: Optional[torch.Tensor]
    first_shard: int


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """N per-shard CSR shards in ``groups`` (:class:`ShardGroup`), one a
    device.  With one group, ``row_ptr`` … ``type_offsets`` are its
    stacked ``(N, ...)`` arrays; with more, read them per group."""

    groups: tuple
    num_vertices: int = 0
    num_devices: int = 1
    vertices_per_device: int = 0
    max_degree: int = 0

    @property
    def devices(self) -> tuple:
        """One device a group."""
        return tuple(g.row_ptr.device for g in self.groups)

    @property
    def device(self) -> torch.device:
        """The device of a one-group partition (raises for more groups)."""
        return self._whole("row_ptr").device

    def _whole(self, name: str):
        if len(self.groups) > 1:
            raise ValueError(f"the partition spans {len(self.groups)} "
                             f"devices; read {name} per group (.groups)")
        return getattr(self.groups[0], name)

    row_ptr = property(lambda self: self._whole("row_ptr"))
    col = property(lambda self: self._whole("col"))
    weights = property(lambda self: self._whole("weights"))
    alias_prob = property(lambda self: self._whole("alias_prob"))
    alias_idx = property(lambda self: self._whole("alias_idx"))
    type_offsets = property(lambda self: self._whole("type_offsets"))


def owner_of(v: torch.Tensor, num_devices: int) -> torch.Tensor:
    """The shard that owns vertex ``v`` (0 for the -1 of an idle lane)."""
    return torch.where(v >= 0, v % num_devices, 0)


def local_id(v: torch.Tensor, num_devices: int) -> torch.Tensor:
    """Row of vertex ``v`` in its owner's per-vertex arrays."""
    return torch.where(v >= 0, v // num_devices, 0)


def _host(x: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if x is None else x.cpu().numpy()


def partition_graph(g, num_devices: int,
                    mesh: Optional[Mesh] = None) -> PartitionedGraph:
    """Shard a CSRGraph into N per-shard sub-CSRs (host numpy, vectorized),
    placed on the graph's device, or, given a ``mesh`` of N shards, each
    group's shards on the mesh's device for it.  The numbers do not
    depend on the placement."""
    N = int(num_devices)
    if N <= 0:
        raise ValueError(f"num_devices must be positive, got {num_devices}")
    if mesh is not None and mesh.num_shards != N:
        raise ValueError(f"the mesh has {mesh.num_shards} shards, the "
                         f"partition {N}")
    devices = (check_devices(mesh.devices) if mesh is not None
               else (g.row_ptr.device,))
    rp = _host(g.row_ptr).astype(np.int64)
    col = _host(g.col)
    w, ap, ai = _host(g.weights), _host(g.alias_prob), _host(g.alias_idx)
    to = _host(getattr(g, "type_offsets", None))

    V = int(g.num_vertices)
    v_per_dev = (V + N - 1) // N
    deg = np.diff(rp)

    # Per-shard local degree table, padded to v_per_dev vertices: vertex v
    # sits at (v % N, v // N).
    v = np.arange(V)
    local_deg = np.zeros((N, v_per_dev), dtype=np.int64)
    local_deg[v % N, v // N] = deg
    local_rp = np.zeros((N, v_per_dev + 1), dtype=np.int64)
    np.cumsum(local_deg, axis=1, out=local_rp[:, 1:])

    e_max = max(int(local_rp[:, -1].max()) if V else 0, 1)
    # Each edge e of source s moves to shard s % N at the local segment
    # start of s plus its offset within s's segment.
    src = np.repeat(v, deg)
    e = np.arange(src.size)
    shard = src % N
    pos = local_rp[shard, src // N] + (e - rp[src])

    def spread(x, fill, dtype):
        if x is None:
            return None
        out = np.full((N, e_max), fill, dtype=dtype)
        out[shard, pos] = x
        return out

    local_col = spread(col, 0, np.int32)
    local_w = spread(w, 1.0, np.float32)
    local_ap = spread(ap, 1.0, np.float32)
    local_ai = spread(ai, 0, np.int32)
    # Type offsets are segment-relative, so the owned rows shard verbatim
    # (this is what lets MetaPath run as a first-order hop).
    local_to = None
    if to is not None:
        local_to = np.zeros((N, v_per_dev, to.shape[1]), dtype=np.int32)
        local_to[v % N, v // N] = to

    arrays = dict(zip(_ARRAYS, ((local_rp, torch.int32),
                                (local_col, torch.int32),
                                (local_w, torch.float32),
                                (local_ap, torch.float32),
                                (local_ai, torch.int32),
                                (local_to, torch.int32))))
    n = N // len(devices)

    def group(i, dev):
        rows = slice(i * n, (i + 1) * n)
        return ShardGroup(**{
            k: None if x is None else torch.tensor(x[rows], dtype=dt,
                                                   device=dev)
            for k, (x, dt) in arrays.items()}, first_shard=i * n)

    return PartitionedGraph(
        groups=tuple(group(i, d) for i, d in enumerate(devices)),
        num_vertices=V,
        num_devices=N,
        vertices_per_device=v_per_dev,
        max_degree=int(g.max_degree),
    )
