"""Compressed Sparse Row graph on a torch device.

``row_ptr[v]`` is the offset of v's neighbor list in ``col`` and
``row_ptr[v+1]-row_ptr[v]`` its degree.  Optional per-edge payloads
(weights, alias tables, edge types) extend the layout for weighted and
typed walks.  ``row_ptr``/``col`` are int32, as the kernels read them.

The graph lives where its tensors live; every builder takes ``device``,
whose default ``None`` means ``"cuda"`` — a build without a card raises
instead of quietly landing on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' explicitly to build "
            "the graph on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """CSR graph.

    Attributes:
      row_ptr:  (V+1,) int32 — neighbor-list offsets into ``col``.
      col:      (E,)   int32 — neighbor vertex ids.
      weights:  (E,)   float32 or None — edge weights.
      alias_prob: (E,) float32 or None — Walker alias-table accept prob.
      alias_idx:  (E,) int32  or None — Walker alias-table alias index.
      edge_type:  (E,) int32  or None — edge type id.
      type_offsets: (V, T+1) int32 or None — per-vertex sub-segment offsets
        into the (type-sorted) neighbor list.
      num_vertices / num_edges / max_degree / num_edge_types: host ints.
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    weights: Optional[torch.Tensor] = None
    alias_prob: Optional[torch.Tensor] = None
    alias_idx: Optional[torch.Tensor] = None
    edge_type: Optional[torch.Tensor] = None
    type_offsets: Optional[torch.Tensor] = None
    num_vertices: int = 0
    num_edges: int = 0
    max_degree: int = 0
    num_edge_types: int = 0

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def weighted(self) -> bool:
        return self.weights is not None

    @property
    def has_alias(self) -> bool:
        return self.alias_prob is not None

    @property
    def typed(self) -> bool:
        return self.edge_type is not None


_TENSOR_FIELDS = {"row_ptr": torch.int32, "col": torch.int32,
                  "weights": torch.float32, "alias_prob": torch.float32,
                  "alias_idx": torch.int32, "edge_type": torch.int32,
                  "type_offsets": torch.int32}
_SCALAR_FIELDS = ("num_vertices", "num_edges", "max_degree", "num_edge_types")


def _on(x: Optional[np.ndarray], dtype, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def build_csr(
    edges: np.ndarray,
    num_vertices: int,
    weights: Optional[np.ndarray] = None,
    edge_types: Optional[np.ndarray] = None,
    num_edge_types: int = 0,
    dedup: bool = True,
    sort_neighbors: bool = True,
    device=None,
) -> CSRGraph:
    """Build a CSRGraph from an (E, 2) int edge array (src, dst).

    Neighbor lists are sorted by (edge_type, dst), so typed sub-segments
    are contiguous and adjacency can be bisected.
    """
    device = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64)
    if edges.size == 0:
        edges = edges.reshape(0, 2)
    src, dst = edges[:, 0], edges[:, 1]
    w = None if weights is None else np.asarray(weights, dtype=np.float32)
    et = None if edge_types is None else np.asarray(edge_types, dtype=np.int32)

    if dedup and edges.shape[0] > 0:
        key = src * num_vertices + dst
        if et is not None:
            key = key * max(num_edge_types, 1) + et
        _, keep = np.unique(key, return_index=True)
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
        if et is not None:
            et = et[keep]

    if sort_neighbors and src.size:
        t = et if et is not None else np.zeros_like(src)
        order = np.lexsort((dst, t, src))
        src, dst = src[order], dst[order]
        if w is not None:
            w = w[order]
        if et is not None:
            et = et[order]

    deg = np.bincount(src, minlength=num_vertices).astype(np.int64)
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])

    type_offsets = None
    if et is not None and num_edge_types > 0:
        counts = np.zeros((num_vertices, num_edge_types), dtype=np.int64)
        np.add.at(counts, (src, et), 1)
        type_offsets = np.zeros((num_vertices, num_edge_types + 1),
                                dtype=np.int32)
        np.cumsum(counts, axis=1, out=type_offsets[:, 1:])

    return CSRGraph(
        row_ptr=_on(row_ptr, torch.int32, device),
        col=_on(dst, torch.int32, device),
        weights=_on(w, torch.float32, device),
        edge_type=_on(et, torch.int32, device),
        type_offsets=_on(type_offsets, torch.int32, device),
        num_vertices=int(num_vertices),
        num_edges=int(src.size),
        max_degree=int(deg.max()) if deg.size else 0,
        num_edge_types=int(num_edge_types),
    )


def from_reference_arrays(arrays: Mapping[str, np.ndarray],
                          device=None) -> CSRGraph:
    """A CSRGraph from the reference graph's fields as numpy arrays: the
    tensor fields (``row_ptr``, ``col`` and the optional payloads, absent or
    None when the graph lacks them) and the scalar fields."""
    device = resolve_device(device)
    fields = {name: _on(None if arrays.get(name) is None
                        else np.asarray(arrays[name]), dtype, device)
              for name, dtype in _TENSOR_FIELDS.items()}
    fields.update({name: int(np.asarray(arrays[name]))
                   for name in _SCALAR_FIELDS if name in arrays})
    return CSRGraph(**fields)


def degrees(g: CSRGraph) -> torch.Tensor:
    return g.row_ptr[1:] - g.row_ptr[:-1]


def row_access(g: CSRGraph, v: torch.Tensor):
    """{addr, deg} = row_access(v); out-of-range v (an idle lane's
    sentinel) maps to degree 0."""
    v_safe = torch.clamp(v, 0, g.num_vertices - 1).long()
    addr = g.row_ptr[v_safe]
    deg = g.row_ptr[v_safe + 1] - addr
    deg = torch.where((v >= 0) & (v < g.num_vertices), deg, 0)
    return addr, deg


def column_access(g: CSRGraph, addr: torch.Tensor,
                  index: torch.Tensor) -> torch.Tensor:
    """v_next = col[addr + index], the edge offset clipped into range.
    A graph with no edges has no column to read: every lane gets -1."""
    if g.num_edges == 0:
        return torch.full_like(addr, -1)
    e = torch.clamp(addr + index, 0, g.num_edges - 1)
    return g.col[e.long()]


def validate_csr(g: CSRGraph) -> None:
    """Raise ValueError unless ``g`` is a well-formed CSR graph."""
    rp = g.row_ptr.cpu().numpy()
    col = g.col.cpu().numpy()
    problems = []
    if rp.shape != (g.num_vertices + 1,):
        problems.append(f"row_ptr shape {rp.shape} != ({g.num_vertices + 1},)")
    elif rp[0] != 0 or rp[-1] != g.num_edges:
        problems.append("row_ptr must start at 0 and end at num_edges")
    elif np.any(np.diff(rp) < 0):
        problems.append("row_ptr must be monotone")
    if g.num_edges and (col.min() < 0 or col.max() >= g.num_vertices):
        problems.append("col holds ids outside [0, num_vertices)")
    if g.typed and g.type_offsets is not None and not problems:
        to = g.type_offsets.cpu().numpy()
        if np.any(to[:, -1] != np.diff(rp)):
            problems.append("type offsets must cover each segment")
    if problems:
        raise ValueError("invalid CSR graph: " + "; ".join(problems))
