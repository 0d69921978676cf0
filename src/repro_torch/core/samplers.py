"""Sampler definitions and their shared arithmetic.

:class:`SamplerSpec` is the host-programmable configuration of the
sampling module (p, q, α, mode bits).  A spec lowers into a phase program
(`repro_torch.core.phase_program`) that the engine executes.

| GRW            | weighted | sampler            |
|----------------|----------|--------------------|
| URW, PPR       | no       | uniform            |
| DeepWalk       | yes      | alias (Walker)     |
| Node2Vec       | no       | rejection          |
| Node2Vec       | yes      | reservoir (E-S)    |
| MetaPath       | either   | typed uniform      |

What follows the spec is the arithmetic the executors and the fused
kernel share: index picking, adjacency bisection, the Node2Vec (p, q)
bias and the Efraimidis–Spirakis chunk fold, held to the reference's by
``tests/test_torch_node2vec.py``.  All of it is bit-equal but the E-S
key, whose float32 log differs in the last bit between XLA, torch's CPU
kernel and CUDA's ``logf`` (the key, after the division, by up to 2
ulps): paths can differ only where two keys of one lane-hop lie that
close.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

# Sampler kinds with a phase-program lowering (`phase_program.lower`).
KINDS = ("uniform", "alias", "rejection_n2v", "reservoir_n2v", "metapath")


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Static configuration of the sampling module.

    Validation happens at construction: a malformed spec (unknown kind,
    empty MetaPath schedule, non-positive Node2Vec parameters) fails here
    with an actionable message."""

    kind: str = "uniform"   # uniform|alias|rejection_n2v|reservoir_n2v|metapath
    p: float = 1.0          # Node2Vec return parameter
    q: float = 1.0          # Node2Vec in-out parameter
    stop_prob: float = 0.0  # PPR teleport/termination probability α
    rejection_rounds: int = 12
    reservoir_chunk: int = 64
    adaptive_chunks: "bool | str" = "auto"
    metapath: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown sampler kind: {self.kind!r} (one of {KINDS})")
        if not isinstance(self.metapath, tuple):
            # Specs stay hashable (lowering is cached on the frozen spec).
            object.__setattr__(self, "metapath",
                               tuple(int(t) for t in self.metapath))
        if self.kind == "metapath":
            if not self.metapath:
                raise ValueError(
                    "metapath samplers need a non-empty edge-type schedule "
                    "(pass metapath=(t0, t1, ...))")
            if any(int(t) < 0 for t in self.metapath):
                raise ValueError(
                    f"metapath schedule entries are edge-type ids and must "
                    f"be non-negative, got {self.metapath}")
        if not 0.0 <= self.stop_prob <= 1.0:
            raise ValueError(
                f"stop_prob must be a probability in [0, 1], got "
                f"{self.stop_prob}")
        if self.second_order and (self.p <= 0 or self.q <= 0):
            raise ValueError(
                f"Node2Vec parameters must be positive, got p={self.p} "
                f"q={self.q}")
        if self.rejection_rounds <= 0:
            raise ValueError(
                f"rejection_rounds must be positive, got "
                f"{self.rejection_rounds}")
        if self.reservoir_chunk <= 0:
            raise ValueError(
                f"reservoir_chunk must be positive, got "
                f"{self.reservoir_chunk}")
        if self.adaptive_chunks not in (True, False, "auto"):
            raise ValueError(
                f"adaptive_chunks must be True, False, or 'auto', got "
                f"{self.adaptive_chunks!r}")

    @property
    def second_order(self) -> bool:
        return self.kind in ("rejection_n2v", "reservoir_n2v")


def _uniform_index(deg: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """index = min(floor(u * deg), deg-1) in float32; safe for deg == 0."""
    idx = torch.floor(u * deg.to(u.dtype)).to(torch.int32)
    return torch.minimum(torch.clamp(idx, min=0), torch.clamp(deg - 1, min=0))


def bisect_iters(max_degree: int) -> int:
    """Static trip count of the adjacency bisection: enough halvings to
    converge on a neighbor list of ``max_degree`` entries.  The fused
    kernel takes the same count from here."""
    return max(1, int(math.ceil(math.log2(max(int(max_degree), 2) + 1))))


def n2v_constants(spec: SamplerSpec) -> Tuple[float, float, float]:
    """``(1/p, 1/q, w_max)`` rounded once to float32 (and held in Python
    floats that float32 represents exactly), as the reference's weak-typed
    Python scalars enter its float32 arithmetic.  ``w_max`` is the
    largest bias, ``max(1/p, 1, 1/q)``."""
    inv_p, inv_q = 1.0 / spec.p, 1.0 / spec.q
    return tuple(float(np.float32(x))
                 for x in (inv_p, inv_q, max(inv_p, 1.0, inv_q)))


def _col_at(g, e: torch.Tensor) -> torch.Tensor:
    """``col`` at the edge offsets ``e``, clipped into range (E > 0)."""
    return g.col[torch.clamp(e, 0, g.num_edges - 1).long()]


def vertex_row(g, v: torch.Tensor) -> torch.Tensor:
    """The row of vertex ``v`` in ``g``'s per-vertex arrays (``row_ptr``,
    ``type_offsets``); negative and out-of-range ids clamp to a valid row
    (callers mask validity).  The identity on a `CSRGraph`; on the sharded
    engine's stacked view of a group (`core.distributed.LocalView`, whose
    shards lie end to end) it is the owner's block ``(v % N -
    first_shard) · rows_per_shard`` plus the local row ``v // N``, so one
    expression serves every shard of the group.  A vertex another group
    owns clamps into this group's blocks: its lane's reads are masked, but
    an index past the arrays would fault on the card."""
    v = torch.where(v >= 0, v, 0)
    shards = getattr(g, "num_shards", 0)
    if shards:
        local = torch.clamp(v // shards, 0, g.rows_per_shard - 2)
        block = v % shards
        if g.group_shards < shards:
            block = torch.clamp(block - g.first_shard, 0,
                                g.group_shards - 1)
        return block * g.rows_per_shard + local
    return torch.clamp(v, 0, g.num_vertices - 1)


def edge_exists(g, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Is ``dst`` in ``src``'s (sorted) neighbor list?  Lower-bound
    bisection with the static trip count :func:`bisect_iters`; ``src``
    broadcasts against ``dst``'s leading dims.  False where ``src < 0``;
    a graph with no edges has no column to read, and no edge."""
    while src.dim() < dst.dim():
        src = src[..., None]
    if g.num_edges == 0:
        return torch.zeros(dst.shape, dtype=torch.bool, device=dst.device)
    row = vertex_row(g, src).long()
    lo = g.row_ptr[row].expand(dst.shape)
    hi0 = g.row_ptr[row + 1].expand(dst.shape)
    hi = hi0
    for _ in range(bisect_iters(g.max_degree)):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = _col_at(g, mid) < dst
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    found = (lo < hi0) & (_col_at(g, lo) == dst)
    return found & (src >= 0).expand(dst.shape)


def n2v_bias(spec: SamplerSpec, g, v_prev: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Node2Vec bias (float32): 1/p if returning to ``v_prev``, 1 if ``y``
    is a neighbor of ``v_prev``, 1/q otherwise; 1 at hop 0
    (``v_prev < 0``)."""
    inv_p, inv_q, _ = n2v_constants(spec)
    vp = v_prev if y.dim() == v_prev.dim() else v_prev[..., None]

    def full(x):
        return torch.full(y.shape, x, dtype=torch.float32, device=y.device)
    common = edge_exists(g, v_prev, y)
    w = torch.where(y == vp, full(inv_p),
                    torch.where(common, full(1.0), full(inv_q)))
    return torch.where((vp < 0).expand(y.shape), full(1.0), w)


def rejection_choose(spec: SamplerSpec, u_acc: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Bounded-round rejection: round j accepts iff
    ``u_acc[j] · w_max <= w[j]`` (one float32 product); the last round is
    forced and the first accepted round wins.  Returns the winning round
    per lane (int64)."""
    accept = (u_acc * n2v_constants(spec)[2] <= w).to(torch.int8)
    accept[:, -1] = 1
    return torch.argmax(accept, dim=1)   # the first maximum, as in jnp


def es_chunk_score(u: torch.Tensor, valid: torch.Tensor, w: torch.Tensor):
    """Efraimidis–Spirakis chunk scoring: key = log(u + 1e-20) / w (the
    log of u^(1/w)) where valid and w > 0, else -inf; returns the
    within-chunk (first argmax, max)."""
    key = torch.where(valid & (w > 0), torch.log(u + 1e-20) / w,
                      torch.full_like(u, -math.inf))
    c_best = torch.argmax(key, dim=1)
    return c_best, key.gather(1, c_best[:, None])[:, 0]


def es_merge(best_key, best_idx, chunk_index, chunk_size, c_best, c_key):
    """Fold one chunk's (argmax, max) into the running reservoir maximum;
    strict > keeps the earliest chunk on ties."""
    take = c_key > best_key
    best_idx = torch.where(take,
                           chunk_index * chunk_size + c_best.to(torch.int32),
                           best_idx)
    return torch.maximum(best_key, c_key), best_idx


def es_num_chunks(max_degree: int, chunk: int) -> int:
    return max(1, -(-int(max_degree) // chunk))
