"""Sparse embedding substrate for recsys, the reference's
``repro.models.recsys.embedding``.

:func:`lookup` gathers one row a field through ``layers.gather_rows`` (the
embedding-bag kernel; its backward on the segment-sum kernel), ids
clipped into the table as the reference clips them.  :func:`lookup_bags`
sums multi-hot bags: on the port's ``kernels.embedding_bag`` with
``use_kernel=True`` (forward only, the serving path), else the
reference's masked sum.  Tables are drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    vocab_sizes: tuple          # per-field vocabulary sizes
    embed_dim: int = 16
    combine: str = "concat"     # concat | sum


def init_tables(generator, cfg: EmbeddingConfig, dtype=torch.float32,
                device=None):
    return {
        f"table_{i}": L.normal(generator, (v, cfg.embed_dim), dtype,
                               device) * 0.01
        for i, v in enumerate(cfg.vocab_sizes)
    }


def lookup(tables, sparse_ids, cfg: EmbeddingConfig):
    """sparse_ids: (B, F) single-hot per field -> (B, F·D) or (B, D)."""
    outs = []
    for i in range(sparse_ids.shape[1]):
        t = tables[f"table_{i}"]
        ids = torch.clamp(sparse_ids[:, i], 0, t.shape[0] - 1)
        outs.append(L.gather_rows(t, ids))
    if cfg.combine == "sum":
        return sum(outs)
    return torch.cat(outs, dim=-1)


def lookup_bags(table, indices, weights=None, use_kernel: bool = False):
    """Multi-hot EmbeddingBag over one table: indices (B, H), pad -1."""
    if use_kernel:
        return embedding_bag(indices.to(torch.int32).contiguous(), table,
                             weights)
    safe = torch.clamp(indices, 0, table.shape[0] - 1).long()
    rows = table[safe]
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype,
                             device=table.device)
    w = torch.where(indices >= 0, weights,
                    torch.zeros((), dtype=weights.dtype,
                                device=weights.device))[..., None]
    return torch.sum(rows * w, dim=1)
