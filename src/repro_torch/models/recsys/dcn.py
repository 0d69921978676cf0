"""DCN-v2 [arXiv:2008.13535]: cross network v2 + deep MLP (parallel
structure), n_dense=13, n_sparse=26, embed_dim=16, 3 cross layers,
MLP 1024-1024-512; plus a two-tower retrieval head for candidate scoring.

The 26 field lookups are row gathers on the embedding-bag kernel (their
backward on the segment-sum kernel).  Matrix products stay
``torch.matmul`` at float32's ``"highest"`` precision (no TF32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.models import layers as L
from repro_torch.models.recsys.embedding import (EmbeddingConfig, init_tables,
                                                 lookup)


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp_dims: Tuple[int, ...] = (1024, 1024, 512)
    vocab_sizes: Optional[tuple] = None   # default: Criteo-like 1e6 rows
    retrieval_dim: int = 64

    def vocabs(self):
        if self.vocab_sizes is not None:
            return self.vocab_sizes
        return tuple([1_000_000] * self.n_sparse)

    @property
    def d0(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def init_params(generator, cfg: DCNConfig, dtype=torch.float32, device=None):
    """Parameters drawn from ``generator`` on its device and put on
    ``device`` (default: the generator's; ``meta`` shapes the tree and
    draws nothing).  On another device than the generator's, every leaf
    is drawn and scaled on the generator's device and the tree then
    moved: a CUDA tensor divided by a Python number is multiplied by its
    reciprocal, which rounds otherwise than the CPU's division, so every
    device gets the same bits."""
    device = torch.device(device if device is not None else generator.device)
    if device.type != "meta" and device != generator.device:
        return tree_map(lambda x: x.to(device),
                        _draw(generator, cfg, dtype, generator.device))
    return _draw(generator, cfg, dtype, device)


def _draw(generator, cfg: DCNConfig, dtype, device):
    emb_cfg = EmbeddingConfig(cfg.vocabs(), cfg.embed_dim)
    d0 = cfg.d0
    tables = init_tables(generator, emb_cfg, dtype, device)
    cross = [{
        "w": L.normal(generator, (d0, d0), dtype, device) / math.sqrt(d0),
        "b": torch.zeros((d0,), dtype=dtype, device=device),
    } for _ in range(cfg.n_cross_layers)]
    mlp_p = L.mlp_init(generator, [d0] + list(cfg.mlp_dims), dtype, device)
    final_in = d0 + cfg.mlp_dims[-1]
    return {
        "tables": tables,
        "cross": cross,
        "mlp": mlp_p,
        "final": L.dense_init(generator, final_in, 1, dtype, device=device),
        "user_proj": L.dense_init(generator, final_in, cfg.retrieval_dim,
                                  dtype, device=device),
    }


def _backbone(params, dense_feats, sparse_ids, cfg: DCNConfig):
    emb_cfg = EmbeddingConfig(cfg.vocabs(), cfg.embed_dim)
    emb = lookup(params["tables"], sparse_ids, emb_cfg)     # (B, 26·16)
    x0 = torch.cat([dense_feats, emb], dim=-1)              # (B, d0)
    # Cross network v2: x_{l+1} = x0 ⊙ (W x_l + b) + x_l
    x = x0
    for cp in params["cross"]:
        x = x0 * (x @ cp["w"] + cp["b"]) + x
    deep = L.mlp(params["mlp"], x0, act=F.relu, final_act=True)
    return torch.cat([x, deep], dim=-1)


def predict(params, dense_feats, sparse_ids, cfg: DCNConfig):
    """CTR logit: (B,)."""
    z = _backbone(params, dense_feats, sparse_ids, cfg)
    return L.dense(params["final"], z)[:, 0]


def train_loss(params, batch, cfg: DCNConfig):
    """Binary cross-entropy on logits in the stable form
    ``max(x, 0) - x·y + log1p(exp(-|x|))``."""
    logits = predict(params, batch["dense"], batch["sparse"], cfg)
    y = batch["labels"].float()
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return torch.mean(torch.maximum(logits, zero) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def user_embedding(params, dense_feats, sparse_ids, cfg: DCNConfig):
    z = _backbone(params, dense_feats, sparse_ids, cfg)
    u = L.dense(params["user_proj"], z)
    return u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                           min=1e-6)


def retrieval_scores(params, dense_feats, sparse_ids, cand_embs,
                     cfg: DCNConfig):
    """Score one (or few) queries against n_candidates item embeddings:
    batched dot product, (B, n_cand)."""
    u = user_embedding(params, dense_feats, sparse_ids, cfg)
    return u @ cand_embs.T
