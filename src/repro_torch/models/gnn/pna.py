"""PNA [arXiv:2004.05718]: Principal Neighbourhood Aggregation —
4 aggregators (mean/min/max/std) × 3 degree scalers (identity,
amplification, attenuation), n_layers=4, d_hidden=75.

The layers keep the reference's stacked layout (a leading layer axis on
every leaf of ``"layers"``); ``scan_layers`` True and False both loop
over it and give the same numbers.  The loop takes its layers through
``layers.tree_unstack`` (one ``unbind`` a leaf), as MeshGraphNet and
SchNet do: indexing layer ``i`` would make each layer's backward write a
zero tensor of the whole stacked leaf, bytes that grow with the square
of the depth.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.gnn.common import (degrees, mlp_ln, mlp_ln_init,
                                           scatter_max, scatter_mean,
                                           scatter_min)


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    node_in: int = 16
    out_dim: int = 7
    avg_log_degree: float = 2.0  # δ: dataset-level E[log(d+1)]
    scan_layers: bool = True


def init_params(generator, cfg: PNAConfig, device=None):
    d = cfg.d_hidden

    def init_layer():
        return {
            "msg": mlp_ln_init(generator, [2 * d, d, d], device=device),
            # h + 12 aggregates
            "update": mlp_ln_init(generator, [13 * d, d, d], device=device),
        }

    return {
        "enc": mlp_ln_init(generator, [cfg.node_in, d, d], device=device),
        "layers": L.stack_trees([init_layer() for _ in range(cfg.n_layers)]),
        "dec": L.mlp_init(generator, [d, d, cfg.out_dim], device=device),
    }


def apply(params, node_feats, edge_index, cfg: PNAConfig):
    N = node_feats.shape[0]
    src, dst = edge_index[0], edge_index[1]
    h = mlp_ln(params["enc"], node_feats)
    deg = degrees(dst, N)
    logd = torch.log(deg + 1.0)
    amp = (logd / cfg.avg_log_degree)[:, None]
    att = (cfg.avg_log_degree / torch.clamp(logd, min=1e-6))[:, None]
    has = (deg > 0)[:, None]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)

    for lp in L.tree_unstack(params["layers"]):
        msg = mlp_ln(lp["msg"], torch.cat([L.gather_rows(h, src),
                                           L.gather_rows(h, dst)], -1))
        mean = scatter_mean(msg, dst, N)
        mx = scatter_max(msg, dst, N)
        mn = scatter_min(msg, dst, N)
        sq = scatter_mean(torch.square(msg), dst, N)
        # torch.maximum splits a tie's gradient evenly, as jnp.maximum does
        # (a node with one in-edge has sq == mean² exactly).
        std = torch.sqrt(torch.maximum(sq - torch.square(mean), zero) + 1e-6)
        # mask empty neighborhoods (segment_max fills them with -inf)
        aggs = [torch.where(has, a, zero) for a in (mean, mx, mn, std)]
        scaled = [a * s for a in aggs for s in
                  (torch.ones_like(amp), amp, att)]           # 12 × (N, d)
        upd = torch.cat([h] + scaled, dim=-1)
        h = h + mlp_ln(lp["update"], upd)
    return L.mlp(params["dec"], h)


def train_loss(params, batch, cfg: PNAConfig):
    logits = apply(params, batch["node_feats"], batch["edge_index"], cfg)
    labels = batch["labels"].long()
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))
