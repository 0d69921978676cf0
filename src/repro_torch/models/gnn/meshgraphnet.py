"""MeshGraphNet [arXiv:2010.03409]: encode-process-decode with 15 message
passing layers, d_hidden=128, sum aggregation, 2-layer MLPs + LayerNorm.

The layers keep the reference's stacked layout; ``scan_layers`` True and
False both loop over it.  ``remat`` wraps each layer's body in
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the
backward recomputes the layer's activations, which changes memory only,
never values.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.gnn.common import mlp_ln, mlp_ln_init, scatter_sum


@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    node_in: int = 16
    edge_in: int = 8
    out_dim: int = 3
    remat: bool = True
    scan_layers: bool = True


def _mlp_dims(cfg, d_in):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


def init_params(generator, cfg: MeshGraphNetConfig, device=None):
    d = cfg.d_hidden

    def init_layer():
        return {
            "edge_mlp": mlp_ln_init(generator, _mlp_dims(cfg, 3 * d),
                                    device=device),
            "node_mlp": mlp_ln_init(generator, _mlp_dims(cfg, 2 * d),
                                    device=device),
        }

    return {
        "node_enc": mlp_ln_init(generator, _mlp_dims(cfg, cfg.node_in),
                                device=device),
        "edge_enc": mlp_ln_init(generator, _mlp_dims(cfg, cfg.edge_in),
                                device=device),
        "layers": L.stack_trees([init_layer() for _ in range(cfg.n_layers)]),
        "decoder": L.mlp_init(generator, [d, d, cfg.out_dim], device=device),
    }


def _body(h, e, lp, src, dst, N):
    msg_in = torch.cat([e, L.gather_rows(h, src), L.gather_rows(h, dst)],
                       dim=-1)
    e = e + mlp_ln(lp["edge_mlp"], msg_in)
    agg = scatter_sum(e, dst, N)
    h = h + mlp_ln(lp["node_mlp"], torch.cat([h, agg], dim=-1))
    return h, e


def apply(params, node_feats, edge_feats, edge_index,
          cfg: MeshGraphNetConfig):
    """edge_index: (2, E) [src, dst]. Returns per-node predictions (N, out)."""
    N = node_feats.shape[0]
    src, dst = edge_index[0], edge_index[1]
    h = mlp_ln(params["node_enc"], node_feats)
    e = mlp_ln(params["edge_enc"], edge_feats)
    for lp in L.tree_unstack(params["layers"]):
        if cfg.remat:
            h, e = checkpoint(_body, h, e, lp, src, dst, N,
                              use_reentrant=False)
        else:
            h, e = _body(h, e, lp, src, dst, N)
    return L.mlp(params["decoder"], h)


def train_loss(params, batch, cfg: MeshGraphNetConfig):
    pred = apply(params, batch["node_feats"], batch["edge_feats"],
                 batch["edge_index"], cfg)
    return torch.mean(torch.square(pred - batch["targets"]))
