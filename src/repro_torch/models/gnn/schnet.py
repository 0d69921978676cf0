"""SchNet [arXiv:1706.08566]: continuous-filter convolutions with RBF
edge filters; 3 interactions, d_hidden=64, 300 RBFs, cutoff 10 Å.
Kernel regime: triplet-free radial gather + scatter.

The interactions keep the reference's stacked layout (a leading layer
axis on every leaf of ``"inters"``, as ``jax.vmap(init)`` makes it), so
its tree carries across unchanged; ``scan_layers`` True and False both
loop over that axis and give the same numbers.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.gnn.common import scatter_sum


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    scan_layers: bool = True


def shifted_softplus(x):
    """``softplus(x) - log 2`` with ``jax.nn.softplus``'s form,
    ``logaddexp(x, 0)``: no threshold (torch's ``F.softplus`` returns x
    above 20) and a gradient of 1/2 at 0."""
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)


def rbf_expand(dist, n_rbf: int, cutoff: float):
    centers = torch.linspace(0.0, cutoff, n_rbf, device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def init_params(generator, cfg: SchNetConfig, device=None):
    d = cfg.d_hidden

    def init_inter():
        return {
            "filter": L.mlp_init(generator, [cfg.n_rbf, d, d], device=device),
            "in_proj": L.dense_init(generator, d, d, device=device),
            "out1": L.dense_init(generator, d, d, device=device),
            "out2": L.dense_init(generator, d, d, device=device),
        }

    return {
        "embed": L.normal(generator, (cfg.n_species, d), device=device) * 0.1,
        "inters": L.stack_trees([init_inter()
                                 for _ in range(cfg.n_interactions)]),
        "out": L.mlp_init(generator, [d, d // 2, 1], device=device),
    }


def apply(params, species, positions, edge_index, cfg: SchNetConfig,
          mol_id=None, n_mols: int = 1):
    """species (N,) int; positions (N,3); edge_index (2,E).
    Returns per-molecule energies (n_mols,)."""
    N = species.shape[0]
    src, dst = edge_index[0], edge_index[1]
    h = L.gather_rows(params["embed"],
                      torch.clamp(species, 0, cfg.n_species - 1))
    rij = L.gather_rows(positions, dst) - L.gather_rows(positions, src)
    dist = torch.sqrt(torch.sum(torch.square(rij), dim=-1) + 1e-12)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    # smooth cosine cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                 + 1.0)

    for lp in L.tree_unstack(params["inters"]):
        w = L.mlp(lp["filter"], rbf, act=shifted_softplus,
                  final_act=True) * env[:, None]
        x = L.dense(lp["in_proj"], h)
        msg = L.gather_rows(x, src) * w
        agg = scatter_sum(msg, dst, N)
        y = shifted_softplus(L.dense(lp["out1"], agg))
        h = h + L.dense(lp["out2"], y)
    e_atom = L.mlp(params["out"], h, act=shifted_softplus)[:, 0]
    if mol_id is None:
        mol_id = torch.zeros((N,), dtype=torch.int32, device=species.device)
    return scatter_sum(e_atom, mol_id, n_mols)


def train_loss(params, batch, cfg: SchNetConfig):
    e = apply(params, batch["species"], batch["positions"],
              batch["edge_index"], cfg, batch.get("mol_id"),
              batch["energies"].shape[0])
    return torch.mean(torch.square(e - batch["energies"]))
