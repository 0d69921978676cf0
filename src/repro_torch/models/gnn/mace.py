"""MACE [arXiv:2206.07697]: higher-order equivariant message passing —
2 layers, d_hidden=128 channels, l_max=2, correlation order 3, 8 radial
Bessel functions, E(3)-equivariance.

Irreps are carried in **Cartesian form**, as in the reference: l=0
scalars (N, C), l=1 vectors (N, C, 3), l=2 traceless symmetric tensors
(N, C, 3, 3).  Clebsch-Gordan couplings become explicit Cartesian
contractions (dot, symmetric products, traceless projections), exactly
equivariant under O(3).  The correlation-order-3 "B-features" are the
products of the density "A-features" listed in
``_symmetric_contractions``.

Gathers and sums of l>0 features run on the kernels as rows of width C·3
or C·9.  ``edges_sorted`` is an XLA hint in the reference and changes no
result; here it is accepted and ignored.  ``message_dtype="bf16"``: the
kernels take float32 only, so that path computes the messages in
bfloat16 as the reference does, upcasts them to float32 for the gather
and the sum, and casts back; the reference sums in bfloat16, so the two
agree within a bfloat16 tolerance, not bit for bit.  ``"layers"`` is a
list, not stacked.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.models import layers as L
from repro_torch.models.gnn.common import scatter_sum


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128      # channels per irrep
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    n_species: int = 100
    # highest-l node features carried across edges: 2 = full, 0 =
    # invariants only (equivariants rebuilt locally from Y_l(r̂))
    propagate_lmax: int = 2
    # edge messages in bf16 ("bf16") or f32 ("f32")
    message_dtype: str = "f32"
    # a promise that edges arrive sorted by destination (ignored here)
    edges_sorted: bool = False


def bessel_basis(r, n: int, r_cut: float):
    """Radial Bessel basis (MACE eq. 7): sqrt(2/rc)·sin(nπr/rc)/r."""
    r = torch.clamp(r, min=1e-9)
    ns = torch.arange(1, n + 1, dtype=torch.float32, device=r.device)
    return (math.sqrt(2.0 / r_cut) * torch.sin(ns[None, :] * math.pi
                                               * r[:, None] / r_cut)
            / r[:, None])


def cutoff_envelope(r, r_cut: float, p: int = 6):
    x = torch.clamp(r / r_cut, 0.0, 1.0)
    return (1.0 - 0.5 * (p + 1) * (p + 2) * x ** p
            + p * (p + 2) * x ** (p + 1)
            - 0.5 * p * (p + 1) * x ** (p + 2))


def _traceless(t):
    """Project (…,3,3) onto symmetric-traceless (the l=2 irrep)."""
    sym = 0.5 * (t + torch.swapaxes(t, -1, -2))
    tr = torch.diagonal(sym, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    return sym - tr * eye / 3.0


def _symmetric_contractions(a0, a1, a2):
    """Correlation-order ≤ 3 invariant/equivariant products of the
    A-features (the Cartesian form of MACE's symmetrized tensor powers).

    Returns (scalars list, vectors list, tensors list), each element of
    per-channel shape (N, C[, 3[, 3]])."""
    dot11 = torch.einsum("nci,nci->nc", a1, a1)
    dot22 = torch.einsum("ncij,ncij->nc", a2, a2)
    v2v = torch.einsum("ncij,ncj->nci", a2, a1)          # A2·A1 (vector)
    scalars = [
        a0,                                              # order 1
        a0 * a0, dot11, dot22,                           # order 2
        a0 * a0 * a0, a0 * dot11, a0 * dot22,            # order 3
        torch.einsum("nci,nci->nc", a1, v2v),            # A1·A2·A1
        torch.einsum("ncij,ncjk,ncki->nc", a2, a2, a2),  # tr(A2³)
    ]
    vectors = [
        a1,                                              # order 1
        a0[..., None] * a1, v2v,                         # order 2
        a0[..., None] * v2v, dot11[..., None] * a1,      # order 3
        torch.einsum("ncij,ncjk,nck->nci", a2, a2, a1),
    ]
    outer11 = _traceless(torch.einsum("nci,ncj->ncij", a1, a1))
    tensors = [
        a2,
        a0[..., None, None] * a2, outer11,
        _traceless(torch.einsum("ncik,nckj->ncij", a2, a2)),
        a0[..., None, None] * outer11,
        _traceless(torch.einsum("nci,ncj->ncij", a1, v2v)),
    ]
    return scalars, vectors, tensors


def init_params(generator, cfg: MACEConfig, device=None):
    C = cfg.d_hidden
    n_s, n_v, n_t = 9, 6, 6  # product counts above

    def radial():
        return L.mlp_init(generator, [cfg.n_rbf, 32, C], device=device)

    def init_layer():
        r0, r1, r2 = radial(), radial(), radial()
        mix_s = L.dense_init(generator, n_s * C, C, device=device)
        mix_v = L.normal(generator, (n_v, C, C), device=device) * (1.0 / C)
        mix_t = L.normal(generator, (n_t, C, C), device=device) * (1.0 / C)
        update = L.dense_init(generator, 2 * C, C, device=device)
        readout = L.mlp_init(generator, [C, 16, 1], device=device)
        return {
            "radial0": r0, "radial1": r1, "radial2": r2,
            # couplings of the previous layer's l=1 / l=2 node features;
            # the reference draws them from radial0's and radial1's keys,
            # so they start as copies of those two
            "radial1b": tree_map(torch.clone, r0),
            "radial2b": tree_map(torch.clone, r1),
            "mix_s": mix_s, "mix_v": mix_v, "mix_t": mix_t,
            "update": update, "readout": readout,
        }

    return {
        "embed": L.normal(generator, (cfg.n_species, C), device=device) * 0.1,
        "layers": [init_layer() for _ in range(cfg.n_layers)],
    }


def _gather(x, ids):
    """Rows ``x[ids]`` of a node feature of any trailing shape, through
    the kernel in float32 (cast back to ``x``'s dtype: exact)."""
    flat = x.reshape(x.shape[0], -1).float()
    return L.gather_rows(flat, ids).to(x.dtype).reshape(ids.shape[0],
                                                         *x.shape[1:])


def apply(params, species, positions, edge_index, cfg: MACEConfig,
          mol_id=None, n_mols: int = 1):
    """Returns per-molecule energies (n_mols,). Equivariant internals."""
    N = species.shape[0]
    src, dst = edge_index[0], edge_index[1]
    C = cfg.d_hidden

    h = L.gather_rows(params["embed"],
                      torch.clamp(species, 0, cfg.n_species - 1))  # (N, C)
    rij = L.gather_rows(positions, src) - L.gather_rows(positions, dst)
    r = torch.sqrt(torch.sum(torch.square(rij), -1) + 1e-12)
    rhat = rij / r[:, None]
    rbf = bessel_basis(r, cfg.n_rbf, cfg.r_cut) \
        * cutoff_envelope(r, cfg.r_cut)[:, None]
    y1 = rhat                                               # (E, 3)
    y2 = _traceless(torch.einsum("ei,ej->eij", rhat, rhat))  # (E, 3, 3)

    mdt = torch.bfloat16 if cfg.message_dtype == "bf16" else torch.float32

    def seg(m):
        return scatter_sum(m.float(), dst, N)

    energy = torch.zeros((N,), dtype=torch.float32, device=h.device)
    h_v = torch.zeros((N, C, 3), dtype=mdt, device=h.device)
    h_t = torch.zeros((N, C, 3, 3), dtype=mdt, device=h.device)
    for lp in params["layers"]:
        r0 = L.mlp(lp["radial0"], rbf)                      # (E, C)
        r1 = L.mlp(lp["radial1"], rbf)
        r2 = L.mlp(lp["radial2"], rbf)
        hsrc = L.gather_rows(h, src).to(mdt)                # (E, C)
        # Density A-features: scalar channels spread onto Y_l(r̂), plus
        # (propagate_lmax >= 1) the previous layer's own l=1 / l=2
        # features propagated along edges.
        a0 = seg(r0.to(mdt) * hsrc)
        m1 = (r1.to(mdt) * hsrc)[..., None] * y1[:, None, :].to(mdt)
        if cfg.propagate_lmax >= 1:
            r1b = L.mlp(lp["radial1b"], rbf)
            m1 = m1 + r1b.to(mdt)[..., None] * _gather(h_v, src)
        a1 = seg(m1)
        m2 = (r2.to(mdt) * hsrc)[..., None, None] \
            * y2[:, None, :, :].to(mdt)
        if cfg.propagate_lmax >= 2:
            r2b = L.mlp(lp["radial2b"], rbf)
            m2 = m2 + r2b.to(mdt)[..., None, None] * _gather(h_t, src)
        a2 = seg(m2)

        s_list, v_list, t_list = _symmetric_contractions(a0, a1, a2)
        b_s = L.dense(lp["mix_s"], torch.cat(s_list, dim=-1))
        # equivariant channel mixing (no nonlinearity on l>0 parts)
        h_v = torch.einsum("pnci,pcd->ndi", torch.stack(v_list),
                           lp["mix_v"]).to(mdt)
        h_t = torch.einsum("pncij,pcd->ndij", torch.stack(t_list),
                           lp["mix_t"]).to(mdt)
        h = F.silu(L.dense(lp["update"], torch.cat([h, b_s], dim=-1)))
        energy = energy + L.mlp(lp["readout"], h)[:, 0]

    if mol_id is None:
        mol_id = torch.zeros((N,), dtype=torch.int32, device=species.device)
    return scatter_sum(energy, mol_id, n_mols)


def train_loss(params, batch, cfg: MACEConfig):
    e = apply(params, batch["species"], batch["positions"],
              batch["edge_index"], cfg, batch.get("mol_id"),
              batch["energies"].shape[0])
    return torch.mean(torch.square(e - batch["energies"]))
