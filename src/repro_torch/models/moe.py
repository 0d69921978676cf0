"""Mixture-of-Experts layer with capacity-bucketed dispatch, the
reference's ``repro.models.moe``.

The token→expert dispatch is the walk engine's fixed-capacity
sort-and-bucket machinery (`core/router.py`): tokens are work items
tagged with a destination (expert), ranked within their destination by a
stable sort, and bucketed with capacity
``C = max(1, ceil(capacity_factor · top_k · T / E))``; overflow tokens
fall through the residual connection.

The gathers (token rows into the expert buffer, expert rows back to the
token's slots) run on ``layers.gather_rows``, the embedding-bag kernel,
and the combine (each token's ``top_k`` weighted rows summed) on
``gnn.common.scatter_sum``, the segment-sum kernel, which adds in
position order: on the card the output is the same bits every run, where
``index_add_``'s atomics would add in no fixed order.  The kernels take
float32, so bfloat16 rows are upcast for them and the sum cast back (the
reference sums bfloat16 contributions in bfloat16).

``expert_sharding`` places nothing on one card, where every expert is
local; :func:`moe_param_specs` reads it for the dry-run's placements
(``launch.specs``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import PartitionSpec as P
from repro_torch.models import layers as L
from repro_torch.models.gnn.common import scatter_sum


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    expert_sharding: str = "expert"  # expert (EP) | ffn (TP)
    router_aux_weight: float = 0.01
    # "global" sorts/buckets all T tokens at once; "row" dispatches each
    # batch row on its own (per-row capacity).
    dispatch: str = "global"
    # pad num_experts up to a multiple of `pad_experts_to` with never-routed
    # dummies (the reference's EP sharding needs the multiple).
    pad_experts_to: int = 0

    @property
    def padded_experts(self) -> int:
        if self.pad_experts_to and self.num_experts % self.pad_experts_to:
            return -(-self.num_experts // self.pad_experts_to) \
                * self.pad_experts_to
        return self.num_experts


def moe_init(generator, d_model: int, cfg: MoEConfig, dtype=torch.float32,
             device=None):
    E, Fd = cfg.padded_experts, cfg.d_ff
    s = 1.0 / math.sqrt(d_model)

    def draw(shape, dt=dtype):
        return L.normal(generator, shape, dt, device)
    return {
        "router": draw((d_model, cfg.num_experts), torch.float32).mul_(s),
        "w_gate": draw((E, d_model, Fd)).mul_(s),
        "w_up": draw((E, d_model, Fd)).mul_(s),
        "w_down": draw((E, Fd, d_model)).div_(math.sqrt(Fd)),
    }


def _gather(table, ids):
    """``table[ids]`` on the embedding-bag kernel (float32 rows)."""
    return L.gather_rows(table.to(torch.float32), ids)


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Rows of each expert's buffer for ``tokens`` routed tokens:
    ``max(1, ceil(capacity_factor · top_k · T / E))``."""
    return max(1, int(math.ceil(cfg.capacity_factor * cfg.top_k * tokens
                                / cfg.padded_experts)))


def _route(params, x, cfg: MoEConfig):
    """(probs (T, E), gate values and experts (T, K), the capacity C)."""
    T = x.shape[0]
    E, K = cfg.padded_experts, cfg.top_k
    C = capacity(cfg, T)
    logits = x.to(torch.float32) @ params["router"]         # (T, E_real)
    if E != cfg.num_experts:  # padded dummies are never routed to
        pad = torch.full((T, E - cfg.num_experts), -1e30, device=x.device)
        logits = torch.cat([logits, pad], dim=-1)
    probs = L.softmax(logits)
    gate_vals, experts = torch.topk(probs, K, dim=-1)       # (T, K)
    return probs, gate_vals, experts, C


def _buckets(experts, gate_vals, C: int):
    """The capacity-bucket dispatch (router.pack_buckets, token edition):
    the (token, expert) pairs in stable expert order as (token, gate,
    slot ``e·C + rank``, kept ``rank < C``)."""
    T, K = experts.shape
    dev = experts.device
    flat_e = experts.reshape(-1)                            # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    e_sorted, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    pos = torch.arange(T * K, device=dev) - first
    return (flat_t[order], gate_vals.reshape(-1)[order], e_sorted * C + pos,
            pos < C)


def moe_apply(params, x, cfg: MoEConfig):
    """x: (T, d) flattened tokens -> (T, d), aux_loss (scalar)."""
    T, d = x.shape
    E = cfg.padded_experts
    probs, gate_vals, experts, C = _route(params, x, cfg)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # Load-balancing auxiliary loss (Switch/GShard style).
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(experts[:, 0], E).to(torch.float32), dim=0)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    t_sorted, g_sorted, slot, keep = _buckets(experts, gate_vals, C)
    slot_safe = torch.where(keep, slot, E * C)

    # Token rows into (E, C, d) expert buffers; dropped ones land in the
    # spare row E·C, which is cut off.
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot_safe] = _gather(x, t_sorted).to(x.dtype)
    buf = buf[:E * C].reshape(E, C, d)

    # Per-expert FFN (grouped einsum over the expert dim).
    g = F.silu(L.einsum("ecd,edf->ecf", buf, params["w_gate"]))
    u = L.einsum("ecd,edf->ecf", buf, params["w_up"])
    y = L.einsum("ecf,efd->ecd", g * u, params["w_down"])  # (E, C, d)

    # Combine: each token's kept rows, gate-weighted, summed in order.
    y_flat = y.reshape(E * C, d)
    contrib = _gather(y_flat, torch.clamp(slot, 0, E * C - 1)) \
        * g_sorted[:, None]
    contrib = torch.where(keep[:, None], contrib, 0.0)
    out = scatter_sum(contrib, t_sorted, T).to(x.dtype)
    return out, aux


def moe_apply_batched(params, x, cfg: MoEConfig):
    """x: (B, S, d) -> (B, S, d), aux.  Row dispatch runs the bucketed
    dispatch on each batch row alone (the reference's ``vmap``)."""
    B, S, d = x.shape
    if cfg.dispatch == "row":
        ys, auxs = zip(*(moe_apply(params, x[b], cfg) for b in range(B)))
        return torch.stack(ys), torch.mean(torch.stack(auxs))
    y, aux = moe_apply(params, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux


def moe_param_specs(cfg: MoEConfig, model_axis: str = "model"):
    """The experts' :class:`PartitionSpec`s for one layer's leaves (the
    reference's): the expert axis over ``model_axis`` under ``"expert"``
    sharding, else the hidden ``d_ff`` axis (``w_down``'s rows); the
    router replicated."""
    if cfg.expert_sharding == "expert":
        w = P(model_axis, None, None)
        wd = P(model_axis, None, None)
    else:
        w = P(None, None, model_axis)
        wd = P(None, model_axis, None)
    return {"router": P(None, None), "w_gate": w, "w_up": w, "w_down": wd}
