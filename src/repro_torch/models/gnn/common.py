"""GNN message-passing substrate, the reference's
``repro.models.gnn.common``.

Message passing is a gather (edge source) → message → scatter over the
destination index.  The gathers are ``layers.gather_rows`` and the sums
:func:`scatter_sum`, both on the port's deterministic kernels: a sum's
forward on the segment-sum kernel and its backward (the gather
``g[dst]``) on the embedding-bag kernel, and the other way round for a
gather.  So a training step on the card sums in a fixed order and gives
the same bits every run.  The max and min scatters are
``Tensor.scatter_reduce`` (the reference's ``jax.ops.segment_max`` is
XLA, not a kernel of its own); a max is exact in any order.

Every id must lie in ``[0, num_nodes)``: the segment sum drops others and
the embedding bag clamps them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.models import layers as L


class _KernelScatterSum(torch.autograd.Function):
    """(E, D) rows summed by segment on the segment-sum kernel; backward
    ``g[dst]`` on the embedding-bag kernel (the ids get no gradient)."""

    @staticmethod
    def forward(ctx, messages, dst, num_nodes):
        ctx.save_for_backward(dst)
        return segment_sum(messages, dst, num_nodes)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = embedding_bag(dst[:, None], g.contiguous())
        return grad, None, None


def scatter_sum(messages, dst, num_nodes: int):
    """(E, ...) float32 messages summed by ``dst`` (E,) into (num_nodes,
    ...); empty segments are 0.  Trailing axes are flattened into the
    kernel's row width and restored."""
    tail = messages.shape[1:]
    flat = messages.reshape(messages.shape[0], -1).contiguous()
    ids = dst.to(torch.int32).contiguous()
    out = _KernelScatterSum.apply(flat, ids, int(num_nodes))
    return out.reshape(int(num_nodes), *tail)


def scatter_mean(messages, dst, num_nodes: int):
    s = scatter_sum(messages, dst, num_nodes)
    cnt = scatter_sum(torch.ones((messages.shape[0],), dtype=messages.dtype,
                                 device=messages.device), dst, num_nodes)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def scatter_max(messages, dst, num_nodes: int):
    """Segment max; an empty segment holds ``-inf``, as
    ``jax.ops.segment_max``'s does.  The gradient of a tie is split evenly
    among the tied rows, as JAX splits it."""
    idx = dst.long().reshape(-1, *([1] * (messages.dim() - 1)))
    fill = torch.full((int(num_nodes), *messages.shape[1:]), float("-inf"),
                      dtype=messages.dtype, device=messages.device)
    return fill.scatter_reduce(0, idx.expand_as(messages), messages, "amax",
                               include_self=False)


def scatter_min(messages, dst, num_nodes: int):
    return -scatter_max(-messages, dst, num_nodes)


def degrees(dst, num_nodes: int, dtype=torch.float32):
    """In-degrees (num_nodes,) as a segment sum of ones (a D = 1 sum)."""
    return scatter_sum(torch.ones(dst.shape, dtype=dtype, device=dst.device),
                       dst, num_nodes)


def mlp_ln_init(generator, dims, dtype=torch.float32, device=None):
    p = L.mlp_init(generator, dims, dtype, device=device)
    p["ln"] = L.layernorm_init(dims[-1], torch.float32, device=device)
    return p


def mlp_ln(params, x, act=F.relu):
    y = L.mlp(params, x, act=act)
    return L.layernorm(params["ln"], y)
