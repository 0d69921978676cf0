"""Minimal functional NN substrate, the reference's ``repro.models.layers``.

Params are nested dicts and lists of tensors; every layer is an (init,
apply) pair of plain functions on tensors, with autograd through
``torch.autograd``.  Each ``*_init`` draws from a ``torch.Generator``
(`core/rng.py::seeded_generator`) on the generator's device and puts the
result on ``device``; on the ``meta`` device it draws nothing and
allocates nothing, so a full configuration's tree can be shaped without
memory.  A generator cannot give ``jax.random``'s numbers: to start from
the reference's weights, carry its tree across with
:func:`tree_from_reference`.

Row gathers (``table[ids]``) go through :func:`gather_rows`: the forward
on the embedding-bag kernel, the backward on the segment-sum kernel, so
a training step on the card is a deterministic function of its inputs.

RoPE, attention and the SwiGLU FFN of the reference's module come with
the language-model slice (ROADMAP item 11b).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint.checkpointer import tree_map
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.segment_sum import segment_sum


def normal(generator: torch.Generator, shape, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """Standard normal draws of ``shape`` from ``generator``, on ``device``
    (default: the generator's); on ``meta`` an empty tensor, no draw."""
    device = torch.device(device if device is not None else generator.device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    return x.to(device)


def dense_init(generator, d_in, d_out, dtype=torch.float32, scale=None,
               device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": normal(generator, (d_in, d_out), dtype, device) * scale}


def dense(params, x):
    return x @ params["w"]


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (the exact erf
    form differs from it by up to 4.7e-4)."""
    return F.gelu(x, approximate="tanh")


def mlp_init(generator, dims, dtype=torch.float32, device=None):
    return {"layers": [dense_init(generator, a, b, dtype, device=device)
                       for a, b in zip(dims[:-1], dims[1:])]}


def mlp(params, x, act=gelu, final_act=False):
    n = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        x = dense(lp, x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def layernorm_init(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-5):
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.var(x, dim=-1, keepdim=True, unbiased=False)   # jnp.var
    return (x - m) * torch.rsqrt(v + eps) * params["scale"] + params["bias"]


def rmsnorm_init(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6, cast_scale=False):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    scale = params["scale"].to(x.dtype) if cast_scale else params["scale"]
    return (out * scale).to(x.dtype)


# ------------------------------------------------------------------ trees

def tree_from_reference(tree, device=None):
    """The reference's nested tree (dicts, lists, tuples) of arrays (numpy,
    or anything ``np.asarray`` takes) as the same tree of tensors on
    ``device``, copied, dtypes kept."""
    return tree_map(lambda a: torch.tensor(np.array(a), device=device), tree)


def stack_trees(trees):
    """Trees of one structure -> one tree with a leading axis on every
    leaf (the layout of the reference's ``jax.vmap(init)(keys)``)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree (a view of every leaf)."""
    return tree_map(lambda a: a[i], tree)


# ------------------------------------------------------------ row gathers
#
# A row gather is a one-row bag of the embedding-bag kernel.  Its gradient
# is a scatter of the output gradient back to the rows, on the segment-sum
# kernel, which sums each row's contributions in a fixed order: the
# gradient (and so a whole training run) is the same bits every time on
# the card, unlike index_add_, whose atomics add in no fixed order.


class _KernelGather(torch.autograd.Function):
    """``table[flat_ids]`` on the embedding-bag kernel; backward on the
    segment-sum kernel (the ids get no gradient)."""

    @staticmethod
    def forward(ctx, table, flat_ids):
        ctx.save_for_backward(flat_ids)
        ctx.rows = table.shape[0]
        return embedding_bag(flat_ids[:, None], table)

    @staticmethod
    def backward(ctx, g):
        (flat_ids,) = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = segment_sum(g.contiguous(), flat_ids, ctx.rows)
        return grad, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a 2-D float32 ``table``, with the forward on the
    embedding-bag kernel and the backward on the segment-sum kernel (their
    plain versions for CPU tensors).  Ids must lie in ``[0, rows)``: the
    forward clamps others, the backward drops them.

    ``ids`` may carry any leading shape; the row axis is appended last.
    """
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    rows = _KernelGather.apply(table.contiguous(), flat)
    return rows.reshape(*ids.shape, table.shape[1])
