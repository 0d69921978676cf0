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

The language-model half (RoPE, GQA attention with its three paths, the
SwiGLU FFN) follows JAX's dtype promotion explicitly: ``torch.einsum`` and
``@`` refuse a bfloat16 operand beside a float32 one, where ``jnp``
promotes both to float32, so :func:`einsum` and :func:`matmul` promote
first.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint.checkpointer import leaves, tree_map, unflatten
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

def _leaf_from_reference(a, device):
    a = np.array(a)                       # a copy, writable
    if a.dtype.name == "bfloat16":        # ml_dtypes' type: numpy has none,
        # so its bits cross as uint16 and are read back as bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.tensor(a, device=device)


def tree_from_reference(tree, device=None):
    """The reference's nested tree (dicts, lists, tuples) of arrays (numpy,
    or anything ``np.asarray`` takes) as the same tree of tensors on
    ``device``, copied, dtypes kept (bfloat16 bit for bit)."""
    return tree_map(lambda a: _leaf_from_reference(a, device), tree)


def stack_trees(trees):
    """Trees of one structure -> one tree with a leading axis on every
    leaf (the layout of the reference's ``jax.vmap(init)(keys)``)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree (a view of every leaf)."""
    return tree_map(lambda a: a[i], tree)


def tree_unstack(tree) -> list:
    """Every layer of a stacked tree, as :func:`tree_index` gives them,
    through one ``unbind`` a leaf: its backward stacks the layers'
    gradients once, where each ``a[i]``'s would write its layer into a
    zero tensor of the whole leaf and add that to the others."""
    rows = [a.unbind(0) for a in leaves(tree)]
    return [unflatten(tree, iter(r)) for r in zip(*rows)]


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


# ------------------------------------------------------- dtype promotion

def _promoted(*xs):
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return [x.to(dtype) for x in xs]


def einsum(equation: str, *operands) -> torch.Tensor:
    """``jnp.einsum``: the operands promoted to one dtype first."""
    return torch.einsum(equation, *_promoted(*operands))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with ``jnp``'s promotion."""
    a, b = _promoted(a, b)
    return a @ b


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``'s expression: ``exp(x - max)`` over its sum."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


# ----------------------------------------------------------------- RoPE

def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  The head
    dimension rotates as two halves (not interleaved pairs); the angles
    are float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# -------------------------------------------------------- GQA attention

def attention_init(generator, d_model, n_heads, n_kv_heads, d_head,
                   dtype=torch.float32, device=None):
    s = 1.0 / math.sqrt(d_model)

    def draw(shape):
        return normal(generator, shape, dtype, device).mul_(s)
    return {"wq": draw((d_model, n_heads, d_head)),
            "wk": draw((d_model, n_kv_heads, d_head)),
            "wv": draw((d_model, n_kv_heads, d_head)),
            "wo": draw((n_heads, d_head, d_model))}


def _gqa_scores(q, k, n_rep):
    """q: (B,S,Hq,D), k: (B,T,Hkv,D) -> scores (B,Hkv,n_rep,S,T)."""
    B, S, Hq, D = q.shape
    q = q.reshape(B, S, k.shape[2], n_rep, D)
    return einsum("bsgrd,btgd->bgrst", q, k)


def attention(params, x, positions, *, n_rep, causal=True, theta=10000.0,
              kv_cache=None, cache_len=None, return_kv=False,
              chunked=False, q_block=1024, kv_block=1024,
              unroll_attn=False, cache_in_place=False):
    """GQA attention. If kv_cache is given: decode mode — x is (B, S, d),
    the cache holds (k, v) of shape (B, T, Hkv, D) and ``cache_len`` (an
    int) is its valid length; the new token(s) are written at
    ``cache_len`` into copies of the cache, which are returned, or, with
    ``cache_in_place`` (the caller made the copy), into the cache itself.

    Returns (out, new_cache).
    """
    B, S, d = x.shape
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    k = einsum("bsd,dhk->bshk", x, params["wk"])
    v = einsum("bsd,dhk->bshk", x, params["wv"])
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    D = q.shape[-1]

    if kv_cache is not None:
        ck, cv = kv_cache
        T = ck.shape[1]
        cache_len = int(cache_len)
        # jax.lax.dynamic_update_slice clamps the start so the update fits.
        at = min(max(cache_len, 0), T - S)
        if not cache_in_place:
            ck, cv = ck.clone(), cv.clone()
        ck[:, at:at + S] = k.to(ck.dtype)
        cv[:, at:at + S] = v.to(cv.dtype)
        kv_mask = torch.arange(T, device=x.device) <= cache_len + S - 1
        scores = _gqa_scores(q, ck, n_rep) / math.sqrt(D)
        scores = torch.where(kv_mask, scores, -1e30)
        probs = softmax(scores.to(torch.float32))
        out = einsum("bgrst,btgd->bsgrd", probs.to(x.dtype), cv)
        out = out.reshape(B, S, -1, D)
        return einsum("bshk,hkd->bsd", out, params["wo"]), (ck, cv)

    if chunked:
        from repro_torch.models.attention_chunked import chunked_attention
        out = chunked_attention(q, k, v, causal=causal, q_block=q_block,
                                kv_block=kv_block, unroll=unroll_attn)
    else:
        scores = _gqa_scores(q, k, n_rep) / math.sqrt(D)
        if causal:
            mask = torch.ones((S, S), dtype=torch.bool,
                              device=x.device).tril()
            scores = torch.where(mask, scores, -1e30)
        probs = softmax(scores.to(torch.float32))
        out = einsum("bgrst,btgd->bsgrd", probs.to(x.dtype), v)
    out = out.reshape(B, S, -1, D)
    out = einsum("bshk,hkd->bsd", out, params["wo"])
    return out, ((k, v) if return_kv else None)


# ----------------------------------------------------------- SwiGLU FFN

def ffn_init(generator, d_model, d_ff, dtype=torch.float32, device=None):
    s = 1.0 / math.sqrt(d_model)
    return {
        "w_gate": normal(generator, (d_model, d_ff), dtype, device).mul_(s),
        "w_up": normal(generator, (d_model, d_ff), dtype, device).mul_(s),
        "w_down": normal(generator, (d_ff, d_model), dtype, device)
        .div_(math.sqrt(d_ff)),
    }


def ffn(params, x):
    g = F.silu(matmul(x, params["w_gate"]))
    u = matmul(x, params["w_up"])
    return matmul(g * u, params["w_down"])
