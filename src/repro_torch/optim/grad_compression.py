"""Error-feedback int8 gradient compression for the cross-pod hop, the
reference's ``repro.optim.grad_compression``.

At 2+ pods the inter-pod links are the slow hop; gradients are reduced
hierarchically: full-precision reduce within a pod, then an int8
all-reduce across pods with a per-tensor scale and local error feedback
(the quantization residual is added back into the next step's gradient),
which preserves convergence (1-bit Adam / EF-SGD lineage).

The quantizer is the reference's expression: ``torch.round`` rounds half
to even as ``jnp.round`` does, so ``q`` and ``scale`` are the same bits,
on the CPU and on the card.
The cross-pod reduction runs over the pod axis the way the sharded
backend runs its collectives (`distributed/mesh.py`): every leaf carries
the pods stacked on its leading axis, where the reference runs one
program a pod inside ``shard_map``.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpointer import leaves, tree_map, unflatten
from repro_torch.distributed import mesh


def quantize_int8(x):
    """Symmetric per-tensor int8 quantization. Returns (q, scale).  The
    divisor 127 is a tensor on ``x``'s device: a CUDA tensor divided by a
    Python number is multiplied by its reciprocal, which rounds otherwise
    than the division the CPU and the reference make."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_with_feedback(grad, error):
    """EF step: g' = g + e; q = Q(g'); e' = g' - deQ(q)."""
    g = grad.to(torch.float32) + error
    q, scale = quantize_int8(g)
    deq = dequantize_int8(q, scale)
    new_error = g - deq
    return (q, scale), deq, new_error


def _one(g, e):
    """One leaf, pods on the leading axis: each pod quantizes its own
    gradient (with its own scale and error), the int8 payloads are summed
    over the pods in int32 (exact) and scaled by the pods' largest scale;
    every pod holds the result."""
    (q, scale), _, new_e = torch.func.vmap(compress_with_feedback)(g, e)
    s = mesh.pmax(scale)
    q32 = mesh.psum(q.to(torch.int32))
    return q32.to(torch.float32) * s.reshape(-1, *[1] * (g.dim() - 1)), new_e


def crosspod_psum_compressed(grads, errors, axis_name: str = "pod"):
    """Per leaf: error-feedback int8 quantize -> sum over pods -> dequant.

    Every leaf of ``grads`` and ``errors`` carries the pod axis first
    (``axis_name`` names it, as the reference's mesh axis).  Returns
    ``(reduced_grads, new_errors)``, pods still leading.  The int8
    payload cuts cross-pod bytes 4x vs f32 (2x vs bf16)."""
    out = [_one(g, e) for g, e in zip(leaves(grads), leaves(errors),
                                      strict=True)]
    return (unflatten(grads, iter([o[0] for o in out])),
            unflatten(grads, iter([o[1] for o in out])))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
