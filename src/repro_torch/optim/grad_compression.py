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
backend runs its collectives (`distributed/mesh.py`), where the
reference runs one program a pod inside ``shard_map``: every leaf
carries the pods stacked on its leading axis, or, over a mesh whose pod
axis spans G device groups, every leaf is a list of G per-group tensors
of ``pods / G`` pods, each on its group's device.  Each group quantizes
its own pods; the int8 payloads are summed in int32 and the scales
joined by their max over the groups, both exact, so every grouping gives
the stacked call's bits.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpointer import (flatten_with_paths, leaves,
                                                 tree_map, unflatten)
from repro_torch.distributed import mesh
from repro_torch.distributed.mesh import axis_devices, check_devices


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
    """One leaf, the pods of each group stacked first (one tensor a group
    in ``g`` and ``e``): each pod quantizes its own gradient (with its own
    scale and error), the int8 payloads are summed over all pods in int32
    (exact) and scaled by the pods' largest scale; every pod holds the
    result, on its group's device."""
    parts = [torch.func.vmap(compress_with_feedback)(gg, ee)
             for gg, ee in zip(g, e, strict=True)]
    s = mesh.pmax([scale for (_, scale), _, _ in parts])
    q32 = mesh.psum([q.to(torch.int32) for (q, _), _, _ in parts])
    dims = [1] * (g[0].dim() - 1)
    return ([a.to(torch.float32) * b.reshape(-1, *dims)
             for a, b in zip(q32, s)], [new_e for _, _, new_e in parts])


def _grouped(tree, G: int, where: str) -> list:
    """``tree``'s leaves, G consecutive entries a leaf: each leaf a list
    of G per-group tensors (checked from the leaves' paths)."""
    flat = flatten_with_paths(tree)
    split = [p.rpartition("/") for p, _ in flat]
    if len(flat) % G or not all(
            tail == str(i % G) and head == split[i - i % G][0]
            for i, (head, _, tail) in enumerate(split)):
        raise ValueError(f"{where}: over {G} device groups every leaf must "
                         f"be a list of {G} per-group tensors")
    return [x for _, x in flat]


def crosspod_psum_compressed(grads, errors, axis_name: str = "pod",
                             mesh=None):
    """Per leaf: error-feedback int8 quantize -> sum over pods -> dequant.

    Every leaf of ``grads`` and ``errors`` carries the pod axis first
    (``axis_name`` names it, as the reference's mesh axis), stacked, or,
    where ``mesh``'s ``axis_name`` axis spans G > 1 device groups
    (``distributed.mesh.axis_devices``), as a list of G per-group tensors
    on the groups' devices.  Returns ``(reduced_grads, new_errors)`` in
    the same layout, each group's on its own device.  The int8 payload
    cuts cross-pod bytes 4x vs f32 (2x vs bf16)."""
    G = 1 if mesh is None else len(axis_devices(mesh, axis_name))
    if G == 1:
        fg, fe = leaves(grads), leaves(errors)
    else:
        fg, fe = _grouped(grads, G, "grads"), _grouped(errors, G, "errors")
        devices = check_devices(axis_devices(mesh, axis_name))
        for i in range(0, len(fg) + len(fe), G):
            got = check_devices([x.device for x in (fg + fe)[i:i + G]])
            if got != devices:
                raise ValueError(f"a leaf lies on {got}; the mesh's "
                                 f"{axis_name!r} groups are on {devices}")
    if len(fg) != len(fe):
        raise ValueError(f"{len(fg) // G} gradient leaves, "
                         f"{len(fe) // G} error leaves")
    out = [_one(fg[i:i + G], fe[i:i + G]) for i in range(0, len(fg), G)]
    return (unflatten(grads, iter([x for o in out for x in o[0]])),
            unflatten(grads, iter([x for o in out for x in o[1]])))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
