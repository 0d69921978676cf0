"""Plain PyTorch version of the embedding-bag kernel.

The wrapper in ``ops.py`` runs it for tensors on the CPU; on the card it
is what the CUDA kernel is held against, bit for bit.  The sum runs in h
order: slot 0 is the rounded product ``row * w``, each later slot a fused
multiply-add ``fma(row, w, sum)`` with one rounding, which is what XLA
makes of the reference's ``acc + row * w`` (so the reference's kernel, run
in interpret mode on the CPU, gives the same bits).  PyTorch has no
float32 FMA on every device, so :func:`fma` computes it exactly in
float64: the product of two float32 values is exact there, and the sum is
rounded to odd before the one rounding to float32.
"""
from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with a single rounding (an IEEE fma).

    In float64 the product is exact; the sum ``s`` is rounded to nearest,
    its error ``e`` recovered exactly (Knuth's TwoSum), and ``s`` moved to
    the round-to-odd result (truncated toward zero, last bit set when
    inexact), which rounds to float32 as the exact sum would.  Non-finite
    sums pass through."""
    p = a.double() * b.double()
    c = c.double()
    s = c + p
    t = s - c
    e = (c - (s - t)) + (p - t)
    inexact = (e != 0) & torch.isfinite(e)
    bits = s.view(torch.int64)
    bits = torch.where(inexact & ((e > 0) != (s > 0)), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float64).float()


def embedding_bag_ref(indices: torch.Tensor, table: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b] = sum_h w[b, h] * table[clamp(idx[b, h], 0, R - 1)]``, with
    ``w = 0`` where ``idx < 0`` and ``w = 1`` when ``weights`` is None."""
    rows = indices.clamp(0, table.shape[0] - 1).long()
    w = torch.ones_like(indices, dtype=table.dtype) if weights is None \
        else weights
    w = torch.where(indices >= 0, w, torch.zeros_like(w))
    out = table[rows[:, 0]] * w[:, :1]
    for h in range(1, indices.shape[1]):
        out = fma(table[rows[:, h]], w[:, h:h + 1], out)
    return out
