"""Plain PyTorch version of the segment-sum kernel.

``index_add_`` on the CPU adds the rows in position order, starting from
0.0 — the order the CUDA kernel keeps over the stably sorted ids — so the
kernel equals this function, run on CPU copies of its inputs, bit for
bit.  On the card ``index_add_`` adds with atomics in no fixed order, so
there it agrees only within a tolerance.  Ids outside ``[0, S)`` are
dropped (sent to a spare row), as ``jax.ops.segment_sum`` drops them.
"""
from __future__ import annotations

import torch


def segment_sum_ref(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[e] over segment_ids[e] == s``; (S, D)."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    rows = torch.where(valid, segment_ids, num_segments).long()
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, rows, data)[:num_segments]
