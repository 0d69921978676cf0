"""Plain PyTorch versions of the one-hop walk-step kernels.

The wrappers in ``ops.py`` run these for tensors on the CPU; on the card
they are what the CUDA kernels are held against.  The clips mirror the
reference's exactly: the vertex clamps into range, an edge offset clamps
into ``[0, E-1]``, and a lane whose vertex has degree 0 gets ``-1``.
"""
from __future__ import annotations

import torch

from repro_torch.core.samplers import _uniform_index


def _row(v_curr, row_ptr):
    nv = row_ptr.shape[0] - 1
    v = torch.clamp(v_curr, 0, nv - 1).long()
    addr = row_ptr[v]
    return addr, row_ptr[v + 1] - addr


def _column(addr, idx, deg, col):
    if col.shape[0] == 0:
        return torch.full_like(deg, -1)
    e = torch.clamp(addr + idx, 0, col.shape[0] - 1).long()
    return torch.where(deg > 0, col[e], -1)


def walk_step_uniform_ref(v_curr, u_col, row_ptr, col):
    """(v_next, deg): a uniform pick from each lane's neighbor list."""
    addr, deg = _row(v_curr, row_ptr)
    return _column(addr, _uniform_index(deg, u_col), deg, col), deg


def walk_step_alias_ref(v_curr, u_col, u_acc, row_ptr, col, alias_prob,
                        alias_idx):
    """(v_next, deg): column draw k, keep it if ``u_acc < prob[addr+k]``,
    else take ``alias[addr+k]``."""
    addr, deg = _row(v_curr, row_ptr)
    k = _uniform_index(deg, u_col)
    if col.shape[0] == 0:
        return torch.full_like(deg, -1), deg
    ek = torch.clamp(addr + k, 0, col.shape[0] - 1).long()
    idx = torch.where(u_acc < alias_prob[ek], k, alias_idx[ek])
    return _column(addr, idx, deg, col), deg
