"""Wrappers of the one-hop walk-step CUDA kernels.

Each wrapper checks its inputs (device, dtype, shape, contiguity) and
raises on anything the kernel does not take.  For tensors on the CPU it
runs the plain version in ``ref.py``; for CUDA tensors it launches the
kernel on PyTorch's current stream or raises — there is no fallback.
``LAUNCHES`` counts kernel launches per wrapper (nothing else adds to it),
so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.walk_step import ref

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"walk_step_uniform": 0, "walk_step_alias": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "walk_step_uniform": [_P] * 6 + [_I] * 3 + [_P],
    "walk_step_alias": [_P] * 9 + [_I] * 3 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _entry(name: str):
    fn = getattr(build.load("walk_step"), name)
    fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return fn


def _check(args: dict, dtypes: dict) -> torch.device:
    """One device for all, the expected dtypes, 1-D contiguous, int32-sized;
    returns the device."""
    devices = {t.device for t in args.values()}
    if len(devices) != 1:
        raise ValueError(f"walk-step inputs span devices {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"walk-step inputs must be on cpu or cuda, got {device}")
    for name, t in args.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                             f"shape {tuple(t.shape)}")
        if t.shape[0] >= 2**31:
            raise ValueError(f"{name} has {t.shape[0]} entries; the kernels "
                             "index with int32")
    width = args["v_curr"].shape[0]
    for name in ("u_col", "u_acc"):
        if name in args and args[name].shape[0] != width:
            raise ValueError(f"{name} has {args[name].shape[0]} lanes, "
                             f"v_curr has {width}")
    if args["row_ptr"].shape[0] < 1:
        raise ValueError("row_ptr needs at least one entry (V+1 >= 1)")
    for name in ("alias_prob", "alias_idx"):
        if name in args and args[name].shape[0] != args["col"].shape[0]:
            raise ValueError(f"{name} must have one entry per edge")
    return device


def _launch(name, args, *pointers):
    width = args["v_curr"].shape[0]
    v_next = torch.empty_like(args["v_curr"])
    deg = torch.empty_like(args["v_curr"])
    if width == 0:
        return v_next, deg
    device = args["v_curr"].device
    with torch.cuda.device(device):
        rc = _entry(name)(*[t.data_ptr() for t in pointers],
                          v_next.data_ptr(), deg.data_ptr(), width,
                          args["row_ptr"].shape[0] - 1, args["col"].shape[0],
                          torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return v_next, deg


def walk_step_uniform(v_curr, u_col, row_ptr, col):
    """(v_next, deg) for a batch of walker lanes under a uniform pick."""
    args = dict(v_curr=v_curr, u_col=u_col, row_ptr=row_ptr, col=col)
    device = _check(args, dict(v_curr=torch.int32, u_col=torch.float32,
                               row_ptr=torch.int32, col=torch.int32))
    if device.type == "cpu":
        return ref.walk_step_uniform_ref(v_curr, u_col, row_ptr, col)
    return _launch("walk_step_uniform", args, v_curr, u_col, row_ptr, col)


def walk_step_alias(v_curr, u_col, u_acc, row_ptr, col, alias_prob,
                    alias_idx):
    """(v_next, deg) for a batch of walker lanes under Walker alias
    sampling (DeepWalk)."""
    args = dict(v_curr=v_curr, u_col=u_col, u_acc=u_acc, row_ptr=row_ptr,
                col=col, alias_prob=alias_prob, alias_idx=alias_idx)
    device = _check(args, dict(v_curr=torch.int32, u_col=torch.float32,
                               u_acc=torch.float32, row_ptr=torch.int32,
                               col=torch.int32, alias_prob=torch.float32,
                               alias_idx=torch.int32))
    if device.type == "cpu":
        return ref.walk_step_alias_ref(v_curr, u_col, u_acc, row_ptr, col,
                                       alias_prob, alias_idx)
    return _launch("walk_step_alias", args, v_curr, u_col, u_acc, row_ptr,
                   col, alias_prob, alias_idx)
