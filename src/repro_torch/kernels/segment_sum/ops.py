"""Wrapper of the segment-sum CUDA kernel.

``segment_sum(data, segment_ids, num_segments)`` sums the rows of ``data``
(E, D) float32 by int32 segment id into a dense (S, D) result; empty
segments are exactly 0 and ids outside ``[0, S)`` are dropped.  On the
card each call makes three kernel launches on PyTorch's current stream,
with no sort and no host round-trip: a fill (zeros into the result), a
link that chains each position into its segment's list (the list's head
kept in the segment's own zeroed row until its sum replaces it), and a
pass that sums each non-empty segment's rows in ascending position (see
``csrc/segment_sum.cu``).  So the result is
deterministic and equals the plain version (``ref.py``) run on the CPU
bit for bit.  :class:`SegmentSumOp` holds ids that are already sorted
(checked once) and runs the same kernels.

The reference's host tiling plan (``plan_tiles``: which row blocks each
edge tile's one-hot matmul touches) has no counterpart.  Only float32 is
taken; bfloat16 raises ``TypeError`` (ROADMAP queue 3).

Each wrapper checks its inputs and raises on anything the kernel does
not take.  For tensors on the CPU it runs the plain version; for CUDA
tensors it launches the kernels or raises — there is no fallback.
``meta`` tensors (the dry-run) get the output's shape and the kernel's
cost (``kernels/meta_cost.py``), and nothing runs; any other device
raises.
``LAUNCHES`` counts wrapper calls that launched the kernels, one a call
(its three launches together; nothing else adds to it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta_cost
from repro_torch.kernels.segment_sum import ref

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES = {"segment_sum": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["segment_sum"] = 0


def _entry():
    fn = build.load("segment_sum").segment_sum
    fn.argtypes, fn.restype = [_P] * 5 + [_I] * 4 + [_P], ctypes.c_int
    return fn


def _check_ids(segment_ids, num_segments) -> None:
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_ids must be torch.int32, got "
                        f"{segment_ids.dtype}")
    if segment_ids.dim() != 1 or not segment_ids.is_contiguous():
        raise ValueError(f"segment_ids must be a contiguous 1-D tensor, got "
                         f"shape {tuple(segment_ids.shape)}")
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"num_segments must be in [0, 2**31), got "
                         f"{num_segments}")


def _check_data(data, segment_ids) -> torch.device:
    if data.device != segment_ids.device:
        raise ValueError(f"segment_sum inputs span devices {data.device} and "
                         f"{segment_ids.device}")
    if data.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"segment_sum inputs must be on cpu, cuda or meta, "
                         f"got {data.device}")
    if data.dtype != torch.float32:
        raise TypeError(f"data must be torch.float32, got {data.dtype} (the "
                        "kernel sums in float32 only)")
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous 2-D tensor, got shape "
                         f"{tuple(data.shape)}")
    if data.shape[0] != segment_ids.shape[0]:
        raise ValueError(f"data has {data.shape[0]} rows, segment_ids "
                         f"{segment_ids.shape[0]}")
    if data.device.type != "meta" and data.numel() >= 2**31:
        raise ValueError(f"data has {data.numel()} entries; the kernel "
                         "indexes rows with int32")
    return data.device


def _launch(data, segment_ids, num_segments) -> torch.Tensor:
    dim = data.shape[1]
    out = torch.empty((num_segments, dim), dtype=data.dtype,
                      device=data.device)
    if num_segments == 0 or dim == 0:
        return out
    vec = dim % 4 == 0 and data.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    # Scratch: each position's successor in its chain, and whether a
    # later position displaced it from the chain's head.
    n = max(data.shape[0], 1)
    nxt = torch.empty((n,), dtype=torch.int32, device=data.device)
    linked = torch.empty((n,), dtype=torch.uint8, device=data.device)
    with torch.cuda.device(data.device):
        rc = _entry()(data.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
                      nxt.data_ptr(), linked.data_ptr(), data.shape[0],
                      num_segments, dim, int(vec),
                      torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {rc}")
    LAUNCHES["segment_sum"] += 1
    return out


def _meta(data, num_segments) -> torch.Tensor:
    """The shape rule on ``meta``: an empty (S, D) output, and the
    kernel's cost recorded: E·D FLOPs (an add a row and column); bytes:
    the (E, D) data, the E ids and the (S, D) output, 4 bytes an entry.
    The int32 limit on entries is not checked here: the dry-run's tensors
    have a mesh's global shapes, and a launch sees one device's shard."""
    rows, dim = data.shape
    meta_cost.record("segment_sum", rows * dim,
                     4 * (rows * dim + rows + num_segments * dim))
    return torch.empty((num_segments, dim), dtype=data.dtype, device="meta")


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(S, D) segment sums of ``data`` (E, D) by ``segment_ids`` (E,), in
    any order of the ids."""
    _check_ids(segment_ids, num_segments)
    device = _check_data(data, segment_ids)
    if device.type == "meta":
        return _meta(data, num_segments)
    if device.type == "cpu":
        return ref.segment_sum_ref(data, segment_ids, num_segments)
    return _launch(data, segment_ids, num_segments)


class SegmentSumOp:
    """Segment sum for a fixed vector of ascending segment ids (checked
    once, here), reused across calls with new data."""

    def __init__(self, segment_ids: torch.Tensor, num_segments: int):
        _check_ids(segment_ids, num_segments)
        if bool((segment_ids[1:] < segment_ids[:-1]).any()):
            raise ValueError("segment_ids must be sorted ascending")
        self.seg = segment_ids
        self.num_segments = int(num_segments)

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        device = _check_data(data, self.seg)
        if device.type == "meta":
            return _meta(data, self.num_segments)
        if device.type == "cpu":
            return ref.segment_sum_ref(data, self.seg, self.num_segments)
        return _launch(data, self.seg, self.num_segments)
