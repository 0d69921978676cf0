"""Wrapper of the embedding-bag CUDA kernel.

``embedding_bag(indices, table, weights=None)`` checks its inputs (device,
dtype, shape, contiguity) and raises on anything the kernel does not take.
For tensors on the CPU it runs the plain version in ``ref.py``; for CUDA
tensors it launches the kernel on PyTorch's current stream or raises —
there is no fallback.  ``meta`` tensors (the dry-run) get the output's
shape and the kernel's cost (``kernels/meta_cost.py``), and nothing runs;
any other device raises.  ``LAUNCHES`` counts kernel launches (nothing else
adds to it), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta_cost
from repro_torch.kernels.embedding_bag import ref

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES = {"embedding_bag": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int

def reset_launches() -> None:
    LAUNCHES["embedding_bag"] = 0


def _entry():
    fn = build.load("embedding_bag").embedding_bag
    fn.argtypes, fn.restype = [_P] * 4 + [_I] * 5 + [_P], ctypes.c_int
    return fn


def _check(indices, table, weights) -> torch.device:
    args = {"indices": indices, "table": table}
    if weights is not None:
        args["weights"] = weights
    devices = {t.device for t in args.values()}
    if len(devices) != 1:
        raise ValueError(f"embedding_bag inputs span devices "
                         f"{sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"embedding_bag inputs must be on cpu, cuda or "
                         f"meta, got {device}")
    want = {"indices": torch.int32, "table": torch.float32,
            "weights": torch.float32}
    for name, t in args.items():
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor, got "
                             f"shape {tuple(t.shape)}")
        if device.type != "meta" and t.numel() >= 2**31:
            raise ValueError(f"{name} has {t.numel()} entries; the kernel "
                             "indexes bags and rows with int32")
    if indices.shape[1] < 1:
        raise ValueError("a bag needs at least one slot (H >= 1)")
    if table.shape[0] < 1:
        raise ValueError("the table needs at least one row")
    if weights is not None and weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} must match indices "
                         f"{tuple(indices.shape)}")
    return device


def vectorized(table: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel reads and writes rows as float4: D % 4 == 0 and
    both base pointers 16-byte aligned."""
    return table.shape[1] % 4 == 0 and table.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0


def _meta(indices, table, weights) -> torch.Tensor:
    """The shape rule on ``meta``: an empty (B, D) output, and the
    kernel's cost recorded: 2·B·H·D FLOPs (a multiply and an add a slot
    and column); bytes: the B·H gathered rows of D, the ids, the weights
    when given, and the (B, D) output, 4 bytes an entry.  The int32 limit
    on entries is not checked here: the dry-run's tensors have a mesh's
    global shapes, and a launch sees one device's shard of them."""
    bags, hots = indices.shape
    dim = table.shape[1]
    slots = bags * hots
    meta_cost.record("embedding_bag", 2 * slots * dim,
                     4 * (slots * dim + slots * (2 if weights is not None
                                                 else 1) + bags * dim))
    return torch.empty((bags, dim), dtype=table.dtype, device="meta")


def embedding_bag(indices: torch.Tensor, table: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """EmbeddingBag: (B, H) int32 indices (pad -1), (R, D) float32 table,
    optional (B, H) float32 weights (default 1) -> (B, D) weighted bag
    sums, accumulated in h order (``ref.py``)."""
    device = _check(indices, table, weights)
    if device.type == "meta":
        return _meta(indices, table, weights)
    if device.type == "cpu":
        return ref.embedding_bag_ref(indices, table, weights)
    bags, hots = indices.shape
    rows, dim = table.shape
    out = torch.empty((bags, dim), dtype=table.dtype, device=device)
    if bags == 0 or dim == 0:
        return out
    vec = vectorized(table, out)
    with torch.cuda.device(device):
        rc = _entry()(indices.data_ptr(),
                      None if weights is None else weights.data_ptr(),
                      table.data_ptr(), out.data_ptr(), bags, hots, rows, dim,
                      int(vec), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError "
                           f"{rc}")
    LAUNCHES["embedding_bag"] += 1
    return out
