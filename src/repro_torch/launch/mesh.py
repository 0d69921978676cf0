"""Production mesh construction (the multi-pod dry-run's meshes), the
reference's ``repro.launch.mesh``.

The single-pod mesh is 16 x 16 = 256 devices over ``("data", "model")``;
multi-pod adds a leading ``pod`` axis (2 pods = 512 devices).  Both are
:class:`~repro_torch.distributed.mesh.GridMesh`es on the ``meta`` device:
the dry-run places ``meta`` tensors on them and allocates nothing.

The roofline constants are one NVIDIA H100 SXM's published peaks (NVIDIA's
H100 Tensor Core GPU data sheet, dense, without sparsity), for the card
that ``nvidia-smi`` names "NVIDIA H100 80GB HBM3" at a power limit of
700.00 W.  They are data-sheet peaks, not measurements: a card set below
700 W runs slower under load.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.mesh import GridMesh


def make_production_mesh(*, multi_pod: bool = False) -> GridMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return GridMesh(shape, axes, torch.device("meta"))


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def flat_axes(multi_pod: bool):
    """All mesh axes: graph and recsys bulk dims shard over every device."""
    return ("pod", "data", "model") if multi_pod else ("data", "model")


# One H100 SXM's data-sheet peaks for the roofline.
PEAK_FLOPS_BF16 = 989e12     # dense bfloat16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
ICI_BW = 4.5e11              # NVLink 4 bytes/s (450 GB/s) each way per GPU
