"""The kernels' own cost on the ``meta`` device, for the dry-run.

A wrapper given ``meta`` tensors launches nothing and runs no plain
version: it returns an empty ``meta`` tensor of its output's shape and
dtype (a shape rule) and records the FLOPs and bytes its kernel would
spend, by the formulas stated beside each wrapper.  PyTorch's
``FlopCounterMode`` and a dispatch mode see the aten ops a program runs;
these kernels are not aten ops, so the dry-run (``launch.dryrun``) opens
a :class:`KernelCost` around the program and adds its totals.  A CPU or
CUDA call records nothing.
"""
from __future__ import annotations

_OPEN: list = []


class KernelCost:
    """FLOPs, bytes and calls recorded by the kernels' ``meta`` shape
    rules while this context is open (contexts may nest)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.calls: dict = {}

    def __enter__(self) -> "KernelCost":
        _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.remove(self)


def record(kernel: str, flops: int, nbytes: int) -> None:
    """Add one ``meta`` call of ``kernel`` to every open
    :class:`KernelCost`."""
    for cost in _OPEN:
        cost.flops += int(flops)
        cost.bytes += int(nbytes)
        cost.calls[kernel] = cost.calls.get(kernel, 0) + 1
