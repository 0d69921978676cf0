"""Elastic scaling: rebuild the mesh when the healthy-device set changes
and re-shard training state from the latest checkpoint, the reference's
``repro.runtime.elastic``.

A pod loss at 2×16×16 degrades to 1×16×16: ``plan_remesh`` picks the
largest supported mesh ≤ the healthy device count, and a restart reloads
the checkpoint onto the new mesh's devices (checkpoints are
mesh-agnostic; ``checkpointer.restore``'s ``shardings``, see
`checkpoint/checkpointer.py`).  Straggler-driven demotion uses the
watchdog counts from `runtime/train_loop.py`.

``plan_remesh`` and ``ElasticController`` are the reference's plain
Python.  ``build_mesh`` lays the mesh's positions over the devices given
as the reference lays a ``jax.sharding.Mesh`` over them, in groups where
fewer devices than positions are given (`distributed/mesh.py`'s ``Mesh``
for a 1-D shape, the form the sharded backend reads, and ``GridMesh``
for more axes): one controller issues every group's work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.distributed.mesh import GridMesh, Mesh, card_groups

SUPPORTED_MESHES: Tuple[Tuple[int, ...], ...] = (
    (2, 16, 16), (1, 16, 16), (16, 16), (8, 16), (4, 16), (2, 16), (16,),
    (8,), (4,), (2,), (1,),
)


def plan_remesh(healthy_devices: int,
                prefer_axes=("pod", "data", "model")) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest supported mesh that fits the healthy device count."""
    for shape in SUPPORTED_MESHES:
        n = 1
        for s in shape:
            n *= s
        if n <= healthy_devices:
            axes = prefer_axes[-len(shape):]
            return shape, tuple(axes)
    raise RuntimeError("no devices left")


def build_mesh(shape: Sequence[int], axes: Sequence[str], devices=None):
    """A mesh of ``shape`` named ``axes`` over ``devices[:n]`` (n the
    positions), as the reference's ``np.asarray(devices[:n])
    .reshape(shape)``: one position a device where n devices are given,
    else G groups of n / G consecutive positions in row-major order, G
    the devices given (it must divide n).  Default: one group a visible
    card (``distributed.mesh.card_groups``); with no card visible,
    ``cuda`` unchecked, as ``Mesh`` takes it (the device is checked where
    tensors are placed)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                         "differ in length")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    devices = list(devices)[:n] if devices is not None \
        else card_groups(n)
    if len(shape) == 1:
        return Mesh(n, devices, axes[0])
    return GridMesh(shape, tuple(axes), devices)


@dataclasses.dataclass
class ElasticController:
    """Decides restart actions from health signals."""
    min_devices: int = 1
    max_straggler_ratio: float = 0.05

    def decide(self, healthy: int, total_steps: int,
               straggler_steps: int) -> Optional[str]:
        if healthy < self.min_devices:
            return "abort"
        if straggler_steps > self.max_straggler_ratio * max(total_steps, 1):
            return "remesh"       # persistent straggler: demote and rebalance
        return None
