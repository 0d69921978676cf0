"""Pipeline parallelism (the GPipe schedule), the reference's
``repro.distributed.pipeline``.

An optional ``pipe`` mesh axis splits the layer stack into stages;
microbatches stream through the stages, each stage handing its output
to the next.  Bubble fraction = (P-1)/(M+P-1), the classic GPipe result;
M >= 4·P keeps the bubble under 20%.

The reference runs one program a stage inside ``shard_map`` and hands
activations on with ``ppermute``.  Here the P stages lie in the groups of
the mesh's ``pipe`` axis (`distributed/mesh.py`): group g holds P/G
consecutive stages, their parameters on its device (:func:`place_stages`
puts them there once).  One controller issues every tick: each group
applies its stages one after another (not batched, so that a stage may
launch the port's kernels, and every grouping of the same stages gives
the same bits), and ``mesh.ppermute`` hands each stage's output to the
next stage, a shift of the group's stage buffer within a group and a
copy to the next group's device between groups.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.checkpoint.checkpointer import leaves, tree_map, unflatten
from repro_torch.distributed.mesh import (axis_devices, axis_size,
                                          check_devices, ppermute)


@dataclasses.dataclass(frozen=True)
class StageGroups:
    """Stage parameters placed on a ``pipe`` axis's groups: ``groups[g]``
    is a tree of group g's consecutive stages (a leading axis of P/G on
    every leaf) on ``devices[g]``."""

    groups: tuple
    devices: tuple


def place_stages(params_stacked, mesh, axis: str = "pipe") -> StageGroups:
    """Each group's block of ``params_stacked`` (a tree with a leading
    stage axis of P, the positions of ``axis``) on the group's device:
    a view where the block is on that device already, else a copy of the
    block alone.  Place a large tree once and pass the result to every
    :func:`pipeline_apply`."""
    n_stages = axis_size(mesh, axis)
    devices = check_devices(axis_devices(mesh, axis))
    k = n_stages // len(devices)
    for a in leaves(params_stacked):
        if a.shape[0] != n_stages:
            raise ValueError(f"a stage leaf of shape {tuple(a.shape)} does "
                             f"not lead with the {n_stages} stages of "
                             f"axis {axis!r}")
    return StageGroups(tuple(
        tree_map(lambda a, g=g, d=d: a[g * k:(g + 1) * k].to(d),
                 params_stacked)
        for g, d in enumerate(devices)), devices)


def _stages(tree) -> list:
    """One tree a stage of a group's tree (one ``unbind`` a leaf)."""
    rows = [a.unbind(0) for a in leaves(tree)]
    return [unflatten(tree, iter(r)) for r in zip(*rows)]


def pipeline_apply(stage_fn: Callable, params_stacked, x_microbatches,
                   mesh, axis: str = "pipe"):
    """Run x through P stages living on the ``pipe`` axis.

    stage_fn(stage_params, x) -> x  (one stage's compute)
    params_stacked: tree with a leading stage axis (P, ...), or its
    :func:`place_stages` on the same mesh and axis.
    x_microbatches: (M, mb, ...) microbatched input.
    Returns (M, mb, ...) outputs (after all P stages), on the last
    group's device: the reference returns the last stage's buffer, the
    only one of its stages' buffers that is valid.

    The reference's schedule: T = M + P - 1 ticks; in tick t stage 0
    ingests microbatch min(t, M - 1) (the last one again once they run
    out), every other stage the previous stage's output of tick t - 1
    (zeros in the first ticks), and the last stage emits microbatch
    t - (P - 1).  The reference's ring shift also hands the last stage's
    output to stage 0, which ignores it; here that block is not sent.
    """
    n_stages = axis_size(mesh, axis)
    placed = params_stacked if isinstance(params_stacked, StageGroups) \
        else place_stages(params_stacked, mesh, axis)
    if placed.devices != check_devices(axis_devices(mesh, axis)):
        raise ValueError(f"the stages are placed on {placed.devices}; the "
                         f"mesh's {axis!r} axis is on "
                         f"{axis_devices(mesh, axis)}")
    groups = [_stages(tree) for tree in placed.groups]
    M = x_microbatches.shape[0]
    xs = x_microbatches.to(placed.devices[0])
    bufs = [torch.zeros((len(st), *xs.shape[1:]), dtype=xs.dtype, device=d)
            for st, d in zip(groups, placed.devices)]
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    outs = []
    for t in range(M + n_stages - 1):
        ys = []
        for g, stages in enumerate(groups):
            ys.append(torch.stack([
                stage_fn(p, xs[min(t, M - 1)] if g == j == 0 else bufs[g][j])
                for j, p in enumerate(stages)]))
        if t >= n_stages - 1:
            outs.append(ys[-1][-1])
        if t < M + n_stages - 2:
            bufs = ppermute(ys, perm)
    return torch.stack(outs)


def gpipe_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
