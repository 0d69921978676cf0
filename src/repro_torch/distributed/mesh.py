"""The mesh of the sharded backend: N shards stacked along a leading axis
on one device, and the three collectives the sharded engine uses over that
axis.

This is the port's counterpart of the reference's
``repro/distributed/compat.py`` (its ``shard_map`` shim): there, one
program runs per device of a JAX mesh and talks through
``jax.lax.psum`` / ``all_gather`` / ``all_to_all``; here, every tensor of
the sharded engine carries the shard as its leading axis, and each
collective is an exact tensor operation over that axis.  On one card, N
shards are the paper's N pipelines on one FPGA.

:class:`PartitionSpec` and :func:`shard_shape` are the placements of the
dry-run (``launch.specs``): a layout over a :class:`GridMesh` on the
``meta`` device, read for its per-device shapes and bytes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Mesh(NamedTuple):
    """A 1-D mesh of ``num_shards`` shards on ``device``; ``axis_name``
    names the shard axis (the reference's mesh axis, "ch" by default)."""

    num_shards: int
    device: torch.device
    axis_name: str = "ch"


class GridMesh(NamedTuple):
    """A mesh of several named axes, ``shape[i]`` positions along
    ``axis_names[i]``, stacked on ``device`` in row-major order as
    :class:`Mesh` stacks its shards (``runtime.elastic.build_mesh``'s
    multi-axis meshes)."""

    shape: tuple
    axis_names: tuple
    device: torch.device


def axis_size(m, axis: str) -> int:
    """The positions along ``axis`` of a :class:`Mesh` or
    :class:`GridMesh` (a ``jax.sharding.Mesh``'s ``shape[axis]``)."""
    if isinstance(m, Mesh):
        names, shape = (m.axis_name,), (m.num_shards,)
    else:
        names, shape = m.axis_names, m.shape
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}: {names}")
    return shape[names.index(axis)]


class PartitionSpec(tuple):
    """How a tensor is laid out over a mesh's axes, the port's
    ``jax.sharding.PartitionSpec``: one entry per leading dimension, each
    ``None`` (replicated), an axis name, or a tuple of axis names (the
    dimension split over their product, the first axis outermost).
    Dimensions past the last entry are replicated.  The dry-run
    (``launch.specs``) places its ``meta`` tensors with it; nothing is
    moved."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axes_size(m, axes) -> int:
    """The devices of ``m`` that the mesh axes ``axes`` span together (1
    for none)."""
    n = 1
    for a in axes:
        n *= axis_size(m, a)
    return n


def entry_axes(entry) -> tuple:
    """The mesh axes one entry of a :class:`PartitionSpec` names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, spec: PartitionSpec, m) -> tuple:
    """The per-device shape of a tensor of global ``shape`` laid out by
    ``spec`` over the mesh ``m`` (a :class:`GridMesh` or :class:`Mesh`):
    each dimension divided by the product of its axes' sizes, as
    ``NamedSharding(mesh, spec).shard_shape(shape)`` gives it, and like it
    raising where a dimension does not divide."""
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than {tuple(shape)} has "
                         "dimensions")
    used = [a for e in spec for a in entry_axes(e)]
    if len(set(used)) != len(used):
        raise ValueError(f"{spec} names a mesh axis twice")
    out = []
    for i, d in enumerate(shape):
        n = axes_size(m, entry_axes(spec[i] if i < len(spec) else None))
        if d % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} ({d}) does "
                             f"not divide over {spec[i]!r} ({n} shards)")
        out.append(d // n)
    return tuple(out)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the shard axis, broadcast back: ``(N, ...) -> (N, ...)``,
    every shard holding the total."""
    return x.sum(0, keepdim=True).expand_as(x)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Max over the shard axis, broadcast back: ``(N, ...) -> (N, ...)``."""
    return x.amax(0, keepdim=True).expand_as(x)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every shard's block, seen by every shard: with the shards stacked,
    that is the stacked tensor itself, ``(N, ...)``."""
    return x


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Tiled all-to-all over the shard axis: shard ``s``'s send buffer
    ``x[s]`` of ``N·K`` rows is ``N`` buckets of ``K``, and shard ``d``
    receives bucket ``d`` of every shard, in shard order.  The
    ``(N, N·K, ...)`` buffer, seen as ``(N, N, K, ...)``, is transposed
    on its first two axes."""
    n = x.shape[0]
    k = x.shape[1] // n
    y = x.reshape(n, n, k, *x.shape[2:]).transpose(0, 1)
    return y.reshape(x.shape)
