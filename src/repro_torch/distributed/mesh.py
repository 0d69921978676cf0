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
