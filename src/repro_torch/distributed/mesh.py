"""The mesh of the sharded backend: N shards in G groups, each group's
shards stacked along a leading axis on one device, and the collectives
the sharded engine uses over the shards.

This is the port's counterpart of the reference's
``repro/distributed/compat.py`` (its ``shard_map`` shim): there, one
program runs per device of a JAX mesh and talks through
``jax.lax.psum`` / ``all_gather`` / ``all_to_all``; here, one controller
issues every group's work, every tensor of the sharded engine carries the
group's shards as its leading axis, and each collective takes the
per-group tensors and returns per-group tensors, copying blocks between
the groups' devices.  A stacked tensor (one group) is the G = 1 case, with
no copy: N shards are then the paper's N pipelines on one card.  Integer
collectives are exact; a float ``psum`` over several groups adds the
groups' partial sums in group order.

:class:`PartitionSpec` and :func:`shard_shape` are the placements of the
dry-run (``launch.specs``): a layout over a :class:`GridMesh` on the
``meta`` device, read for its per-device shapes and bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``num_shards`` shards over ``devices``: one device, or
    a sequence of G devices (one may repeat), where G divides
    ``num_shards``.  Group g holds the ``num_shards / G`` consecutive
    shards from ``g · num_shards / G`` on ``devices[g]``.  ``axis_name``
    names the shard axis (the reference's mesh axis, "ch" by default).
    Whether each device exists is checked where the mesh places tensors
    (:func:`check_devices`)."""

    num_shards: int
    devices: Any
    axis_name: str = "ch"

    def __post_init__(self):
        devs = self.devices
        if isinstance(devs, (str, torch.device)):
            devs = (devs,)
        devs = tuple(torch.device(d) for d in devs)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if self.num_shards <= 0 or self.num_shards % len(devs):
            raise ValueError(f"{len(devs)} device groups do not divide "
                             f"{self.num_shards} shards")
        object.__setattr__(self, "devices", devs)

    @property
    def device(self) -> torch.device:
        """The one device of a one-group mesh (raises for more groups)."""
        if len(self.devices) > 1:
            raise ValueError(f"the mesh spans {len(self.devices)} device "
                             "groups; read .devices")
        return self.devices[0]


def _resolve(d) -> torch.device:
    """``d`` as tensors report it (``cuda`` becomes the current card),
    raising where no such device exists."""
    d = torch.device(d)
    if d.type != "cuda":
        return d
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = d.index
    if index is None and count:
        index = torch.cuda.current_device()
    if index is None or index >= count:
        raise ValueError(f"no device {d}: {count} cards are visible")
    return torch.device("cuda", index)


def check_devices(devices: Sequence) -> tuple:
    """The devices a mesh names as tensors report them (``cuda`` becomes
    the current card); raises on one that does not exist."""
    return tuple(_resolve(d) for d in devices)


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


def reduce_first(parts: Sequence[torch.Tensor], op) -> torch.Tensor:
    """``op`` (``torch.sum``, ``torch.amax``, ``torch.any``) over the shard
    axis of every group's tensor, ``(1, ...)`` on the first group's
    device: each group reduces its own shards, then the G partial results
    are brought together and reduced in group order."""
    if len(parts) == 1:
        return op(parts[0], 0, keepdim=True)
    dev = parts[0].device
    return op(torch.cat([op(p, 0, keepdim=True).to(dev) for p in parts]), 0,
              keepdim=True)


def gather_first(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every group's tensor joined along the shard axis on the first
    group's device."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(parts[0].device) for p in parts])


def _reduce(x, op):
    if isinstance(x, torch.Tensor):
        return op(x, 0, keepdim=True).expand_as(x)
    total = reduce_first(x, op)
    return [total.to(p.device).expand_as(p) for p in x]


def psum(x):
    """Sum over the shard axis, broadcast back to every shard: a stacked
    ``(N, ...)`` tensor, or a list of per-group ``(n, ...)`` tensors (one
    list back, each on its group's device)."""
    return _reduce(x, torch.sum)


def pmax(x):
    """Max over the shard axis, broadcast back (as :func:`psum`)."""
    return _reduce(x, torch.amax)


def all_gather(x):
    """Every shard's block, seen by every shard: with the shards stacked,
    that is the stacked tensor itself, ``(N, ...)``; for a list of
    per-group blocks, every group gets the ``(N, ...)`` blocks of all
    shards in shard order, on its own device."""
    if isinstance(x, torch.Tensor):
        return x
    return [torch.cat([p.to(q.device) for p in x]) for q in x]


def _transpose(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    k = x.shape[1] // n
    y = x.reshape(n, n, k, *x.shape[2:]).transpose(0, 1)
    return y.reshape(x.shape)


def all_to_all(x):
    """Tiled all-to-all over the shard axis: shard ``s``'s send buffer of
    ``N·K`` rows is ``N`` buckets of ``K``, and shard ``d`` receives
    bucket ``d`` of every shard, in shard order.  A stacked ``(N, N·K,
    ...)`` buffer, seen as ``(N, N, K, ...)``, is transposed on its first
    two axes.  For a list of per-group ``(n, N·K, ...)`` buffers, each
    source group's buckets for destination group h are copied to h's
    device in source order, so h receives the same bits as the stacked
    transpose's rows of its shards."""
    if isinstance(x, torch.Tensor):
        return _transpose(x)
    if len(x) == 1:
        return [_transpose(x[0])]
    G, n = len(x), x[0].shape[0]
    N = G * n
    k = x[0].shape[1] // N
    tail = x[0].shape[2:]
    out = []
    for h, q in enumerate(x):
        # (n_src, N, K, ...) -> the n_dst buckets of group h, shard-major
        # on the receiving side: (n_dst, n_src, K, ...) per source group.
        blocks = [p.reshape(n, N, k, *tail)[:, h * n:(h + 1) * n]
                  .transpose(0, 1).to(q.device) for p in x]
        out.append(torch.cat(blocks, 1).reshape(q.shape))
    return out
