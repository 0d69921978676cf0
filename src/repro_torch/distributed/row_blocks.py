"""A table split by rows over device groups, as the reference's
vocab-sharded ``train_embeddings`` lays out its tables (``NamedSharding(
mesh, P(ax, None))``).

:class:`RowBlocks` holds a 2-D table as G slabs of equal rows, slab g on
its own device: the table's rows in order are slab 0's, then slab 1's,
and so on.  The table is also ``shards`` blocks of equal rows, each slab
a whole number of them (the N shards of a mesh in G groups, group g's
shards contiguous): the optimizer sums the table's squared norm block by
block in shard order (``optim.adamw.global_norm``), so the sum does not
depend on G.  Gathers and updates run slab by slab on the slab's device
(``models.layers.gather_rows``, ``optim.adamw.apply_updates``), which
send each id to the slab :meth:`RowBlocks.owner` names; only
:meth:`RowBlocks.whole` joins the slabs, as a copy.

This module imports nothing of the package, so the checkpointer can take
a :class:`RowBlocks` as one leaf (joined on the host on save, split again
on restore into the layout of the tree it restores into).
"""
from __future__ import annotations

from typing import Sequence

import torch


class RowBlocks:
    """A 2-D table in ``len(slabs)`` slabs of equal rows, slab g on
    ``slabs[g].device``, and ``shards`` blocks of equal rows (G divides
    ``shards``)."""

    __slots__ = ("slabs", "shards")

    def __init__(self, slabs: Sequence[torch.Tensor], shards: int):
        slabs = tuple(slabs)
        if not slabs or shards % len(slabs):
            raise ValueError(f"{len(slabs)} slabs do not divide {shards} "
                             "shards")
        if any(s.dim() != 2 or s.shape != slabs[0].shape
               or s.dtype != slabs[0].dtype for s in slabs):
            raise ValueError("the slabs must be 2-D tensors of one shape and "
                             "dtype, got "
                             + ", ".join(f"{tuple(s.shape)} {s.dtype}"
                                         for s in slabs))
        if slabs[0].shape[0] % (shards // len(slabs)):
            raise ValueError(f"a slab's {slabs[0].shape[0]} rows are not "
                             f"{shards // len(slabs)} shards of equal rows")
        self.slabs = slabs
        self.shards = int(shards)

    @classmethod
    def split(cls, table: torch.Tensor, devices: Sequence,
              shards: int) -> "RowBlocks":
        """``table`` (rows divisible by ``shards``) as one slab a device of
        ``devices``, each slab copied from the rows it owns: the table is
        never whole on any of ``devices``."""
        G = len(devices)
        if table.dim() != 2 or shards % G or table.shape[0] % shards:
            raise ValueError(f"a table of shape {tuple(table.shape)} does "
                             f"not split into {shards} shards in {G} groups")
        rows = table.shape[0] // G
        return cls([table[g * rows:(g + 1) * rows].to(d, copy=True)
                    for g, d in enumerate(devices)], shards)

    @property
    def shape(self) -> torch.Size:
        rows, dim = self.slabs[0].shape
        return torch.Size((rows * len(self.slabs), dim))

    @property
    def dtype(self) -> torch.dtype:
        return self.slabs[0].dtype

    @property
    def devices(self) -> tuple:
        """The slabs' devices, one a group."""
        return tuple(s.device for s in self.slabs)

    def owner(self, ids: torch.Tensor) -> torch.Tensor:
        """The slab that holds each of ``ids`` (the table's row ids): row r
        lies in slab ``r // rows`` of ``rows`` a slab; an id out of range
        takes the first or the last slab."""
        rows = self.slabs[0].shape[0]
        return torch.div(ids, rows, rounding_mode="floor").clamp_(
            0, len(self.slabs) - 1)

    def shard_blocks(self) -> list:
        """The ``shards`` blocks of rows in shard order, each a view of its
        slab on the slab's device."""
        per = self.shards // len(self.slabs)
        rows = self.slabs[0].shape[0] // per
        return [s[i * rows:(i + 1) * rows] for s in self.slabs
                for i in range(per)]

    def map(self, fn) -> "RowBlocks":
        """``fn`` applied to every slab, in the same layout."""
        return RowBlocks([fn(s) for s in self.slabs], self.shards)

    def like(self, table: torch.Tensor) -> "RowBlocks":
        """A whole ``table`` of this shape split into this layout (the same
        devices, dtype and shards)."""
        if tuple(table.shape) != tuple(self.shape):
            raise ValueError(f"a table of shape {tuple(table.shape)} cannot "
                             f"take the layout of {tuple(self.shape)}")
        return RowBlocks.split(table.to(self.dtype), self.devices,
                               self.shards)

    def whole(self, device=None) -> torch.Tensor:
        """The slabs joined into one new tensor on ``device`` (default: the
        first slab's)."""
        device = self.slabs[0].device if device is None else device
        return torch.cat([s.to(device) for s in self.slabs])

    def __repr__(self) -> str:
        return (f"RowBlocks(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"shards={self.shards})")


def tensors(x) -> list:
    """The tensors of ``x``: its slabs, or ``[x]`` for a tensor."""
    return list(x.slabs) if isinstance(x, RowBlocks) else [x]


def devices_of(x) -> tuple:
    """The devices of ``x``: its slabs', or a tensor's one."""
    return x.devices if isinstance(x, RowBlocks) else (x.device,)
