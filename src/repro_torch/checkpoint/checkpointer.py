"""Checkpoints with an atomic commit, in the reference's on-disk format.

One directory per step —
  step_00000123.tmp/ -> (atomic rename) -> step_00000123/
    manifest.json   — step, and per leaf its path, file, shape, dtype
    arr_<k>.npy     — one file per leaf, copied to the host

A checkpoint holds a tree of the port's own structures: dicts (keys in
sorted order, as the reference's pytrees flatten them), NamedTuples
(fields in order), tuples and lists, with tensors (or numpy arrays) as
leaves.  :func:`restore` loads into the structure of a ``like`` tree and
puts each leaf on the dtype of the matching ``like`` leaf and on its
device, or on the device a ``shardings`` tree names (an elastic restart
onto a new mesh).  A table in row blocks over device groups
(`distributed.row_blocks.RowBlocks`) is one leaf: saved joined, slab by slab
on the host, and restored split into the layout of ``like``'s leaf, so
one checkpoint resumes at any number of groups.
bfloat16 has no numpy dtype, so such a leaf is stored as float32 (exact)
and cast back.

:func:`save` writes on the caller's thread (``blocking=True``) or on a
writer thread of its own: it then takes a snapshot of every leaf before
it returns (a card's tensor copied into pinned host memory on the
current stream of its device) and returns a :class:`PendingSave`, whose
``join()`` waits for the files and re-raises the writer's error.  Both
write the same files.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.row_blocks import RowBlocks


def flatten_with_paths(tree, prefix: str = ""):
    """``[(path, leaf)]`` of ``tree`` in the reference's leaf order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for name, v in zip(tree._fields, tree)
                for item in flatten_with_paths(v, f"{prefix}{name}/")]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_paths(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order, by the
    items of the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten(v, leaves) for v in like)
    return next(leaves)


def leaves(tree) -> list:
    """``tree``'s leaves in the reference's leaf order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``tree``'s structure with each leaf ``x`` replaced by ``fn(x, *ys)``,
    ``ys`` the matching leaves of ``rest`` (trees of the same structure)."""
    return unflatten(tree, iter([fn(*xs) for xs in zip(
        leaves(tree), *map(leaves, rest), strict=True)]))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, RowBlocks):
        return np.concatenate([_to_numpy(s) for s in leaf.slabs])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, (torch.Tensor, RowBlocks)):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _write(tmp: str, final: str, step: int, items) -> None:
    """Write ``items``, an iterable of (path, dtype name, array), into
    ``tmp`` with its manifest, then commit ``tmp`` as ``final``."""
    manifest = {"step": step, "leaves": []}
    for i, (path, dtype, arr) in enumerate(items):
        arr = np.require(arr, requirements="C")   # as jax's arrays
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["leaves"].append({"path": path, "file": f"arr_{i}.npy",
                                   "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit


class _Snapshot:
    """Host copies of a tree's leaves, issued on the caller's thread.

    A card's tensor is copied into a pinned host tensor of its dtype with
    ``non_blocking=True`` on the current stream of its device, and one
    event a device is recorded there after the tree's last copy; a
    :class:`RowBlocks` leaf is copied slab by slab, each on its own
    device's stream; a CPU tensor is cloned and any other leaf copied
    with numpy, at once.  The pinned tensors come from PyTorch's caching
    host allocator, which reuses a freed block once the copies recorded
    on it have finished.  :meth:`arrays` waits for the events and yields
    the leaves as numpy arrays, a bfloat16 leaf widened to float32 on
    the host (exact), as the blocking path stores it."""

    def __init__(self, flat):
        self.paths = [p for p, _ in flat]
        self.dtypes = [_dtype_name(leaf) for _, leaf in flat]
        self.pinned_bytes = 0
        self._devices = {}
        # Contiguous copies made on a card of strided leaves, held until
        # the events have fired.
        self._temporaries = []
        self._leaves = [self._copy(leaf) for _, leaf in flat]
        self._events = []
        for dev in self._devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self._events.append(ev)

    def _copy(self, leaf):
        if isinstance(leaf, RowBlocks):
            return [self._copy(s) for s in leaf.slabs]
        if not isinstance(leaf, torch.Tensor):
            return np.array(leaf)
        t = leaf.detach()
        if not t.is_cuda:
            return t.clone()
        if not t.is_contiguous():
            t = t.contiguous()
            self._temporaries.append(t)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.device(t.device):
            host.copy_(t, non_blocking=True)
        self._devices[t.device] = None
        self.pinned_bytes += host.numel() * host.element_size()
        return host

    @staticmethod
    def _numpy(x) -> np.ndarray:
        if isinstance(x, list):
            return np.concatenate([_Snapshot._numpy(s) for s in x])
        if isinstance(x, torch.Tensor):
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return x

    def arrays(self):
        for ev in self._events:
            ev.synchronize()
        self._temporaries.clear()
        for path, dtype, leaf in zip(self.paths, self.dtypes, self._leaves):
            yield path, dtype, self._numpy(leaf)


class PendingSave:
    """A checkpoint being written on a thread of its own (the reference
    returns the thread itself).  :meth:`join` waits for the commit and
    re-raises, on every call, the error the writer raised, where the
    reference's thread would print it and lose it.  ``pinned_bytes`` is
    the pinned host memory its snapshot holds until the write ends."""

    def __init__(self, write, pinned_bytes: int, name: str):
        self.pinned_bytes = pinned_bytes
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(write,),
                                        name=name, daemon=True)
        self._thread.start()

    def _run(self, write) -> None:
        try:
            write()
        except BaseException as e:   # re-raised by join()
            self._error = e

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self._error is not None:
            raise self._error


def save(ckpt_dir: str, step: int, tree: Any, blocking: bool = True):
    """Write a checkpoint.  Atomic: readers never see partial state.

    With ``blocking=True`` the files are written before it returns None.
    With ``blocking=False`` it takes a snapshot of ``tree``
    (:class:`_Snapshot`), starts a thread that writes the same files from
    it and returns that write's :class:`PendingSave`.

    Ordering: the snapshot of a card's tensor is ordered before any work
    issued later on the caller's current stream of that device, so a
    step issued there after ``save`` returns may update the tree in
    place.  Work on another stream that writes the tree must be fenced
    by the caller (``train_loop.run_pipelined``, whose producer runs on
    streams of its own, saves blocking, as the reference's does).  There
    is no fallback: a pinned allocation or a copy that fails raises
    here."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = flatten_with_paths(tree)
    if blocking:
        _write(tmp, final, step, ((path, _dtype_name(leaf), _to_numpy(leaf))
                                  for path, leaf in flat))
        return None
    snap = _Snapshot(flat)
    return PendingSave(lambda: _write(tmp, final, step, snap.arrays()),
                       snap.pinned_bytes, f"checkpoint-{step}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, shardings: Any = None):
    """Load step ``step`` into the structure of ``like``, each leaf as a
    tensor of the dtype of ``like``'s (numpy leaves stay numpy) on the
    device that ``shardings`` names for it: a tree of ``like``'s
    structure whose leaves are devices, or ``None`` to keep ``like``'s
    leaf's device (the whole tree ``None``: every leaf on ``like``'s) --
    the reference's re-sharding on restore, with one device a leaf (its
    ``SingleDeviceSharding``).  A :class:`RowBlocks` leaf of ``like``
    is restored in its layout (its ``shardings`` entry None).  ``like``
    may lie on ``meta``: only its structure, shapes and dtypes are
    read."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    refs = [leaf for _, leaf in flatten_with_paths(like)]
    if len(refs) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint {d} holds {len(manifest['leaves'])} "
                         f"leaves; the structure to restore into has "
                         f"{len(refs)}")
    places = [None] * len(refs)
    if shardings is not None:
        flat = flatten_with_paths(shardings)
        if [p for p, _ in flat] != [p for p, _ in flatten_with_paths(like)]:
            raise ValueError("shardings must have the structure of the "
                             "tree to restore into")
        places = [p for _, p in flat]
    loaded = []
    for m, ref, place in zip(manifest["leaves"], refs, places):
        arr = np.load(os.path.join(d, m["file"]))
        want = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
        if arr.shape != want:
            raise ValueError(f"checkpoint leaf {m['path']} has shape "
                             f"{list(arr.shape)}, expected {list(want)}")
        if isinstance(ref, RowBlocks):
            if place is not None:
                raise ValueError(f"checkpoint leaf {m['path']} is restored "
                                 "in the row blocks of the tree restored "
                                 "into; its shardings entry must be None")
            loaded.append(ref.like(torch.from_numpy(arr)))
        elif isinstance(ref, torch.Tensor):
            loaded.append(torch.from_numpy(arr).to(
                device=ref.device if place is None else place,
                dtype=ref.dtype))
        else:
            loaded.append(arr.astype(np.asarray(ref).dtype))
    return unflatten(like, iter(loaded))
