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
onto a new mesh).
bfloat16 has no numpy dtype, so such a leaf is stored as float32 (exact)
and cast back.  Writes are synchronous.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


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
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save(ckpt_dir: str, step: int, tree: Any) -> None:
    """Write a checkpoint.  Atomic: readers never see partial state."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(flatten_with_paths(tree)):
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["leaves"].append({"path": path, "file": f"arr_{i}.npy",
                                   "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit


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
    ``SingleDeviceSharding``).  ``like`` may lie on ``meta``: only its
    structure, shapes and dtypes are read."""
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
        if isinstance(ref, torch.Tensor):
            loaded.append(torch.from_numpy(arr).to(
                device=ref.device if place is None else place,
                dtype=ref.dtype))
        else:
            loaded.append(arr.astype(np.asarray(ref).dtype))
    return unflatten(like, iter(loaded))
