"""Stateless per-task random number generation (counter-based Threefry).

The draw for a task is a pure function of the task tuple
``(seed, epoch, query_id, hop, salt)``: the seed's key pair is folded with
each field in turn through the Threefry-2x32 block cipher, and the folded
key encrypts a counter per draw.  No generator object carries state, so a
task may run on any lane, at any superstep, and still draw the same
numbers — the property that makes lanes interchangeable.

The arithmetic is bit-equal to ``repro.core.rng`` (pinned by
``tests/test_torch_rng.py``).  PyTorch on the CPU has no uint32 add, shift
or compare, so every 32-bit word is held in an int64 tensor and masked back
to 32 bits after each operation that can carry out of the word.  A negative
int32 id (the -1 of an idle lane) wraps to its two's-complement word, as a
uint32 cast does.
"""
from __future__ import annotations

import numpy as np
import torch

# Salt channels for decorrelated draws within one hop (values shared with
# the reference's registry, so both packages draw the same streams).
SALT_COLUMN = 0   # which neighbor column
SALT_ACCEPT = 1   # alias/rejection accept
SALT_STOP = 2     # PPR termination draw
SALT_CORPUS = 3   # SGNS batch sampler: ring row, center, window offset
SALT_NEGATIVE = 4  # SGNS negative ids
SALT_CHUNK0 = 8   # reservoir chunk c draws at SALT_CHUNK0 + c

_MASK = 0xFFFFFFFF
# Threefry-2x32 key-schedule parity constant (Salmon et al., SC'11).
_THREEFRY_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _word(x):
    """A 32-bit word as int64 in [0, 2**32): Python ints and tensors of any
    integer dtype; negative values wrap as a uint32 cast does."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """One Threefry-2x32 block: encrypt counter ``(x0, x1)`` under key
    ``(k0, k1)``; returns the two output words (int64 in [0, 2**32)).

    Arguments broadcast against each other; at least one must be a tensor.
    """
    k0, k1, x0, x1 = _word(k0), _word(k1), _word(x0), _word(x1)
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in_pair(k0, k1, data):
    """Fold a 32-bit datum into the key pair ``(k0, k1)``: the datum is
    encrypted as the counter ``(0, data)``."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(data)
    data = _word(data)
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def task_key_pair(k0, k1, query_id, hop, salt, epoch=None):
    """Per-task key pair from (seed[, epoch], query_id, hop, salt).  Epoch
    0 (or None) folds nothing, so a closed batch derives from the 3-tuple
    alone.  ``salt`` is an int or a per-task tensor (a reservoir chunk's
    salt is its lane's chunk index)."""
    if epoch is not None:
        s0, s1 = fold_in_pair(k0, k1, epoch)
        use_salted = epoch.to(torch.int32) > 0
        k0 = torch.where(use_salted, s0, _word(k0))
        k1 = torch.where(use_salted, s1, _word(k1))
    k0, k1 = fold_in_pair(k0, k1, query_id)
    k0, k1 = fold_in_pair(k0, k1, hop)
    salt = _word(salt)
    if not isinstance(salt, torch.Tensor):
        salt = torch.full_like(k0, salt)
    return fold_in_pair(k0, k1, salt)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit random words -> U[0, 1) float32: keep the top 23 bits as the
    mantissa of a float in [1, 2), subtract 1 (float32 throughout)."""
    f = ((_word(bits) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def _counter_pairs(num: int):
    """Counter words for ``num`` 32-bit draws, split into (x0, x1) halves
    (an odd count pads one zero counter)."""
    pairs = (num + 1) // 2
    x0 = np.arange(pairs, dtype=np.int64)
    x1 = np.where(np.arange(pairs) + pairs < num, np.arange(pairs) + pairs, 0)
    return x0, x1.astype(np.int64)


def key_bits(k0, k1, num: int):
    """``num`` 32-bit words from a key pair.  ``k0``/``k1`` may carry
    leading batch dims; the draw axis is appended last."""
    x0, x1 = _counter_pairs(num)
    k0, k1 = _word(k0), _word(k1)
    device = k0.device if isinstance(k0, torch.Tensor) else None
    x0 = torch.as_tensor(x0, device=device)
    x1 = torch.as_tensor(x1, device=device)
    if isinstance(k0, torch.Tensor):
        k0, k1 = k0[..., None], k1[..., None]
    y0, y1 = threefry2x32(k0, k1, x0, x1)
    return torch.cat([y0, y1], dim=-1)[..., :num]


def stream_key(seed, epoch: int = 0) -> torch.Tensor:
    """Base key pair (a (2,) int64 tensor of 32-bit words) for epoch
    ``epoch`` of a stream rooted at ``seed``.

    An integer seed keys as the pair ``(0, seed mod 2**32)``; a key pair
    passes through.  Epoch 0 is the root key itself; epoch ``e > 0`` folds
    ``e`` into it.
    """
    if isinstance(seed, (int, np.integer)):
        base = torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)
    else:
        base = _word(torch.as_tensor(np.asarray(seed).astype(np.int64)))
        if base.shape != (2,):
            raise ValueError(
                f"a key seed must be a pair of 32-bit words, got shape "
                f"{tuple(base.shape)}")
    if epoch == 0:
        return base
    k0, k1 = fold_in_pair(int(base[0]), int(base[1]), epoch)
    return torch.stack([k0, k1])


def task_fold(base_key, query_id: torch.Tensor, hop: torch.Tensor, salt=0,
              epoch=None) -> torch.Tensor:
    """One key pair per task from (seed[, epoch], query_id, hop, salt): a
    (W, 2) int64 tensor of 32-bit words.  ``epoch`` 0 (or None) folds
    nothing, so a closed batch derives from the 3-tuple alone.
    ``base_key`` is a key pair: a (2,) tensor or a pair of ints."""
    k0, k1 = (int(k) for k in base_key)
    k0, k1 = task_key_pair(k0, k1, query_id, hop, salt, epoch)
    return torch.stack([k0, k1], dim=-1)


def task_uniforms(base_key, query_id: torch.Tensor, hop: torch.Tensor,
                  num: int, salt=0, epoch=None) -> torch.Tensor:
    """(W, num) iid U[0,1) float32 draws, one row per task.  ``base_key`` is
    a key pair: a (2,) tensor or a pair of ints."""
    k0, k1 = (int(k) for k in base_key)
    k0, k1 = task_key_pair(k0, k1, query_id, hop, salt, epoch)
    return bits_to_uniform(key_bits(k0, k1, num))
