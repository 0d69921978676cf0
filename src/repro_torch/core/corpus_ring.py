"""Device-resident corpus ring: walks land in device memory, training reads
device memory.

The walks→embeddings hand-off is the first *consumer* of the walk engine.
Completed paths are scattered into a ring of ``capacity`` rows that stays
on the device for its whole life, and the batch sampler draws (center,
context, negatives) windows straight out of it, so no path is copied to
the host on the way from the walker to the SGNS step.

Ring economy
------------
A monotone ``tail`` counter is the only state besides the row buffers.
``append`` scatters ``n`` completed paths at slots ``(tail + i) %
capacity`` (the oldest rows are overwritten once the ring wraps) and
advances ``tail``; the sampler reads ``filled = min(tail, capacity)``
rows.  Training *samples* the ring with replacement rather than draining
it, so one walk is reused by many windows, as in an on-host DeepWalk
corpus.  ``tail`` is a 0-d int32 tensor on the ring's device, so neither
``append`` nor the sampler reads anything back to the host.

Determinism
-----------
Every batch is a pure function of ``(base_key, step, ring contents)``:
batch element ``i`` at grad step ``t`` draws from the task tuple
``(seed, qid=i, hop=t)`` on its own salt channels (``SALT_CORPUS`` for the
row/center/offset window draw, ``SALT_NEGATIVE`` for the negative ids),
through the same Threefry as the walks, so the batches are bit-equal to
the reference's (``repro.core.corpus_ring``).

Host-copy accounting
--------------------
Every code path that pulls walk paths to the host (the serial baseline's
round-trip) calls :func:`record_host_copy`, and :func:`no_host_copies`
raises at the first one recorded inside it.  PyTorch has no transfer
guard (the reference also arms ``jax.transfer_guard_device_to_host``), so
here the counter alone is the guard: a copy made without
``record_host_copy`` goes unnoticed.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.core import rng as task_rng
from repro_torch.core.rng import SALT_CORPUS, SALT_NEGATIVE

# Draw streams the corpus consumer adds to every sampler's task draws:
# `repro_torch.analysis`'s rng pass appends these to each kind's stream
# set (consumer (qid, hop) tuples overlap walk tasks under the round-0 key,
# so salt disjointness is the only separator).  Widths: the window draw is
# 3 uniforms (row, center, offset); negatives default to 5 a batch element
# (`SkipGramConfig.num_negatives`).
CORPUS_DRAW_STREAMS = (("corpus.window_draw", SALT_CORPUS, 3),
                       ("corpus.negatives", SALT_NEGATIVE, 5))


class CorpusRing(NamedTuple):
    """Device-resident walk corpus: a ring of completed path rows.

    ``paths`` is ``(capacity, path_width)`` int32 with ``-1`` padding (the
    engine's recording layout, ``path_width = max_hops + 1``); ``lengths``
    is the recorded vertex count per row; ``tail`` is the monotone append
    counter.
    """

    paths: torch.Tensor    # (R, P) int32, -1 pad
    lengths: torch.Tensor  # (R,) int32
    tail: torch.Tensor     # () int32 — rows ever appended

    @property
    def capacity(self) -> int:
        """R — ring rows (old walks are overwritten past this)."""
        return int(self.paths.shape[0])

    @property
    def path_width(self) -> int:
        """P — path buffer width (``max_hops + 1``)."""
        return int(self.paths.shape[1])


def init_ring(capacity: int, path_width: int, device=None) -> CorpusRing:
    """An empty ring on ``device`` (default the CPU) able to hold
    ``capacity`` walks of ``path_width``."""
    if capacity <= 0:
        raise ValueError(f"corpus ring capacity must be positive, got "
                         f"{capacity}")
    if path_width <= 0:
        raise ValueError(f"path_width must be positive, got {path_width}")
    return CorpusRing(
        paths=torch.full((capacity, path_width), -1, dtype=torch.int32,
                         device=device),
        lengths=torch.zeros((capacity,), dtype=torch.int32, device=device),
        tail=torch.zeros((), dtype=torch.int32, device=device),
    )


def append(ring: CorpusRing, paths: torch.Tensor,
           lengths: torch.Tensor) -> CorpusRing:
    """Scatter ``n`` completed walks into the ring (device to device); a
    new ring is returned and the old one is left as it was.

    Rows land at slots ``(tail + i) % capacity``, so appending never needs
    a host round-trip and wrapping retires the oldest walks.  ``paths`` may
    be narrower than the ring rows (a shorter hop budget); it is
    right-padded with ``-1``.
    """
    n, p = paths.shape
    R, P = ring.paths.shape
    if n > R:
        raise ValueError(
            f"appending {n} walks to a {R}-row ring would overwrite rows "
            "within one append; raise ring_capacity")
    if p > P:
        raise ValueError(
            f"walk paths are {p} wide but the ring holds {P}-wide rows")
    paths = paths.to(device=ring.paths.device, dtype=torch.int32)
    if p < P:
        paths = torch.nn.functional.pad(paths, (0, P - p), value=-1)
    slots = ((ring.tail + torch.arange(n, dtype=torch.int32,
                                       device=ring.tail.device)) % R).long()
    return CorpusRing(
        paths=ring.paths.index_copy(0, slots, paths),
        lengths=ring.lengths.index_copy(
            0, slots, lengths.to(device=ring.lengths.device,
                                 dtype=torch.int32)),
        tail=ring.tail + n,
    )


def filled(ring: CorpusRing) -> torch.Tensor:
    """Rows currently holding a walk (``min(tail, capacity)``), a 0-d
    tensor on the ring's device."""
    return torch.clamp(ring.tail, max=ring.paths.shape[0])


def make_batch_sampler(num_vertices: int, batch_size: int, window: int,
                       num_negatives: int):
    """Build the corpus consumer: ring → (center, context, negatives).

    The returned ``sample(ring, base_key, step)`` draws one SGNS batch
    deterministically on the ring's device: element ``i`` folds
    ``(qid=i, hop=step)`` and draws 3 uniforms on ``SALT_CORPUS`` (ring
    row, center position, window offset) plus ``num_negatives`` on
    ``SALT_NEGATIVE``.  Returns ``(centers, contexts, negatives, mask)``,
    int32 (B,), (B,), (B, K) and bool (B,): ``mask`` is False where the
    window fell off the walk (or the ring is empty), so the loss skips the
    pair and the batch keeps its shape.
    """
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if num_negatives <= 0:
        raise ValueError(f"num_negatives must be positive, got "
                         f"{num_negatives}")

    def sample(ring: CorpusRing, base_key, step: int):
        device = ring.paths.device
        qid = torch.arange(batch_size, dtype=torch.int32, device=device)
        hop = torch.full((batch_size,), int(step), dtype=torch.int32,
                         device=device)
        u = task_rng.task_uniforms(base_key, qid, hop, 3, SALT_CORPUS)
        avail = filled(ring)
        # Ring row + center position (clamped draws: floor(u·n) < n).
        row = torch.minimum((u[:, 0] * avail).to(torch.int32),
                            torch.clamp(avail - 1, min=0)).long()
        ln = torch.clamp(ring.lengths[row], min=1)
        center = torch.minimum((u[:, 1] * ln).to(torch.int32), ln - 1)
        # Window offset in {-window..-1, 1..window} (never 0).
        j = torch.clamp((u[:, 2] * (2 * window)).to(torch.int32),
                        max=2 * window - 1)
        off = j - window
        off = torch.where(off >= 0, off + 1, off)
        ctx_pos = center + off
        valid = (ctx_pos >= 0) & (ctx_pos < ln) & (avail > 0)
        ctx_pos = torch.minimum(torch.clamp(ctx_pos, min=0), ln - 1)
        centers = ring.paths[row, center.long()]
        contexts = ring.paths[row, ctx_pos.long()]
        mask = valid & (centers >= 0) & (contexts >= 0)
        un = task_rng.task_uniforms(base_key, qid, hop, num_negatives,
                                    SALT_NEGATIVE)
        negatives = torch.clamp((un * num_vertices).to(torch.int32),
                                max=num_vertices - 1)
        return (torch.clamp(centers, min=0), torch.clamp(contexts, min=0),
                negatives, mask)

    return sample


# ---------------------------------------------------- host-copy accounting

_copies = 0
_guard_depth = 0


def record_host_copy(site: str = "") -> None:
    """Note one host round-trip of walk paths (the serial baseline).

    Raises when inside :func:`no_host_copies` — that is how the
    no-per-step-host-transfer property is pinned by a test instead of
    trusted to prose.
    """
    global _copies
    _copies += 1
    if _guard_depth > 0:
        raise RuntimeError(
            f"walk paths copied to the host under a no_host_copies guard "
            f"(site: {site or 'unknown'}) — the device-resident pipeline "
            "must hand paths to the corpus ring without a host round-trip")


def host_copies() -> int:
    """Total path host round-trips recorded since import."""
    return _copies


@contextlib.contextmanager
def no_host_copies():
    """Raise at the first walk-path host round-trip recorded in this scope
    (the counter is the whole guard; see the module docstring)."""
    global _guard_depth
    _guard_depth += 1
    try:
        yield
    finally:
        _guard_depth -= 1
