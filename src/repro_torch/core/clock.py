"""The port's one wall clock, for observability timers.

The engine and the Walker time the host's blocking reads (``Chunk.sync_s``,
``Drain``, ``WalkStream.host_read_s``) and the kernel build times itself.
Those values are summed and reported; no branch of the walk path reads
them.  They all read :func:`now` here, called as ``clock.now()`` so that a
test can replace it in one place and show that walks and stats do not
depend on it.  The determinism pass (`repro_torch.analysis.determinism`)
allows the wall clock in this module and bans it in the rest of the walk
path.
"""
from __future__ import annotations

import time


def now() -> float:
    """Seconds on a monotonic wall clock (``time.perf_counter``)."""
    return time.perf_counter()
