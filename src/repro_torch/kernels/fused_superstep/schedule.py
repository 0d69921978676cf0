"""The fused kernel's declared DMA schedule, and the trace that checks it.

Of the port's kernels only the fused superstep's reservoir kind (weighted
Node2Vec) issues asynchronous copies: in ``csrc/fused_superstep.cu``'s
``reservoir_scan`` a warp walks its run of (lane, chunk) items and streams
each item's candidate columns and edge weights from device memory into
one of two slots of its own in shared memory with ``cp.async``, item x+1's
copies in flight while item x is scored (``reservoir_chunk`` reads the
slot).  A slot holds one *window* of a chunk: its pairs b in [32j, 32j +
32), both draws of each (positions b and b + ceil(CH / 2)), so a chunk of
CH <= 64 candidates is one window and each item one staged unit, and a
larger chunk is ceil(min(CH / 2, n) / 32) windows in the same ping-pong.
:func:`dma_schedule` declares that loop op for op; the DMA pass
(`repro_torch.analysis.dma_hazards`) proves it hazard-free, and a traced
launch (``ops.trace_schedule``) shows on the card that the kernel issues
exactly it.

Items of a lane whose row the hot-vertex cache holds (the launch's cached
tier) issue no copy: staged in shared memory (``cache_words > 0``), they
read the block as ``cache.col`` / ``cache.wgt`` at tier ``"vmem"``; read
in place from device memory (``cache_words == 0``, the kernel's
``kGlobal`` tier), they are plain loads and appear in no schedule.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.kernels.common import DmaOp, ScheduleBuilder

#: The trace's op and buffer codes, as the kernel writes them (its kTr*
#: enums), and each buffer's tier.
TRACE_KINDS = ("start", "wait", "read")
TRACE_BUFFERS = (("ckcol", "hbm"), ("ckwgt", "hbm"), ("cache.col", "vmem"),
                 ("cache.wgt", "vmem"))
#: Header words of a trace buffer (int32): the warp traced and the
#: capacity in records (inputs); the records the warp issued (kept up to
#: the capacity), the items and windows it scanned, the next copy id.
TRACE_HEADER = 8
TRACE_WARP, TRACE_CAP, TRACE_RECORDS, TRACE_ITEMS, TRACE_WINDOWS = range(5)

#: The fused kinds that stage nothing (plain loads, one thread a lane).
_UNSTAGED = ("uniform", "alias", "metapath", "rejection_n2v")


class ScheduleTrace(NamedTuple):
    """What one warp of a traced launch issued: its ops in program order,
    and the (lane, chunk) items and staged or cached windows it scanned
    (summed over the launch's supersteps)."""

    ops: list
    items: int
    windows: int


def dma_schedule(kind: str = "reservoir_n2v", chunks: int = 3,
                 cached: bool = False, weighted: bool = True) -> list:
    """Declared schedule of one warp's reservoir scan over ``chunks``
    staged windows (its items at CH <= 64), in program order.

    * uncached: the ``ckcol`` / ``ckwgt`` ping-pong
      (`ScheduleBuilder.pingpong_loop`): window x+1's copies are started
      before window x's waits and reads; ``ckcol`` alone when the graph
      has no weights (every edge weighs 1.0);
    * ``cached=True``: the fully-hit representative, every item's row in
      the shared-memory block: ``cache_read("cache.col")`` (and
      ``"cache.wgt"`` when weighted) a window, no copy.  A warp whose items
      mix hit and missed lanes interleaves the two, and a miss item after
      a hit one is started one window ahead as here.

    The other fused kinds stage nothing: their schedule is empty.
    """
    if kind in _UNSTAGED:
        return []
    if kind != "reservoir_n2v":
        raise ValueError(f"unknown fused kind {kind!r}")
    b = ScheduleBuilder()
    if cached:
        for _ in range(chunks):
            b.cache_read("cache.col")
            if weighted:
                b.cache_read("cache.wgt")
    else:
        b.pingpong_loop(("ckcol", "ckwgt") if weighted else ("ckcol",),
                        chunks)
    return b.ops


def decode_trace(words) -> ScheduleTrace:
    """The :class:`ScheduleTrace` in a trace buffer's int32 ``words``;
    raises if the warp issued more records than the buffer kept."""
    words = np.asarray(words, dtype=np.int64)
    n, cap = int(words[TRACE_RECORDS]), int(words[TRACE_CAP])
    if n > cap:
        raise ValueError(f"the traced warp issued {n} records, past the "
                         f"trace's capacity of {cap}")
    ops = []
    for kind, buf, slot, copy in words[TRACE_HEADER:TRACE_HEADER + 4 * n
                                       ].reshape(n, 4).tolist():
        name, tier = TRACE_BUFFERS[buf]
        ops.append(DmaOp(TRACE_KINDS[kind], name, slot, copy, tier=tier))
    return ScheduleTrace(ops, int(words[TRACE_ITEMS]),
                         int(words[TRACE_WINDOWS]))
