"""The declarative DMA-schedule IR.

A kernel of the port that issues asynchronous copies (``cp.async`` into
shared memory) also *emits* its schedule as data: a ``dma_schedule()``
function beside the kernel returns a flat sequence of :class:`DmaOp`
records — copy start, copy wait, buffer-slot read/write — in the kernel's
program order.  The static analyzer (`repro_torch.analysis.dma_hazards`)
scans that sequence and proves the two safety properties a software
pipeline rests on:

  * every **read** of a staging slot is dominated by the **wait** of the
    copy that filled it (no read-before-arrival), and
  * no slot is **re-issued or overwritten** while a prior copy on it is
    still un-waited (no overwrite-while-in-flight), and every copy is
    drained before the kernel returns.

Double-buffered loops are periodic with period 2 (the slot cycle), so a
schedule unrolled for n ≥ 3 iterations covers every steady-state slot
interaction plus the prologue and drain.

The IR is the reference's (`repro/kernels/common.py`), op for op, so the
two packages' passes give the same findings on the same ops.  Its tier
names are the reference's too: ``"hbm"`` is device memory, the source of
every staging copy; ``"vmem"`` is launch-resident on-chip storage, on
the H100 the hot-vertex cache's block staged in shared memory at the
start of a launch.  The ``ScheduleBuilder`` emitters are the generic
loop shapes; a kernel composes them into its full schedule, and keeps the
emitter and its loop in the same diff.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple


class DmaOp(NamedTuple):
    """One event of a kernel's declared DMA schedule, in program order.

    ``kind``:
      * ``start`` — an async copy (id ``copy``) begins on ``(buffer,
        slot)``; the slot is busy until the matching ``wait``.
      * ``wait``  — the copy ``copy`` on ``(buffer, slot)`` completes.
      * ``read``  — kernel arithmetic consumes ``(buffer, slot)``; legal
        only if the latest inbound copy on the slot has been waited.
      * ``write`` — kernel arithmetic overwrites ``(buffer, slot)`` (the
        write-back staging pattern); legal only with no copy in flight
        on the slot.
      * ``visit`` — an output-block visit (a grid-scheduled kernel that
        revisits output blocks instead of issuing explicit copies);
        ``slot`` is the block id, ``first`` flags the declared
        init-vs-accumulate bit, ``live`` whether the visit actually
        accumulates.

    ``tier`` names the memory tier the op touches: ``"hbm"`` (the default
    — every async-copy staging buffer) or ``"vmem"`` for the hot-vertex
    cache block, which is launch-resident and therefore never the target
    of a copy.  A ``read`` with ``tier="vmem"`` needs no dominating wait
    (the data is always resident); a ``start`` on a vmem buffer is by
    definition a *phantom copy* — a hit path issuing device-memory
    traffic it was built to avoid — and the DMA pass flags it.
    """

    kind: str
    buffer: str
    slot: int
    copy: int = -1
    first: bool = False
    live: bool = True
    tier: str = "hbm"


class ScheduleBuilder:
    """Accumulates a kernel's :class:`DmaOp` sequence with globally unique
    copy ids (buffers are reused across loop instances — ids must not
    be)."""

    def __init__(self):
        self.ops: list[DmaOp] = []
        self._next_copy = 0

    # ---------------------------------------------------------- primitives

    def start(self, buffer: str, slot: int) -> int:
        cid = self._next_copy
        self._next_copy += 1
        self.ops.append(DmaOp("start", buffer, slot, cid))
        return cid

    def wait(self, buffer: str, slot: int, copy: int) -> None:
        self.ops.append(DmaOp("wait", buffer, slot, copy))

    def read(self, buffer: str, slot: int, tier: str = "hbm") -> None:
        self.ops.append(DmaOp("read", buffer, slot, tier=tier))

    def cache_read(self, buffer: str) -> None:
        """A hit-path read of the launch-resident hot-vertex cache: no
        copy, no wait — the declarative record of "this gather issued no
        device-memory traffic" that the DMA pass verifies cached
        schedules by."""
        self.read(buffer, 0, tier="vmem")

    def write(self, buffer: str, slot: int) -> None:
        self.ops.append(DmaOp("write", buffer, slot))

    def visit(self, buffer: str, block: int, first: bool,
              live: bool = True) -> None:
        self.ops.append(DmaOp("visit", buffer, block, first=first,
                              live=live))

    # ------------------------------------------------------------ patterns

    def gather_loop(self, buffer: str, n: int = 3) -> None:
        """The double-buffered gather shape: ``start(0)``; per item *i*,
        prefetch *i+1* into the other slot, then wait and consume *i*."""
        if n <= 0:
            return
        pend = {0: self.start(buffer, 0)}
        for i in range(n):
            if i + 1 < n:
                pend[i + 1] = self.start(buffer, (i + 1) % 2)
            self.wait(buffer, i % 2, pend.pop(i))
            self.read(buffer, i % 2)

    def pingpong_loop(self, buffers: Sequence[str], n: int = 3,
                      reads_per_chunk: int = 1) -> None:
        """The chunk-loop shape: several buffers (column + weight) advance
        through the same slot cycle together, chunk c+1's copies in flight
        while chunk c is consumed ``reads_per_chunk`` times."""
        if n <= 0:
            return
        pend = {0: [(b, self.start(b, 0)) for b in buffers]}
        for c in range(n):
            if c + 1 < n:
                pend[c + 1] = [(b, self.start(b, (c + 1) % 2))
                               for b in buffers]
            for b, cid in pend.pop(c):
                self.wait(b, c % 2, cid)
            for _ in range(reads_per_chunk):
                for b in buffers:
                    self.read(b, c % 2)

    def writeback_loop(self, buffer: str, n: int = 4) -> None:
        """The delayed-wait write-back shape: per record, reclaim the
        staging slot by waiting its two-records-old store, overwrite it,
        start the outbound copy; drain both slots at the end."""
        pend: list[int] = []
        for c in range(n):
            if c >= 2:
                self.wait(buffer, (c - 2) % 2, pend[c - 2])
            self.write(buffer, c % 2)
            pend.append(self.start(buffer, c % 2))
        for back in (2, 1):
            if n >= back:
                self.wait(buffer, (n - back) % 2, pend[n - back])


def schedule_buffers(ops: Sequence[DmaOp]) -> Tuple[str, ...]:
    """Distinct buffer names referenced by a schedule, in first-use order
    (the schedule table and diagnostics name buffers with this)."""
    seen: dict[str, None] = {}
    for op in ops:
        seen.setdefault(op.buffer)
    return tuple(seen)
