"""Fault-tolerant training runtime: the generic loop (:func:`run`) of the
model zoo's launcher and the producer/consumer loop (:func:`run_pipelined`)
of the walks→embeddings pipeline.

* checkpoint every N steps (atomic commits), at the end, and on SIGTERM
  (preemption-safe: the loop stops after the step in flight);
* resume from the latest checkpoint: the data pipeline's state is the
  step counter (and the corpus ring), so a restart is bit-identical;
* straggler watchdog: EWMA of step wall time; steps slower than
  ``factor × EWMA`` are logged and counted;
* a history record every ``log_every`` steps (and at every straggler),
  also written as JSON lines to ``metrics_path``.

Waiting for the device (``block_until_ready`` in the reference) is a
synchronize of the caller's current stream on the state's device, a no-op
on the CPU.  :func:`run_pipelined` with ``overlap`` runs the walk producer
on a worker thread of its own, under a CUDA stream of its own on each card
it touches (:class:`ProducerStreams`), while the caller's thread issues
the grad steps.

With ``async_checkpoint`` (the default), :func:`run` writes its periodic
checkpoints on a writer thread, as the reference's does: AdamW updates
the state in place, so ``checkpointer.save(..., blocking=False)`` first
copies every leaf on a card into pinned host memory on the current
stream of its device, ahead of the next step's kernels there, and the
files are written from that snapshot.  At most one save is in flight
(joined before the next); the final save blocks.  :func:`run_pipelined`
saves blocking, as the reference's does: its producer writes on streams
of its own.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import signal
import tempfile
import time
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.distributed.row_blocks import RowBlocks, devices_of


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, alpha: float = 0.1):
        self.factor = factor
        self.alpha = alpha
        self.ewma = None
        self.straggler_steps = 0

    def observe(self, dt: float) -> bool:
        is_straggler = False
        if self.ewma is not None and dt > self.factor * self.ewma:
            self.straggler_steps += 1
            is_straggler = True
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


def block_until_ready(tree) -> None:
    """Wait for the work issued so far on the caller's current stream on
    the device of ``tree``'s first tensor leaf, or on each slab's device
    of a first leaf in row blocks (nothing on the CPU).  Work on other
    streams, such as an overlapped producer's, runs on."""
    for _, leaf in checkpointer.flatten_with_paths(tree):
        if isinstance(leaf, (torch.Tensor, RowBlocks)):
            for d in dict.fromkeys(devices_of(leaf)):
                if d.type == "cuda":
                    torch.cuda.current_stream(d).synchronize()
            return


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    async_checkpoint: bool = True   # periodic saves on a writer thread
    metrics_path: Optional[str] = None


def run(step_fn: Callable, state: Any, batch_fn: Callable,
        cfg: TrainLoopConfig, start_step: int = 0):
    """Generic loop: ``state, aux = step_fn(state, batch)``; ``state`` is
    a tree (params, opt_state, ...) and ``batch_fn(step)`` gives the
    step's device batch.  Returns ``(state, step, history, watchdog)``."""
    os.makedirs(cfg.ckpt_dir, exist_ok=True)
    stop = {"flag": False}

    def _on_sigterm(signum, frame):
        stop["flag"] = True

    old = signal.signal(signal.SIGTERM, _on_sigterm)
    watchdog = StragglerWatchdog(cfg.straggler_factor)
    metrics_f = open(cfg.metrics_path, "a") if cfg.metrics_path else None
    pending = None
    step = start_step
    history = []
    try:
        while step < cfg.total_steps and not stop["flag"]:
            t0 = time.perf_counter()
            batch = batch_fn(step)
            state, aux = step_fn(state, batch)
            block_until_ready(state)
            dt = time.perf_counter() - t0
            straggler = watchdog.observe(dt)
            step += 1
            if step % cfg.log_every == 0 or straggler:
                rec = {"step": step, "dt_s": dt,
                       "straggler": straggler,
                       **{k: float(v) for k, v in (aux or {}).items()}}
                history.append(rec)
                if metrics_f:
                    metrics_f.write(json.dumps(rec) + "\n")
                    metrics_f.flush()
            if step % cfg.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = checkpointer.save(
                    cfg.ckpt_dir, step, state,
                    blocking=not cfg.async_checkpoint)
    finally:
        try:
            if pending is not None:
                pending.join()      # re-raises a failed write
        finally:
            # Preemption / completion checkpoint.
            checkpointer.save(cfg.ckpt_dir, step, state, blocking=True)
            if metrics_f:
                metrics_f.close()
            signal.signal(signal.SIGTERM, old)
    return state, step, history, watchdog


def resume_or_init(ckpt_dir: str, init_state: Any, shardings=None):
    """Restart: load the latest checkpoint into ``init_state``'s structure
    (each leaf on its dtype, and on the device ``shardings`` names for
    it, or on ``init_state``'s leaf's where that is ``None``: see
    ``checkpointer.restore``) or return the fresh state, with the step to
    start from."""
    last = checkpointer.latest_step(ckpt_dir)
    if last is None:
        return init_state, 0
    return checkpointer.restore(ckpt_dir, last, init_state, shardings), last


@dataclasses.dataclass
class PipelineConfig:
    """Knobs for the producer/consumer loop (`run_pipelined`).

    ``rounds`` walk-production rounds × ``steps_per_round`` grad steps.
    ``overlap=True`` hands round ``r+1``'s walk production to the
    producer's thread *before* round ``r``'s grad steps are issued, so the
    two run at once, and touches the host only at the round fence;
    ``overlap=False`` is the serial baseline: block on the walks,
    round-trip them through the host, then train.
    """

    rounds: int = 4
    steps_per_round: int = 16
    overlap: bool = True
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0          # 0 = no mid-training checkpoints
    log_every: int = 0           # 0 = no loss history (no host reads)
    straggler_factor: float = 3.0


# The producer's stream a card, made at first use and kept: the caching
# allocator keeps a pool of blocks a stream, so a stream made anew for
# every run would start each run with an empty pool.
_PRODUCER_STREAMS: dict = {}


class ProducerStreams:
    """The walk producer's own CUDA stream on each card in ``devices``
    (none on the CPU); the first device is the ring's, where the consumer
    takes each round.

    The producer's thread issues a round inside :meth:`scope`, which makes
    these streams its current ones, so its launches and its allocations
    lie on them.  A stream that cannot be made raises: nothing falls back
    to the consumer's stream."""

    def __init__(self, devices: Sequence = ()):
        cards = []
        for d in map(torch.device, devices):
            if d.type == "cuda":
                if d.index is None:
                    d = torch.device("cuda", torch.cuda.current_device())
                if d not in cards:
                    cards.append(d)
        self.devices = tuple(cards)
        for d in cards:
            if d not in _PRODUCER_STREAMS:
                _PRODUCER_STREAMS[d] = torch.cuda.Stream(d)
        self.streams = tuple(_PRODUCER_STREAMS[d] for d in cards)

    @contextlib.contextmanager
    def scope(self):
        """These streams as the calling thread's current ones."""
        with contextlib.ExitStack() as stack:
            for s in self.streams:
                stack.enter_context(torch.cuda.stream(s))
            yield

    def issued(self) -> list:
        """An event a card on the caller's current stream: the work that
        the caller has issued so far, which the producer waits for."""
        return [torch.cuda.current_stream(d).record_event()
                for d in self.devices]

    def wait(self, events) -> None:
        for s, e in zip(self.streams, events):
            s.wait_event(e)

    def done(self):
        """The event that ends a round on the ring's card (None on the
        CPU)."""
        return self.streams[0].record_event() if self.streams else None

    def hand_over(self, walks, done) -> None:
        """Order the caller's stream on the ring's card after the round
        (``done``), and keep the round's tensors from going back to the
        producer's stream's pool before the caller's stream has read
        them."""
        if done is None:
            return
        consumer = torch.cuda.current_stream(self.devices[0])
        consumer.wait_event(done)
        for t in walks:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(consumer)


class _Issued:
    """A round produced in the caller's thread (the serial baseline)."""

    def __init__(self, walks):
        self._walks = walks

    def result(self):
        return self._walks


class _InFlight:
    """A round on the producer's thread.  :meth:`result` waits for it,
    re-raises the producer's exception, and hands the walks over to the
    caller's stream (:meth:`ProducerStreams.hand_over`)."""

    def __init__(self, future, streams: ProducerStreams):
        self._future = future
        self._streams = streams

    def result(self):
        walks, done = self._future.result()
        self._streams.hand_over(walks, done)
        return walks


class _Producer:
    """``produce_fn`` on one worker thread of its own, one round at a time,
    under ``streams`` (:class:`ProducerStreams`).  Each round first waits,
    on the producer's streams, for the work the caller had issued when it
    asked for the round; it ends with the event the caller's stream waits
    on.  :meth:`close` joins the thread."""

    def __init__(self, produce_fn: Callable, streams: ProducerStreams):
        self._fn = produce_fn
        self._streams = streams
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="walk-producer")

    def submit(self, rnd: int) -> _InFlight:
        issued = self._streams.issued()
        return _InFlight(self._pool.submit(self._round, rnd, issued),
                         self._streams)

    def _round(self, rnd: int, issued):
        with self._streams.scope():
            self._streams.wait(issued)
            walks = self._fn(rnd)
            return walks, self._streams.done()

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def run_pipelined(produce_fn: Callable, append_fn: Callable,
                  sample_fn: Callable, step_fn: Callable,
                  state: Any, ring: Any, cfg: PipelineConfig,
                  start_step: int = 0, rounds_done: int = 0,
                  batch_hook: Optional[Callable] = None,
                  streams: Optional[ProducerStreams] = None):
    """Producer/consumer training loop.

    * ``produce_fn(round) -> walks`` — run one walk round, a tuple of
      tensors (a pure function of the round index, so a resumed run
      regenerates exactly the rounds it needs).
    * ``append_fn(ring, walks) -> ring`` — land the walks in the corpus
      ring (device to device when overlapped; the serial baseline's
      append is where the host round-trip lives).
    * ``sample_fn(ring, step) -> batch`` — the corpus consumer.
    * ``step_fn(state, batch) -> (state, aux)`` — the grad step.

    With ``cfg.overlap`` every round is produced on one worker thread of
    the loop's own, under ``streams`` (:class:`ProducerStreams`; none, as
    on the CPU, runs the same thread without streams).  The loop asks for
    round ``r+1`` right after appending round ``r`` and then issues round
    ``r``'s grad steps while ``r+1``'s walks are produced, the
    reference's order of issue; at most one round is in flight.  It takes
    a round (waits for it, re-raises the producer's exception, orders its
    stream after the round's event) only to append it, and fences its own
    stream at each round's end.  The thread is joined on every way out.
    Steps are checkpointed (``{"state", "ring"}``) every ``ckpt_every``
    steps; resume via :func:`resume_pipeline`, passing ``rounds_done`` so
    rounds already in the ring are not appended again.  Returns
    ``(state, ring, step, history, watchdog)``.
    """
    if cfg.rounds <= 0 or cfg.steps_per_round <= 0:
        raise ValueError(
            f"rounds ({cfg.rounds}) and steps_per_round "
            f"({cfg.steps_per_round}) must be positive")
    total = cfg.rounds * cfg.steps_per_round
    spr = cfg.steps_per_round
    watchdog = StragglerWatchdog(cfg.straggler_factor)
    history = []
    producer = (_Producer(produce_fn, streams or ProducerStreams())
                if cfg.overlap else None)

    def issue(rnd: int):
        if producer is None:
            return _Issued(produce_fn(rnd))
        return producer.submit(rnd)

    pending = None
    pending_round = -1
    step = start_step
    try:
        while step < total:
            r = step // spr
            # Ingest every round up to and including r (a fresh run appends
            # exactly round r here; a resumed run may need to catch up).
            while rounds_done <= r:
                if pending_round != rounds_done:
                    pending = issue(rounds_done)
                    pending_round = rounds_done
                ring = append_fn(ring, pending.result())
                pending = None
                rounds_done += 1
            # Overlap: round r+1's walks are produced while round r's grad
            # steps are issued (the producer side of the pipeline).
            nxt = rounds_done
            if cfg.overlap and nxt == r + 1 and nxt < cfg.rounds:
                pending = issue(nxt)
                pending_round = nxt
            end = min(total, (r + 1) * spr)
            while step < end:
                t0 = time.perf_counter()
                batch = sample_fn(ring, step)
                if batch_hook is not None:
                    batch_hook(step, batch)
                state, aux = step_fn(state, batch)
                step += 1
                if cfg.log_every and step % cfg.log_every == 0:
                    block_until_ready(state)
                    dt = time.perf_counter() - t0
                    history.append({"step": step, "dt_s": dt,
                                    "straggler": watchdog.observe(dt),
                                    **{k: float(v)
                                       for k, v in (aux or {}).items()}})
                if (cfg.ckpt_dir and cfg.ckpt_every
                        and step % cfg.ckpt_every == 0 and step < total):
                    checkpointer.save(cfg.ckpt_dir, step,
                                      {"state": state, "ring": ring})
            if cfg.overlap:
                # Bounded pipeline: fence on the consumer's stream at the
                # round boundary, so the queue of issued work cannot grow
                # without bound; round r+1's walks run on behind it.
                block_until_ready(state)
    finally:
        if producer is not None:
            producer.close()
    if cfg.ckpt_dir:
        checkpointer.save(cfg.ckpt_dir, step, {"state": state, "ring": ring})
    return state, ring, step, history, watchdog


def resume_pipeline(ckpt_dir: Optional[str], init_state: Any, init_ring: Any):
    """Latest pipelined checkpoint (state, ring, step) or the fresh pair."""
    if not ckpt_dir:
        return init_state, init_ring, 0
    last = checkpointer.latest_step(ckpt_dir)
    if last is None:
        return init_state, init_ring, 0
    payload = checkpointer.restore(ckpt_dir, last,
                                   {"state": init_state, "ring": init_ring})
    return payload["state"], payload["ring"], last
