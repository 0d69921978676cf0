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
synchronize of the state's device, a no-op on the CPU.  Checkpoints are
written synchronously: the reference's ``async_checkpoint`` writes on a
thread, but the port's AdamW updates the state in place, so a thread
would read tensors the next step is changing.  The knob is kept and
ignored.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import tempfile
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import checkpointer


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
    """Wait for the device of ``tree``'s first tensor leaf (none on the
    CPU)."""
    for _, leaf in checkpointer.flatten_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    async_checkpoint: bool = True   # accepted; saves block (module doc)
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
                checkpointer.save(cfg.ckpt_dir, step, state)
    finally:
        # Preemption / completion checkpoint.
        checkpointer.save(cfg.ckpt_dir, step, state)
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
    ``overlap=True`` issues round ``r+1``'s walk production *before* round
    ``r``'s grad steps, and touches the host only at the round fence;
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


def run_pipelined(produce_fn: Callable, append_fn: Callable,
                  sample_fn: Callable, step_fn: Callable,
                  state: Any, ring: Any, cfg: PipelineConfig,
                  start_step: int = 0, rounds_done: int = 0,
                  batch_hook: Optional[Callable] = None):
    """Producer/consumer training loop.

    * ``produce_fn(round) -> walks`` — run one walk round (device tensors;
      a pure function of the round index, so a resumed run regenerates
      exactly the rounds it needs).
    * ``append_fn(ring, walks) -> ring`` — land the walks in the corpus
      ring (device to device when overlapped; the serial baseline's
      append is where the host round-trip lives).
    * ``sample_fn(ring, step) -> batch`` — the corpus consumer.
    * ``step_fn(state, batch) -> (state, aux)`` — the grad step.

    With ``cfg.overlap`` the loop issues round ``r+1``'s production right
    after appending round ``r``, before any of round ``r``'s grad steps,
    the reference's order of issue.  Steps are checkpointed
    (``{"state", "ring"}``) every ``ckpt_every`` steps; resume via
    :func:`resume_pipeline`, passing ``rounds_done`` so rounds already in
    the ring are not appended again.  Returns ``(state, ring, step,
    history, watchdog)``.
    """
    if cfg.rounds <= 0 or cfg.steps_per_round <= 0:
        raise ValueError(
            f"rounds ({cfg.rounds}) and steps_per_round "
            f"({cfg.steps_per_round}) must be positive")
    total = cfg.rounds * cfg.steps_per_round
    spr = cfg.steps_per_round
    watchdog = StragglerWatchdog(cfg.straggler_factor)
    history = []
    pending = None
    pending_round = -1
    step = start_step
    while step < total:
        r = step // spr
        # Ingest every round up to and including r (a fresh run appends
        # exactly round r here; a resumed run may need to catch up).
        while rounds_done <= r:
            if pending_round != rounds_done:
                pending = produce_fn(rounds_done)
                pending_round = rounds_done
            ring = append_fn(ring, pending)
            pending = None
            rounds_done += 1
        # Overlap: round r+1's walks are issued ahead of round r's grad
        # steps (the producer side of the pipeline).
        nxt = rounds_done
        if cfg.overlap and nxt == r + 1 and nxt < cfg.rounds:
            pending = produce_fn(nxt)
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
            # Bounded pipeline: fence on the consumer state at the round
            # boundary, so the queue of issued work cannot grow without
            # bound.
            block_until_ready(state)
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
