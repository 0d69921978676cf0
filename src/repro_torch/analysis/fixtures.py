"""Deliberately broken inputs proving each pass actually catches its
hazard class.

Each fixture builds a *mutated* copy of a real declaration (a valid phase
program with one phase moved, a valid stream set with one salt reused, the
real CUDA header with one constant changed, ...) and runs the single pass
that owns the invariant.  ``python -m repro_torch.analysis --fixture NAME``
exits non-zero when findings are produced, and the tests assert every
fixture trips, so a checker that silently stops detecting a hazard class
fails the build.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Callable, Dict, List

from repro_torch.analysis import (determinism, dma_hazards, residency,
                                  rng_collisions)
from repro_torch.analysis.report import Finding
from repro_torch.core.phase_program import DrawStream, _default_spec, lower
from repro_torch.core.rng import SALT_CHUNK0, SALT_COLUMN, SALT_STOP
from repro_torch.kernels.common import DmaOp
from repro_torch.kernels.fused_superstep.schedule import dma_schedule

_WALK_COMMON = "kernels/csrc/walk_common.cuh"


def _replace_phase(prog, i, **changes):
    phases = list(prog.phases)
    phases[i] = dataclasses.replace(phases[i], **changes)
    return dataclasses.replace(prog, phases=tuple(phases))


# ----------------------------------------------------------- rng fixtures


def rng_duplicate_salt() -> List[Finding]:
    """Two scalar streams of one task on the same salt channel — e.g. a
    second draw phase added without registering a new salt."""
    streams = (DrawStream("fixture.draw_a", SALT_COLUMN, 2),
               DrawStream("fixture.draw_b", SALT_COLUMN, 1))
    return rng_collisions.check_streams(streams, context="fixture")


def rng_chunk_overlap() -> List[Finding]:
    """A scalar stream salted inside the open-ended chunk family — the
    chunk-c draw with c = salt - SALT_CHUNK0 collides with it."""
    streams = (DrawStream("fixture.reservoir", SALT_CHUNK0, 64,
                          family=True),
               DrawStream("fixture.extra", SALT_CHUNK0 + 3, 4))
    return rng_collisions.check_streams(streams, context="fixture")


def rng_corpus_salt_reuse() -> List[Finding]:
    """The corpus-ring negatives draw put back on a walk channel: consumer
    batches fold (qid = batch element, hop = grad step) under the round-0
    stream key, the very tuples walk tasks fold, so a consumer stream on
    SALT_COLUMN collides with the uniform sampler's column draw."""
    streams = rng_collisions.spec_streams(_default_spec("uniform"))
    streams += (DrawStream("fixture.corpus_negatives", SALT_COLUMN, 5),)
    return rng_collisions.check_streams(streams, context="fixture")


def rng_literal_salt() -> List[Finding]:
    """A Python call site passing a raw integer salt the registry never
    saw."""
    src = ("from repro_torch.core import rng as task_rng\n"
           "def f(base_key, qid, hop):\n"
           "    return task_rng.task_uniforms(base_key, qid, hop, 2, 5)\n")
    return rng_collisions.check_source(src, "fixture/literal_salt.py")


def cuda_literal_salt() -> List[Finding]:
    """A kernel drawing its stop test at a raw ``2u`` — the value of
    SALT_STOP today, but invisible to the registry and the stream model."""
    src = ('#include "walk_common.cuh"\n'
           "__device__ bool stops(uint2 base, int q, int h, int e,\n"
           "                      float alpha) {\n"
           "  const uint2 pk = walk::task_prefix(base, q, h, e);\n"
           "  const uint2 sk = walk::fold_in(pk, 2u);\n"
           "  return walk::bits_to_uniform(\n"
           "      walk::threefry2x32(sk.x, sk.y, 0u, 0u).x) < alpha;\n"
           "}\n")
    return rng_collisions.check_cuda_source(src, "fixture/literal_salt.cu")


def cuda_salt_mismatch() -> List[Finding]:
    """The real ``walk_common.cuh`` with ``kSaltStop`` moved to
    SALT_STOP + 1 (the corpus window's channel): the kernel's PPR stop
    draw would leave the plain superstep's stream."""
    path = pathlib.Path(__file__).resolve().parents[1] / _WALK_COMMON
    src = re.sub(r"\bkSaltStop\s*=\s*\w+", f"kSaltStop = {SALT_STOP + 1}",
                 path.read_text(), count=1)
    return rng_collisions.check_cuda_source(src, f"fixture/{path.name}")


# ----------------------------------------------------------- dma fixtures
#
# The reference breaks its walk-step gather loop; the port's one declared
# loop is the fused kernel's reservoir ping-pong (``ckcol`` / ``ckwgt``),
# so each defect is made there and caught as the reference's is.


def dma_missing_wait() -> List[Finding]:
    """The reservoir ping-pong with window 1's column-copy wait dropped:
    the read consumes the slot while its copy is still in flight
    (read-before-arrival), and the copy is never drained."""
    ops = [op for op in dma_schedule("reservoir_n2v")
           if not (op.kind == "wait" and op.buffer == "ckcol"
                   and op.copy == 2)]
    return dma_hazards.check_schedule(ops, "fixture.missing_wait")


def dma_overwrite_in_flight() -> List[Finding]:
    """The column buffer's ping-pong slots collapsed to one slot: window
    x+1's copy re-issues the slot window x's copy still occupies
    (overwrite-while-in-flight)."""
    ops = [op._replace(slot=0) if op.buffer == "ckcol" else op
           for op in dma_schedule("reservoir_n2v")]
    return dma_hazards.check_schedule(ops, "fixture.overwrite")


def dma_undrained() -> List[Finding]:
    """A trailing prefetch with no drain before the kernel returns."""
    ops = list(dma_schedule("reservoir_n2v"))
    ops.append(DmaOp("start", "ckcol", 0, copy=999))
    return dma_hazards.check_schedule(ops, "fixture.undrained")


def dma_cached_phantom_copy() -> List[Finding]:
    """A cached reservoir window that still copies from device memory on
    the hit path: the lane's row sits in the shared-memory block, yet a
    copy into the cache-tier column buffer is started anyway.  The same
    bytes arrive (bit-identical), but the hit's saving is gone: the
    silent regression the phantom-copy rule exists to trip."""
    ops = list(dma_schedule("reservoir_n2v", cached=True))
    hit = next(i for i, op in enumerate(ops)
               if op.kind == "read" and op.tier == "vmem"
               and op.buffer == "cache.col")
    ops.insert(hit, DmaOp("start", "cache.col", 0, copy=990))
    return dma_hazards.check_schedule(ops, "fixture.cached_phantom")


def visit_nonconsecutive() -> List[Finding]:
    """A grid-scheduled kernel visiting an output block, leaving it, then
    returning: the revisit contract an unsorted segment vector breaks."""
    ops = [DmaOp("visit", "out", 0, first=True),
           DmaOp("visit", "out", 1, first=True),
           DmaOp("visit", "out", 0, first=False)]
    return dma_hazards.check_schedule(ops, "fixture.nonconsecutive")


def visit_bad_first() -> List[Finding]:
    """first_visit set on a revisit — would zero a partial accumulation."""
    ops = [DmaOp("visit", "out", 0, first=True),
           DmaOp("visit", "out", 0, first=True)]
    return dma_hazards.check_schedule(ops, "fixture.bad_first")


# ----------------------------------------------------- residency fixtures


def residency_vprev_draw() -> List[Finding]:
    """A single_phase program with its draw moved to owner(v_prev) — the
    interpreter has no superstep to run it in."""
    prog = _replace_phase(lower(_default_spec("uniform")), 0,
                          residency="v_prev")
    return residency.check_program(prog)


def residency_missing_carry() -> List[Finding]:
    """A two_phase program whose carry was dropped: the verify superstep
    at owner(v_prev) would receive no candidate payload."""
    prog = dataclasses.replace(lower(_default_spec("rejection_n2v")),
                               carry="none")
    return residency.check_program(prog)


# --------------------------------------------------- determinism fixtures


def determinism_torch_random() -> List[Finding]:
    """An ambient torch draw inside the deterministic tree."""
    src = ("import torch\n"
           "def sample(n):\n"
           "    return torch.rand(n)\n")
    return determinism.check_source(src, "fixture/ambient_random.py")


def determinism_kernel_fallback() -> List[Finding]:
    """A wrapper that runs its plain version when the launch fails: a CUDA
    tensor would silently stop exercising the kernel."""
    src = ("from repro_torch.kernels import build\n"
           "from repro_torch.kernels.walk_step import ref\n"
           "def walk_step_uniform(v_curr, u_col, row_ptr, col):\n"
           "    try:\n"
           "        return build.load('walk_step').walk_step_uniform(\n"
           "            v_curr, u_col, row_ptr, col)\n"
           "    except RuntimeError:\n"
           "        return ref.walk_step_uniform_ref(v_curr, u_col,\n"
           "                                         row_ptr, col)\n")
    return determinism.check_ops_module(src, "fixture/kernels/x/ops.py")


def determinism_tune_clock() -> List[Finding]:
    """A wall-clock read leaking out of tune/measure.py into the rest of
    the autotuner — e.g. the candidate space timing itself.  Only
    measure.py may touch the clock; what the compile path imports (space,
    model, cache, tuner) must stay replayable."""
    src = ("import time\n"
           "def knob_grid():\n"
           "    t0 = time.perf_counter()\n"
           "    return [2 ** k for k in range(5)], t0\n")
    return determinism.check_source(src, "fixture/tune/space.py")


FIXTURES: Dict[str, Callable[[], List[Finding]]] = {
    "rng-duplicate-salt": rng_duplicate_salt,
    "rng-chunk-overlap": rng_chunk_overlap,
    "rng-corpus-salt-reuse": rng_corpus_salt_reuse,
    "rng-literal-salt": rng_literal_salt,
    "cuda-literal-salt": cuda_literal_salt,
    "cuda-salt-mismatch": cuda_salt_mismatch,
    "dma-missing-wait": dma_missing_wait,
    "dma-overwrite-in-flight": dma_overwrite_in_flight,
    "dma-undrained": dma_undrained,
    "dma-cached-phantom-copy": dma_cached_phantom_copy,
    "visit-nonconsecutive": visit_nonconsecutive,
    "visit-bad-first": visit_bad_first,
    "residency-vprev-draw": residency_vprev_draw,
    "residency-missing-carry": residency_missing_carry,
    "determinism-torch-random": determinism_torch_random,
    "determinism-kernel-fallback": determinism_kernel_fallback,
    "determinism-tune-clock": determinism_tune_clock,
}


def run_fixture(name: str) -> List[Finding]:
    return FIXTURES[name]()
