"""Static verifier for the invariants the port's walks rest on.

Four passes, each reading a *declarative export* the runtime code already
maintains (nothing here re-implements a backend: the passes check the
declarations the backends execute):

  * `rng_collisions` — every per-task draw stream (phase-program
    ``draw_streams()``, engine stop draws, corpus draws) is pairwise
    salt-disjoint for every sampler kind; every Python call site of the
    task RNG passes a registered `rng.SALTS` channel; every
    ``fold_in(key, salt)`` in the CUDA sources passes a ``kSalt*``
    constant, and each ``kSalt*`` constant equals its registry channel.
  * `dma_hazards` — every kernel's declared DMA schedule (``dma_schedule()``
    beside the kernel: the fused kernel's reservoir ``cp.async`` ping-pong)
    is hazard-free: reads dominated by copy-waits, no slot re-issued while
    in flight, all copies drained, no copy on a cache hit path.
  * `residency` — every lowered `PhaseProgram` satisfies the sharded
    interpreter's contract (v_prev phases only under two_phase /
    chunked_loop, carries produced before consumed, derived flags
    recomputed from the phase facts).
  * `determinism` — AST lint over ``src/repro_torch/{core,kernels,walker,
    tune}``: no torch, numpy or stdlib RNG and no wall clock outside the
    modules allowed to hold them, and every ``kernels/*/ops.py`` loads its
    library through ``kernels/build.load``, sends CPU tensors to its plain
    version and never falls back to it from an ``except`` handler.

``python -m repro_torch.analysis --check`` runs all four and checks the
tables against the docs; ``--table`` prints them; ``--fixture NAME`` runs a
pass over a deliberately broken input and exits non-zero when (as it must)
the defect is caught.
"""
from repro_torch.analysis.report import Finding, render_findings

__all__ = ["Finding", "render_findings", "run_all"]


def run_all():
    """Run every pass over the package; returns the combined findings."""
    from repro_torch.analysis import (determinism, dma_hazards, residency,
                                      rng_collisions)
    findings = []
    findings += rng_collisions.check_repo()
    findings += dma_hazards.check_repo()
    findings += residency.check_repo()
    findings += determinism.check_repo()
    return findings
