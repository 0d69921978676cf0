"""Static verifier for the invariants the port's walks rest on.

Three passes, each reading a *declarative export* the runtime code already
maintains (nothing here re-implements a backend: the passes check the
declarations the backends execute):

  * `rng_collisions` — every per-task draw stream (phase-program
    ``draw_streams()``, engine stop draws, corpus draws) is pairwise
    salt-disjoint for every sampler kind; every Python call site of the
    task RNG passes a registered `rng.SALTS` channel; every
    ``fold_in(key, salt)`` in the CUDA sources passes a ``kSalt*``
    constant, and each ``kSalt*`` constant equals its registry channel.
  * `residency` — every lowered `PhaseProgram` satisfies the sharded
    interpreter's contract (v_prev phases only under two_phase /
    chunked_loop, carries produced before consumed, derived flags
    recomputed from the phase facts).
  * `determinism` — AST lint over ``src/repro_torch/{core,kernels,walker,
    tune}``: no torch, numpy or stdlib RNG and no wall clock outside the
    modules allowed to hold them, and every ``kernels/*/ops.py`` loads its
    library through ``kernels/build.load``, sends CPU tensors to its plain
    version and never falls back to it from an ``except`` handler.

The reference's fourth pass, over declared TPU DMA schedules, has no
counterpart: no CUDA kernel of the port issues an asynchronous copy.

``python -m repro_torch.analysis --check`` runs all three and checks the
docs tables; ``--table`` prints them; ``--fixture NAME`` runs a pass over a
deliberately broken input and exits non-zero when (as it must) the defect
is caught.
"""
from repro_torch.analysis.report import Finding, render_findings

__all__ = ["Finding", "render_findings", "run_all"]


def run_all():
    """Run every pass over the package; returns the combined findings."""
    from repro_torch.analysis import determinism, residency, rng_collisions
    findings = []
    findings += rng_collisions.check_repo()
    findings += residency.check_repo()
    findings += determinism.check_repo()
    return findings
