"""Plain PyTorch version of the fused superstep kernel.

It is the per-hop engine's own superstep, run up to ``k`` times in one
"launch": what the CPU runs for ``step_impl="fused"``, and what the CUDA
kernel is held against on the card.
"""
from __future__ import annotations

from repro_torch.core import walk_engine as engine
from repro_torch.core.phase_program import make_sampler


def fused_superstep_ref(graph, spec, cfg, depth, state, key, k):
    """Run the plain ``_superstep`` while work is left and fewer than ``k``
    have run, then count exactly one launch (not one per superstep).

    Returns the new state; the path buffers are written in place, as the
    plain superstep writes them.
    """
    sample = make_sampler(spec)
    for _ in range(k):
        if not bool(engine._work_left(state)):
            break
        state = engine._superstep(graph, spec, cfg, key, depth, sample, state)
    return engine._count_launch(state)
