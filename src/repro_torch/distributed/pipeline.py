"""Pipeline parallelism (the GPipe schedule), the reference's
``repro.distributed.pipeline``.

An optional ``pipe`` mesh axis splits the layer stack into stages;
microbatches stream through the stages, each stage handing its output
to the next.  Bubble fraction = (P-1)/(M+P-1), the classic GPipe result;
M >= 4·P keeps the bubble under 20%.

The reference runs one program a stage inside ``shard_map`` and hands
activations on with ``ppermute``.  Here the P stages are stacked on one
device, as the sharded backend stacks its shards (`distributed/mesh.py`):
every tick applies each stage to its own buffer at once
(``torch.func.vmap`` over the stacked parameters), and a roll of the
stacked outputs by one stage stands in for the ``ppermute``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.mesh import axis_size


def pipeline_apply(stage_fn: Callable, params_stacked, x_microbatches,
                   mesh, axis: str = "pipe"):
    """Run x through P stages living on the ``pipe`` axis.

    stage_fn(stage_params, x) -> x  (one stage's compute)
    params_stacked: tree with a leading stage axis (P, ...)
    x_microbatches: (M, mb, ...) microbatched input.
    Returns (M, mb, ...) outputs (after all P stages).

    The reference's schedule: T = M + P - 1 ticks; in tick t stage 0
    ingests microbatch t (the last one again once they run out), every
    other stage the previous stage's output of tick t - 1, and the last
    stage emits microbatch t - (P - 1).
    """
    n_stages = axis_size(mesh, axis)
    M = x_microbatches.shape[0]
    stages = torch.func.vmap(stage_fn)
    buf = torch.zeros((n_stages, *x_microbatches.shape[1:]),
                      dtype=x_microbatches.dtype,
                      device=x_microbatches.device)
    outs = []
    for t in range(M + n_stages - 1):
        x_in = torch.cat([x_microbatches[min(t, M - 1)][None], buf[1:]])
        y = stages(params_stacked, x_in)
        buf = torch.roll(y, 1, dims=0)     # stage i's output to stage i + 1
        if t >= n_stages - 1:
            outs.append(y[-1])
    return torch.stack(outs)


def gpipe_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
