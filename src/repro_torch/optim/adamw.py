"""AdamW with global-norm clipping and a warmup-cosine learning rate.

The same update as the reference's ``repro.optim.adamw``, on any nested
tree (dicts, lists, tuples) of float32 tensors.  :func:`apply_updates` updates the parameters and both
moments **in place** (the reference donates those buffers to XLA for the
same reason): at the SGNS step's full width the two tables and their
moments are 3 GiB, and a second copy a step is avoided.  The step
counter, the learning rate and the clipping scale stay on the parameters'
device, so an update reads nothing back to the host.

Leaves are visited in the reference's pytree order
(`checkpoint/checkpointer.py::flatten_with_paths`: dicts by sorted key,
lists and tuples by index), so the global norm sums the leaves' squared
norms in the same order; a flat dict is visited in sorted key order.
Within a leaf the reductions, ``cos`` and ``pow`` differ from XLA's by a
few ulps, and XLA contracts the moment updates into fused multiply-adds,
so the result agrees with the reference within a tolerance, not bit for
bit.

A leaf may be a table in row blocks over device groups
(`distributed.row_blocks.RowBlocks`, the sharded ``train_embeddings``'s
tables, moments and gradients).  Its squared norm is the sum, in shard
order, of its N shard blocks' squared sums, each taken on its slab's
device and added on the first slab's (the reference's sharded sum adds
per-device partial sums; this order makes the norm the same bits for
any number of groups, but not those of one ``torch.sum`` over the whole
table).  The step's scalars (learning rate, bias corrections, clipping
scale) are computed once on the step counter's device and copied to
each slab's, where the per-element update runs in place as on a tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.checkpoint.checkpointer import leaves, tree_map
from repro_torch.distributed.row_blocks import RowBlocks


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the parameters' device
    mu: object           # first moments, float32, a tree like the params
    nu: object           # second moments


def init_state(params) -> AdamWState:
    """Zero moments and step 0 for ``params`` (a tree of tensors, or of
    row blocks: their moments in the same layout, the step on the first
    slab's device)."""
    def zero(p):
        if isinstance(p, RowBlocks):
            return p.map(lambda s: torch.zeros_like(s, dtype=torch.float32))
        return torch.zeros_like(p, dtype=torch.float32)
    first = leaves(params)[0]
    device = first.devices[0] if isinstance(first, RowBlocks) else \
        first.device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(zero, params), nu=tree_map(zero, params))


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``lr ·
    min_lr_ratio`` at ``total_steps``; ``step`` is an integer tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _squared_norm(leaf) -> torch.Tensor:
    if isinstance(leaf, RowBlocks):
        # Shard blocks in shard order, each on its slab's device.
        first = leaf.devices[0]
        total = None
        for block in leaf.shard_blocks():
            s = torch.sum(torch.square(block.float())).to(first)
            total = s if total is None else total + s
        return total
    return torch.sum(torch.square(leaf.float()))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared norm, leaves in the
    reference's pytree order (a :class:`RowBlocks` leaf's by shard
    block, module docstring)."""
    return torch.sqrt(sum(_squared_norm(leaf) for leaf in leaves(tree)))


def _update(p, g, m, v, scale, lr, b1c, b2c, cfg: AdamWConfig) -> None:
    # The update's expression, op for op, with at most two temporaries of
    # the leaf's size alive at once (in place where the expression made a
    # new tensor): a full model's largest leaves are 4 GB.
    g = g.float() * scale
    m.mul_(cfg.b1).add_(torch.mul(g, 1 - cfg.b1))
    sq = torch.square(g)
    del g
    v.mul_(cfg.b2).add_(sq.mul_(1 - cfg.b2))
    del sq
    delta = torch.div(m, b1c).div_(torch.div(v, b2c).sqrt_().add_(cfg.eps))
    delta.add_(cfg.weight_decay * p.float())
    p.sub_(delta.mul_(lr).to(p.dtype))


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, in place on ``params`` and
    the moments (a :class:`RowBlocks` leaf slab by slab, on each slab's
    device).  Returns ``(params, state, stats)``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    scalars = {step.device: (scale, lr, b1c, b2c)}
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu), strict=True):
        if not isinstance(p, RowBlocks):
            _update(p, g, m, v, scale, lr, b1c, b2c, cfg)
            continue
        for slabs in zip(p.slabs, g.slabs, m.slabs, v.slabs, strict=True):
            dev = slabs[0].device
            if dev not in scalars:
                scalars[dev] = tuple(x.to(dev) for x in scalars[step.device])
            _update(*slabs, *scalars[dev], cfg)
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), stats
