"""End-to-end training launcher for the language-model, GNN and recsys
families.

  PYTHONPATH=src python -m repro_torch.launch.train --arch pna --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch granite_moe --steps 4 [--resume]

``--smoke`` is the reference's flag: ``store_true`` with default True, so
it cannot be turned off and the launcher always trains the reduced
(``SMOKE``) config.  The full configs are trained on the card by
``chip_smoke.py`` through the same step functions.  The loop runs through
``runtime/train_loop.py`` — checkpointing, straggler watchdog, resume.
``--device`` (default ``cuda``) picks the device.  A language model
trains in float32, as the reference forces, on ``data.pipeline``'s
synthetic Zipf tokens (``--batch`` sequences of ``--seq`` tokens a step),
from weights drawn on the CPU from seed 0 and placed on the device: the
same bits on every device.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import tempfile

import torch

from repro_torch.checkpoint.checkpointer import leaves as tree_leaves
from repro_torch.checkpoint.checkpointer import unflatten
from repro_torch.configs import get_arch
from repro_torch.core.rng import seeded_generator
from repro_torch.data import pipeline as datapipe
from repro_torch.graph.csr import resolve_device
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop


def make_grad_step(loss_fn, opt_cfg: adamw.AdamWConfig):
    """``step(state, batch) -> (state, aux)`` for ``state = (params,
    opt_state)``: the gradient of ``loss_fn(params, batch)`` through
    ``torch.autograd`` (a leaf the loss does not reach gets zeros, as
    under ``jax.grad``), then AdamW in place."""

    def step(state, batch):
        params, opt_state = state
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, iter(leaves)), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        params, opt_state, stats = adamw.apply_updates(
            params, unflatten(params, iter(grads)), opt_state, opt_cfg)
        return (params, opt_state), {"loss": loss.detach(), **stats}

    return step


def make_lm_step(cfg, opt_cfg):
    """The language model's step: the gradient of
    ``transformer.train_loss`` on a ``(tokens, labels)`` batch, then
    AdamW (the reference's ``make_lm_step``)."""
    from repro_torch.models import transformer as tfm

    def loss_fn(params, batch):
        tokens, labels = batch
        return tfm.train_loss(params, tokens, labels, cfg)
    return make_grad_step(loss_fn, opt_cfg)


def gnn_module(arch: str):
    return importlib.import_module(f"repro_torch.models.gnn.{arch}")


def make_gnn_step(arch, cfg, opt_cfg):
    m = gnn_module(arch)
    return make_grad_step(lambda p, b: m.train_loss(p, b, cfg), opt_cfg)


def make_recsys_step(cfg, opt_cfg):
    from repro_torch.models.recsys import dcn
    return make_grad_step(lambda p, b: dcn.train_loss(p, b, cfg), opt_cfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    if mod.FAMILY not in ("lm", "gnn", "recsys"):
        raise ValueError(f"--arch {args.arch}: family {mod.FAMILY!r} has no "
                         "training step")
    device = resolve_device(args.device)
    cfg = mod.SMOKE if args.smoke else mod.FULL
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(1, args.steps // 10))
    generator = seeded_generator(0)

    if mod.FAMILY == "lm":
        from repro_torch.models import transformer as tfm
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        params = tfm.init_params(generator, cfg, device=device)
        dcfg = datapipe.TokenPipelineConfig(cfg.vocab, args.seq, args.batch)

        def batch_fn(step):
            return datapipe.to_device(datapipe.lm_batch(dcfg, step), device)
        step_fn = make_lm_step(cfg, opt_cfg)
    elif mod.FAMILY == "gnn":
        arch = args.arch.replace("-", "_")
        if arch in ("schnet", "mace"):
            b = datapipe.molecule_batch(16, 48, args.batch)
        else:
            b = datapipe.gnn_batch(256, 1024, getattr(cfg, "node_in", 8),
                                   d_edge=4 if arch == "meshgraphnet" else 0,
                                   n_classes=getattr(cfg, "out_dim", 5))
        b = datapipe.to_device(b, device)

        def batch_fn(step):
            return b
        params = gnn_module(arch).init_params(generator, cfg, device=device)
        step_fn = make_gnn_step(arch, cfg, opt_cfg)
    else:
        from repro_torch.models.recsys import dcn
        params = dcn.init_params(generator, cfg, device=device)

        def batch_fn(step):
            return datapipe.to_device(datapipe.recsys_batch(
                args.batch, cfg.n_dense, cfg.n_sparse, cfg.vocabs(),
                seed=step), device)
        step_fn = make_recsys_step(cfg, opt_cfg)

    opt_state = adamw.init_state(params)
    state = (params, opt_state)
    loop_cfg = train_loop.TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=max(10, args.steps // 3), log_every=5)
    start = 0
    if args.resume:
        state, start = train_loop.resume_or_init(args.ckpt_dir, state)
        print(f"resumed at step {start}")
    state, step, history, watchdog = train_loop.run(
        step_fn, state, batch_fn, loop_cfg, start_step=start)
    if history:
        print("first:", history[0])
        print("last: ", history[-1])
    print(f"done at step {step}; stragglers={watchdog.straggler_steps}")


if __name__ == "__main__":
    main()
