"""AdamW on nested trees, the generic training loop and the training
launcher of the port, held against the reference on the CPU.

Tolerances, each with its reason:
- AdamW on a GNN's tree: ``rtol=1e-5, atol=1e-6`` on parameters and
  moments (the port's existing AdamW tolerance: XLA fuses the update into
  fused multiply-adds, and its ``cos``, ``pow`` and reductions differ from
  PyTorch's by a few ulps);
- the loop's losses after 4 PNA steps: ``rtol=1e-4`` (the forward's
  tolerance; the losses carry the models' float differences);
- a resumed run against an unbroken one of the port: bit for bit.
"""
import functools
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_arch as ref_get_arch
from repro.data import pipeline as ref_pipe
from repro.launch import train as ref_train
from repro.models.gnn import pna as ref_pna
from repro.optim import adamw as ref_adamw
from repro.runtime import train_loop as ref_loop
from repro_torch.checkpoint.checkpointer import flatten_with_paths, tree_map
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train
from repro_torch.models import embeddings as emb
from repro_torch.models import layers as L
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
OPT_TOL = dict(rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def pna_params():
    cfg = ref_get_arch("pna").SMOKE
    p = jax.jit(functools.partial(ref_pna.init_params, cfg=cfg),
                compiler_options={"xla_backend_optimization_level": 0})(KEY)
    return jax.tree.map(np.asarray, p)


def assert_trees_close(got, want, **tol):
    paths, leaves, _ = _flatten_with_paths(want)
    port = flatten_with_paths(got)
    assert [p for p, _ in port] == paths
    for (path, t), w in zip(port, leaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), err_msg=path,
                                   **tol)


def assert_trees_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), path


# ----------------------------------------------------------------- AdamW

@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_on_a_nested_tree_equals_reference(steps):
    params = pna_params()
    rng = np.random.default_rng(steps)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape)
                          .astype(np.float32) * 0.3, params)
             for _ in range(steps)]
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    ref_cfg = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    rp, rs = jax.tree.map(jnp.asarray, params), ref_adamw.init_state(params)
    ref_update = jax.jit(ref_adamw.apply_updates, static_argnums=3)
    pp = L.tree_from_reference(params)
    ps = adamw.init_state(pp)
    assert [p for p, _ in flatten_with_paths(ps.mu)] == \
        [p for p, _ in flatten_with_paths(pp)]
    for g in grads:
        rp, rs, rstats = ref_update(rp, jax.tree.map(jnp.asarray, g), rs,
                                    ref_cfg)
        pp, ps, stats = adamw.apply_updates(pp, L.tree_from_reference(g), ps,
                                            cfg)
    assert int(ps.step) == int(rs.step) == steps
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(rstats["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(stats["lr"]), float(rstats["lr"]),
                               rtol=1e-6)
    assert_trees_close(pp, rp, **OPT_TOL)
    assert_trees_close(ps.mu, rs.mu, **OPT_TOL)
    assert_trees_close(ps.nu, rs.nu, **OPT_TOL)
    carried = emb.opt_state_from_reference(rs)
    assert int(carried.step) == steps
    assert_trees_close(carried.mu, rs.mu, rtol=0, atol=0)


# -------------------------------------------------------- the train loop

def _pna_setup(steps=4):
    """The launcher's PNA run: its batch, the reference's step and state,
    and the port's from the same parameters."""
    cfg, ref_cfg = get_arch("pna").SMOKE, ref_get_arch("pna").SMOKE
    b = ref_pipe.gnn_batch(256, 1024, cfg.node_in, n_classes=cfg.out_dim)
    opt = adamw.AdamWConfig(lr=3e-3, total_steps=steps, warmup_steps=1)
    ref_opt = ref_adamw.AdamWConfig(lr=3e-3, total_steps=steps,
                                    warmup_steps=1)
    ref = (ref_train.make_gnn_step("pna", ref_cfg, ref_opt),
           (jax.tree.map(jnp.asarray, pna_params()),
            ref_adamw.init_state(pna_params())),
           jax.tree.map(jnp.asarray, b))
    params = L.tree_from_reference(pna_params())
    port = (train.make_gnn_step("pna", cfg, opt),
            (params, adamw.init_state(params)), pipe.to_device(b, "cpu"))
    return ref, port


def _fresh_port_state():
    params = L.tree_from_reference(pna_params())
    return params, adamw.init_state(params)


def test_run_reaches_the_reference_losses(tmp_path):
    (ref_step, ref_state, ref_b), (step, state, b) = _pna_setup()
    lcfg = dict(total_steps=4, ckpt_every=50, log_every=1)
    _, ref_n, ref_hist, _ = ref_loop.run(
        ref_step, ref_state, lambda s: ref_b,
        ref_loop.TrainLoopConfig(ckpt_dir=str(tmp_path / "ref"), **lcfg))
    metrics = tmp_path / "m.jsonl"
    _, n, hist, watchdog = train_loop.run(
        step, state, lambda s: b,
        train_loop.TrainLoopConfig(ckpt_dir=str(tmp_path / "port"),
                                   metrics_path=str(metrics), **lcfg))
    assert n == ref_n == 4
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in ref_hist], rtol=1e-4)
    assert hist[-1]["loss"] < hist[0]["loss"]
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [x["step"] for x in lines] == [h["step"] for h in hist]
    assert train_loop.checkpointer.latest_step(str(tmp_path / "port")) == 4
    assert watchdog.straggler_steps == sum(h["straggler"] for h in hist)


def test_resume_is_bit_identical(tmp_path):
    _, (step, _, b) = _pna_setup()
    lcfg = dict(ckpt_every=50, log_every=1)
    whole, n, hist, _ = train_loop.run(
        step, _fresh_port_state(), lambda s: b,
        train_loop.TrainLoopConfig(total_steps=4,
                                   ckpt_dir=str(tmp_path / "a"), **lcfg))
    ckpt = str(tmp_path / "b")
    _, n2, _, _ = train_loop.run(
        step, _fresh_port_state(), lambda s: b,
        train_loop.TrainLoopConfig(total_steps=2, ckpt_dir=ckpt, **lcfg))
    assert n2 == 2
    like = _fresh_port_state()
    state, start = train_loop.resume_or_init(
        ckpt, like, shardings=tree_map(lambda _: torch.device("cpu"), like))
    assert start == 2
    resumed, n3, hist3, _ = train_loop.run(
        step, state, lambda s: b,
        train_loop.TrainLoopConfig(total_steps=4, ckpt_dir=ckpt, **lcfg),
        start_step=start)
    assert n == n3 == 4
    assert [h["loss"] for h in hist3] == [h["loss"] for h in hist[2:]]
    assert_trees_equal(resumed, whole)
    fresh, s0 = train_loop.resume_or_init(str(tmp_path / "none"),
                                          _fresh_port_state())
    assert s0 == 0


def test_sigterm_stops_after_the_step_and_checkpoints(tmp_path):
    calls = []

    def step_fn(state, batch):
        calls.append(batch)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"w": state["w"] + 1.0}, {"loss": torch.tensor(0.5)}

    before = signal.getsignal(signal.SIGTERM)
    state, n, hist, _ = train_loop.run(
        step_fn, {"w": torch.zeros(3)}, lambda s: s,
        train_loop.TrainLoopConfig(total_steps=10, ckpt_dir=str(tmp_path),
                                   log_every=1, ckpt_every=50))
    assert n == 2 and calls == [0, 1]
    assert signal.getsignal(signal.SIGTERM) is before
    assert train_loop.checkpointer.latest_step(str(tmp_path)) == 2
    assert torch.equal(state["w"], torch.full((3,), 2.0))
    assert [h["step"] for h in hist] == [1, 2]


def test_loop_config_fields_equal_the_reference():
    import dataclasses
    port = [(f.name, f.type) for f in
            dataclasses.fields(train_loop.TrainLoopConfig)]
    ref = [(f.name, f.type) for f in
           dataclasses.fields(ref_loop.TrainLoopConfig)]
    assert [n for n, _ in port] == [n for n, _ in ref]
    d, r = train_loop.TrainLoopConfig(), ref_loop.TrainLoopConfig()
    for f in ("total_steps", "ckpt_every", "log_every", "straggler_factor",
              "async_checkpoint", "metrics_path"):
        assert getattr(d, f) == getattr(r, f)


# -------------------------------------------------------------- launcher

def _launch(*args, ckpt):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--ckpt-dir", str(ckpt), *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if get_arch(a).FAMILY != "lm"])
def test_launcher_trains_each_arch(arch, tmp_path):
    r = _launch("--arch", arch, "--steps", "4", ckpt=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "done at step 4" in r.stdout
    if arch == "pna":
        r = _launch("--arch", arch, "--steps", "6", "--resume", ckpt=tmp_path)
        assert r.returncode == 0, r.stderr
        assert "resumed at step 4" in r.stdout
        assert "done at step 6" in r.stdout


def test_launcher_refuses_language_models(tmp_path, capsys):
    """The launcher trains the language-model family now (its step is
    ``make_lm_step``) and refuses only an arch whose family has no
    training step (the walk workloads)."""
    train.main(["--arch", "deepseek_7b", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert "done at step 2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no training step"):
        train.main(["--arch", "ridgewalker", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
