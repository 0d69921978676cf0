"""The language-model training slice of the port (the gradient of
``transformer.train_loss`` with ``remat``, the MoE's and attention's
backward, ``launch.train.make_lm_step``), held against the reference on
the CPU.

Parameters are the reference's (``jax.random.PRNGKey(0)``), carried
across with ``layers.tree_from_reference``; tokens are drawn from a seed
with numpy.  The reference's gradients are
``jax.value_and_grad(train_loss)``, jitted.

Tolerances, each with its reason:
- float32 losses ``rtol=1e-5``; every float32 gradient leaf
  ``rtol=1e-3, atol=1e-6`` (the zoo's gradient tolerance): XLA and
  PyTorch's CPU BLAS sum the matmuls' products in other orders, and a
  gradient sums many of them; the largest error measured at these seeds
  is 0.16 of it.
- bfloat16 (the configs' own dtype): the loss ``rtol=5e-3`` and each
  gradient leaf within a relative norm error ``||got - want|| / ||want||``
  of 0.15.  bfloat16 keeps 8 bits, so every op rounds at 2^-9, and the
  two packages round in other places: fed the same bfloat16 inputs, one
  GQA attention layer of granite_moe differs by 0.34% in norm (deepseek's
  MHA layer not at all), and the MoE's combine sums bfloat16
  contributions in bfloat16 in the reference where the port's kernels sum
  in float32 (0.43% on a layer's MoE output).  Through two layers and the
  backward this measured: losses within 1.9e-3, leaves within 0.078
  (granite_moe's router; the dense archs within 0.021).
- ``make_lm_step`` after 3 steps: the losses and the gradient norms
  ``rtol=1e-6``; both AdamW moments ``rtol=1e-5, atol=1e-6`` (the port's
  AdamW tolerance); the parameters ``atol`` of a quarter of the learning
  rate: AdamW moves each element by up to ``lr`` whatever its gradient's
  size, so an element whose gradient is near 0 carries the gradients'
  float differences into its step at the order of ``lr`` (measured: 0.074
  ``lr``).
- ``remat`` on and off: the same bits (the recomputed forward is the same
  function of the same inputs).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.data import pipeline as ref_datapipe
from repro.launch import train as ref_train
from repro.models import attention_chunked as ref_ac
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.checkpointer import leaves, tree_map, unflatten
from repro_torch.configs import get_arch
from repro_torch.core.rng import seeded_generator
from repro_torch.data import pipeline as datapipe
from repro_torch.launch import train
from repro_torch.models import attention_chunked as ac
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

from test_torch_lm import KEY, LM, both_params, normal, qkv, rng

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)
BF16_LOSS = dict(rtol=5e-3)
BF16_NORM = 0.15
OPT_TOL = dict(rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(cfg):
    return jax.jit(lambda p, t, y: jax.value_and_grad(ref_tfm.train_loss)(
        p, t, y, cfg))


def port_value_and_grad(loss_fn, params):
    """``loss_fn(params)`` and the gradient of every leaf, in the
    reference's leaf order."""
    ls = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = loss_fn(unflatten(params, iter(ls)))
    grads = torch.autograd.grad(loss, ls, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def norm_error(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_grads_close(got, want_tree, bf16=False):
    paths, want, _ = _flatten_with_paths(want_tree)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        assert g.shape == tuple(np.shape(w)), path
        if bf16:
            assert norm_error(g, w) <= BF16_NORM, path
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD,
                                       err_msg=path)


def tokens(cfg, S=24, seed=21):
    return (rng(seed).integers(0, cfg.vocab, (2, S)).astype(np.int32),
            rng(seed + 1).integers(0, cfg.vocab, (2, S)).astype(np.int32))


# ------------------------------------------------------- train_loss grads

@pytest.mark.parametrize("vocab_parallel_ce", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM)
def test_train_loss_grads_equal_reference(arch, dtype, vocab_parallel_ce):
    """The loss and every gradient leaf against
    ``jax.value_and_grad(train_loss)``; ``remat`` off gives the same bits
    as on (the configs' default)."""
    ref_cfg, cfg, rp, pp = both_params(arch, dtype)
    assert cfg.remat
    ref_cfg = dataclasses.replace(ref_cfg, vocab_parallel_ce=vocab_parallel_ce)
    cfg = dataclasses.replace(cfg, vocab_parallel_ce=vocab_parallel_ce)
    toks, labels = tokens(cfg)
    wl, wg = ref_value_and_grad(ref_cfg)(rp, toks, labels)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    runs = {remat: port_value_and_grad(
        lambda p: tfm.train_loss(p, tt, tl, dataclasses.replace(
            cfg, remat=remat)), pp) for remat in (True, False)}
    gl, gg = runs[True]
    assert torch.equal(gl, runs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(gg, runs[False][1]))
    for g, p in zip(gg, leaves(pp)):
        assert g.dtype == p.dtype
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(float(gl), float(wl),
                               **(BF16_LOSS if bf16 else LOSS))
    assert_grads_close(gg, wg, bf16)


def test_remat_checkpoints_each_layer_only_under_autograd(monkeypatch):
    """``remat`` runs each layer of ``forward`` and ``prefill`` through
    ``torch.utils.checkpoint`` when autograd records, and never without
    it (serving), nor with ``remat=False``."""
    _, cfg, _, pp = both_params("granite_moe")
    toks = torch.from_numpy(tokens(cfg)[0])
    calls = []
    real = tfm.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)
    monkeypatch.setattr(tfm, "checkpoint", spy)
    with torch.no_grad():
        tfm.forward(pp, toks, cfg)
        tfm.prefill(pp, toks, cfg)
    assert calls == []
    port_value_and_grad(lambda p: tfm.train_loss(p, toks, toks, cfg), pp)
    assert calls == [{"use_reentrant": False}] * cfg.n_layers
    pl = tree_map(lambda a: a.detach().requires_grad_(True), pp)
    logits, kv = tfm.prefill(pl, toks, cfg)
    assert len(calls) == 2 * cfg.n_layers
    (logits.sum() + kv.sum()).backward()
    assert all(p.grad is not None for p in leaves(pl))
    tfm.train_loss(pp, toks, toks, dataclasses.replace(cfg, remat=False))
    assert len(calls) == 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["granite_moe", "deepseek_7b"])
def test_chunked_train_loss_grads_equal_reference(arch):
    """Above ``chunk_threshold`` the loss runs the chunked attention (here
    at 32 tokens in blocks of 8): its gradients against the reference's
    chunked path, and equal to the port's plain path within tolerance."""
    ref_cfg, cfg, rp, pp = both_params(arch)
    kw = dict(chunk_threshold=16, q_block=8, kv_block=8)
    toks, labels = tokens(cfg, S=32, seed=31)
    wl, wg = ref_value_and_grad(dataclasses.replace(ref_cfg, **kw))(
        rp, toks, labels)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    gl, gg = port_value_and_grad(lambda p: tfm.train_loss(
        p, tt, tl, dataclasses.replace(cfg, **kw)), pp)
    np.testing.assert_allclose(float(gl), float(wl), **LOSS)
    assert_grads_close(gg, wg)
    fl, fg = port_value_and_grad(
        lambda p: tfm.train_loss(p, tt, tl, cfg), pp)
    np.testing.assert_allclose(float(gl), float(fl), **LOSS)
    for a, b in zip(gg, fg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 20)])
@pytest.mark.parametrize("blocks", [(8, 8), (16, 32), (32, 8)])
def test_chunked_attention_grads_equal_reference(blocks, causal, q_offset):
    """The online softmax's backward (the Q blocks written into slices of
    the output, the causal loop's skipped KV blocks) against
    ``jax.grad`` of the reference's scans."""
    S = 8 if q_offset else 32
    q, k, v = qkv(S=S, T=32)
    w = normal(q.shape, 9)
    qb, kb = min(blocks[0], S), blocks[1]
    kw = dict(causal=causal, q_block=qb, kv_block=kb, q_offset=q_offset)

    def ref_loss(q, k, v):
        return jnp.sum(ref_ac.chunked_attention(q, k, v, **kw) * w)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    loss = torch.sum(ac.chunked_attention(*ts, **kw) * torch.from_numpy(w))
    got = torch.autograd.grad(loss, ts)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **GRAD)


# -------------------------------------------------------------------- MoE

def test_moe_grads_flow():
    """The port's counterpart of the reference's ``test_moe_grads_flow``
    (row dispatch), its gradients equal to the reference's."""
    kw = dict(num_experts=4, top_k=2, d_ff=16, dispatch="row")
    ref_cfg, cfg = ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    rp = jax.tree.map(np.asarray, ref_moe.moe_init(KEY, 8, ref_cfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (2, 12, 8)))

    def ref_loss(p):
        y, aux = ref_moe.moe_apply_batched(p, jnp.asarray(x), ref_cfg)
        return jnp.sum(jnp.square(y)) + aux
    want = jax.grad(ref_loss)(rp)

    def loss(p):
        y, aux = moe.moe_apply_batched(p, torch.from_numpy(x), cfg)
        return torch.sum(torch.square(y)) + aux
    _, got = port_value_and_grad(loss, L.tree_from_reference(rp))
    total = sum(float(g.abs().sum()) for g in got)
    assert np.isfinite(total) and total > 0
    assert_grads_close(got, want)


@pytest.mark.parametrize("case", ["cf8", "cf0.1", "padded", "bf16"])
def test_moe_grads_equal_reference(case):
    """Router and expert gradients through the dispatch gathers and the
    combine (global dispatch), with none dropped, many dropped, padded
    experts, and a bfloat16 activation upcast for the kernels."""
    kw = {"cf8": dict(num_experts=5, top_k=3, d_ff=24, capacity_factor=8.0),
          "cf0.1": dict(num_experts=5, top_k=3, d_ff=24,
                        capacity_factor=0.1),
          "padded": dict(num_experts=5, top_k=2, d_ff=24, pad_experts_to=4),
          "bf16": dict(num_experts=5, top_k=3, d_ff=24)}[case]
    ref_cfg, cfg = ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    bf16 = case == "bf16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    rp = jax.tree.map(np.asarray, ref_moe.moe_init(KEY, 16, ref_cfg, jdt))
    x = np.asarray(jnp.asarray(normal((2, 12, 16), 9), jdt))
    w = normal((2, 12, 16), 10)

    def ref_loss(p, x):
        y, aux = ref_moe.moe_apply_batched(p, x, ref_cfg)
        return jnp.sum(y.astype(jnp.float32) * w) + aux
    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        rp, jnp.asarray(x))
    tree = {"p": L.tree_from_reference(rp),
            "x": L.tree_from_reference({"x": x})["x"]}

    def loss(t):
        y, aux = moe.moe_apply_batched(t["p"], t["x"], cfg)
        return torch.sum(y.float() * torch.from_numpy(w)) + aux
    _, got = port_value_and_grad(loss, tree)
    assert got[-1].dtype == tree["x"].dtype
    assert_grads_close(got, {"p": want_p, "x": want_x}, bf16)


def test_aux_loss_encourages_balance():
    """The reference's ``test_aux_loss_encourages_balance`` on the port,
    each aux loss equal to the reference's."""
    kw = dict(num_experts=4, top_k=1, d_ff=8, router_aux_weight=1.0)
    ref_cfg, cfg = ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    rp = jax.tree.map(np.asarray, ref_moe.moe_init(KEY, 8, ref_cfg))
    skew = np.zeros_like(rp["router"])
    skew[:, 0] = 100.0
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (64, 8)))
    auxes = []
    for router in (skew, rp["router"]):
        p = dict(rp, router=router)
        _, want = ref_moe.moe_apply(p, jnp.asarray(x), ref_cfg)
        _, got = moe.moe_apply(L.tree_from_reference(p), torch.from_numpy(x),
                               cfg)
        np.testing.assert_allclose(float(got), float(want), **LOSS)
        auxes.append(float(got))
    assert auxes[0] > auxes[1]


# --------------------------------------------------------------- the step

@pytest.mark.parametrize("arch", LM)
def test_lm_smoke_train(arch):
    """The train half of the reference's ``test_lm_smoke``, on the port's
    own initialisation: a finite loss and a nonzero finite gradient."""
    cfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=torch.float32)
    params = tfm.init_params(seeded_generator(0), cfg)
    toks = torch.from_numpy(tokens(cfg, seed=40)[0])
    loss, grads = port_value_and_grad(
        lambda p: tfm.train_loss(p, toks, toks, cfg), params)
    assert np.isfinite(float(loss))
    gn = sum(float(torch.sum(torch.abs(g))) for g in grads)
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("arch", ["granite_moe", "deepseek_7b"])
def test_make_lm_step_equals_reference(arch):
    """Three steps of ``make_lm_step`` on ``lm_batch``'s tokens against the
    reference's: losses, gradient norms, learning rates, the parameters
    and both AdamW moments."""
    ref_cfg, cfg, rp, pp = both_params(arch)
    kw = dict(total_steps=3, warmup_steps=1)
    ref_step = ref_train.make_lm_step(ref_cfg, ref_adamw.AdamWConfig(**kw))
    opt = adamw.AdamWConfig(**kw)
    step = train.make_lm_step(cfg, opt)
    dcfg = datapipe.TokenPipelineConfig(cfg.vocab, 16, 2)
    ref_dcfg = ref_datapipe.TokenPipelineConfig(cfg.vocab, 16, 2)
    rs = (jax.tree.map(jnp.asarray, rp), ref_adamw.init_state(rp))
    ps = (pp, adamw.init_state(pp))
    for s in range(3):
        b = datapipe.lm_batch(dcfg, s)
        assert all(np.array_equal(a, c) for a, c in
                   zip(b, ref_datapipe.lm_batch(ref_dcfg, s)))
        rs, raux = ref_step(rs, jax.tree.map(jnp.asarray, b))
        ps, aux = step(ps, datapipe.to_device(b))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(aux[k]), float(raux[k]),
                                       rtol=1e-6, err_msg=k)
    assert int(ps[1].step) == int(rs[1].step) == 3
    for got, want, tol in ((ps[1].mu, rs[1].mu, OPT_TOL),
                           (ps[1].nu, rs[1].nu, OPT_TOL),
                           (ps[0], rs[0], dict(rtol=0, atol=opt.lr / 4))):
        paths, wl, _ = _flatten_with_paths(want)
        for path, g, w in zip(paths, leaves(got), wl):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol,
                                       err_msg=path)
