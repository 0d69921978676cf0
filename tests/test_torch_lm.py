"""The language-model serving slice of the port (``models.layers``' LM
half, ``models.attention_chunked``, ``models.moe``, ``models.transformer``,
the five LM configs and ``launch.serve``), held against the reference on
the CPU.

Inputs are drawn from a seed with numpy; parameters are the reference's
(``jax.random.PRNGKey(0)``), carried across with
``layers.tree_from_reference``.  Float32 unless a test says otherwise.

Tolerances, each with its reason:
- float32 values (RoPE, attention, FFN, MoE outputs, logits, caches,
  hidden states, losses): ``rtol=1e-4, atol=1e-5``.  XLA and PyTorch's
  CPU BLAS sum the matmuls' products in other orders, XLA contracts
  ``a*b - c*d`` into fused multiply-adds, and their ``exp``, ``cos``,
  ``sin`` and ``pow`` differ by ulps; two layers keep the differences near
  1e-6 on values of order 1.
- MoE routing (top-k experts, the stable order, kept slots and drops):
  bit for bit; the router's softmax is the same expression in both.
- serving: the greedy tokens and ``ServeStats`` equal.  An argmax could
  flip only where two logits lie within the logit tolerance; the test
  checks that no step's top-2 margin is that close, so equality is the
  claim (it held for every SMOKE arch at this seed).
- bfloat16 prefill at the configs' own dtype: ``rtol=atol=5e-2`` on the
  logits and caches.  bfloat16 keeps 8 bits, and the MoE's combine sums
  in float32 in the port (its kernels take float32) where the reference
  sums bfloat16 contributions in bfloat16.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_arch as ref_get_arch
from repro.launch import serve as ref_serve
from repro.models import attention_chunked as ref_ac
from repro.models import layers as ref_L
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro_torch.checkpoint.checkpointer import flatten_with_paths
from repro_torch.configs import get_arch
from repro_torch.core.rng import seeded_generator
from repro_torch.launch import serve
from repro_torch.models import attention_chunked as ac
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
LM = ("phi35_moe", "granite_moe", "deepseek_7b", "minitron_8b",
      "stablelm_12b")


def rng(seed=0):
    return np.random.default_rng(seed)


def normal(shape, seed=0, dtype=np.float32):
    return rng(seed).standard_normal(shape).astype(dtype)


def close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


def configs(arch, dtype="float32"):
    """The arch's SMOKE config in both packages, at ``dtype``."""
    ref = ref_get_arch(arch).SMOKE
    port = get_arch(arch).SMOKE
    if dtype == "float32":
        ref = dataclasses.replace(ref, dtype=jnp.float32)
        port = dataclasses.replace(port, dtype=torch.float32)
    return ref, port


@functools.lru_cache(maxsize=None)
def ref_params(cfg):
    """The reference's parameters for ``cfg`` (numpy leaves)."""
    p = jax.jit(functools.partial(ref_tfm.init_params, cfg=cfg),
                compiler_options={"xla_backend_optimization_level": 0})(KEY)
    return jax.tree.map(np.asarray, p)


def both_params(arch, dtype="float32"):
    ref_cfg, port_cfg = configs(arch, dtype)
    rp = ref_params(ref_cfg)
    return ref_cfg, port_cfg, rp, L.tree_from_reference(rp)


# ------------------------------------------------------------------ trees

def test_tree_from_reference_carries_bfloat16_bit_for_bit():
    x = jax.random.normal(KEY, (7, 5), jnp.bfloat16) * 1e3
    tree = {"a": np.asarray(x), "b": [np.asarray(x[0]),
                                      np.arange(3, dtype=np.int32)]}
    got = L.tree_from_reference(tree)
    assert got["a"].dtype == torch.bfloat16
    assert np.array_equal(got["a"].view(torch.uint16).numpy(),
                          np.asarray(x).view(np.uint16))
    assert np.array_equal(got["b"][0].view(torch.uint16).numpy(),
                          np.asarray(x[0]).view(np.uint16))
    assert got["b"][1].dtype == torch.int32
    got["a"][0, 0] = 0                      # a copy, writable
    assert np.asarray(x)[0, 0] != 0


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_equals_reference(dtype):
    np.testing.assert_allclose(L.rope_freqs(64, 5e5).numpy(),
                               np.asarray(ref_L.rope_freqs(64, 5e5)),
                               rtol=1e-6)
    x = normal((2, 9, 3, 16), 1)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    for pos in (np.arange(9)[None, :], np.full((2, 1), 37)):
        want = ref_L.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos))
        got = L.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos))
        assert got.dtype == tdt
        close(got, want.astype(jnp.float32),
              **({} if dtype == "float32" else BF16_TOL))


def attention_params(d=32, hq=4, hkv=2, dh=8):
    p = ref_L.attention_init(KEY, d, hq, hkv, dh)
    return jax.tree.map(np.asarray, p), hq // hkv


@pytest.mark.parametrize("path", ["full", "full_noncausal", "chunked",
                                  "decode"])
def test_attention_equals_reference(path):
    rp, n_rep = attention_params()
    pp = L.tree_from_reference(rp)
    B, S = 2, 16
    x = normal((B, S, 32), 2)
    pos = np.arange(S)[None, :]
    kw = dict(n_rep=n_rep, causal=path != "full_noncausal")
    if path == "chunked":
        kw.update(chunked=True, q_block=4, kv_block=8)
    if path == "decode":
        T, cl = 24, 9
        ck, cv = normal((B, T, 2, 8), 3), normal((B, T, 2, 8), 4)
        x, pos = x[:, :1], np.full((B, 1), cl)
        want, (wk, wv) = ref_L.attention(rp, jnp.asarray(x), jnp.asarray(pos),
                                         kv_cache=(jnp.asarray(ck),
                                                   jnp.asarray(cv)),
                                         cache_len=jnp.asarray(cl), **kw)
        ckt, cvt = torch.from_numpy(ck), torch.from_numpy(cv)
        got, (gk, gv) = L.attention(pp, torch.from_numpy(x),
                                    torch.from_numpy(pos),
                                    kv_cache=(ckt, cvt), cache_len=cl, **kw)
        close(gk, wk)
        close(gv, wv)
        assert np.array_equal(ckt.numpy(), ck)      # the input is not written
    else:
        want, wkv = ref_L.attention(rp, jnp.asarray(x), jnp.asarray(pos),
                                    return_kv=True, **kw)
        got, gkv = L.attention(pp, torch.from_numpy(x), torch.from_numpy(pos),
                               return_kv=True, **kw)
        for g, w in zip(gkv, wkv):
            close(g, w)
    close(got, want)


def test_ffn_equals_reference():
    rp = jax.tree.map(np.asarray, ref_L.ffn_init(KEY, 32, 48))
    x = normal((5, 32), 5)
    close(L.ffn(L.tree_from_reference(rp), torch.from_numpy(x)),
          ref_L.ffn(rp, jnp.asarray(x)))


def qkv(S=32, T=32, hq=8, hkv=2, D=16):
    return (normal((2, S, hq, D), 6), normal((2, T, hkv, D), 7),
            normal((2, T, hkv, D), 8))


@pytest.mark.parametrize("blocks", [(8, 8), (16, 32), (32, 8)])
def test_chunked_attention_equals_reference(blocks):
    q, k, v = qkv()
    qb, kb = blocks
    want = ref_ac.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                    q_block=qb, kv_block=kb)
    got = ac.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                               q_block=qb, kv_block=kb)
    close(got, want)
    close(got, ref_ac.full_attention_ref(*map(jnp.asarray, (q, k, v))))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_with_offset_equals_reference(causal):
    q, k, v = qkv(S=8, T=32)
    args = [jnp.asarray(a) for a in (q, k, v)]
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    want = ref_ac.chunked_attention(*args, causal=causal, q_block=4,
                                    kv_block=8, q_offset=20)
    got = ac.chunked_attention(*targs, causal=causal, q_block=4, kv_block=8,
                               q_offset=20, unroll=True)
    close(got, want)
    close(ac.full_attention_ref(*targs, causal=causal, q_offset=20),
          ref_ac.full_attention_ref(*args, causal=causal, q_offset=20))
    with pytest.raises(ValueError, match="divide"):
        ac.chunked_attention(*targs, q_block=3)


# -------------------------------------------------------------------- MoE

MOE_CASES = {
    "cf8": dict(num_experts=5, top_k=3, d_ff=24, capacity_factor=8.0),
    "cf0.1": dict(num_experts=5, top_k=3, d_ff=24, capacity_factor=0.1),
    "padded": dict(num_experts=5, top_k=2, d_ff=24, pad_experts_to=4),
    "row": dict(num_experts=4, top_k=2, d_ff=24, dispatch="row"),
}


def ref_routing(monkeypatch, params, x, cfg):
    """The reference's output and routing: the values its ``top_k``,
    ``argsort`` and ``searchsorted`` give inside ``moe_apply`` (returned
    from the jitted call as extra outputs), as (experts, token order,
    slot, kept)."""
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            seen[name] = out = fn(*a, **k)
            return out
        return wrapped

    def run(p, xr):
        out = ref_moe.moe_apply(p, xr, cfg)
        return out, seen["top_k"][1], seen["argsort"], seen["searchsorted"]
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", spy("top_k", jax.lax.top_k))
        m.setattr(jnp, "argsort", spy("argsort", jnp.argsort))
        m.setattr(jnp, "searchsorted", spy("searchsorted", jnp.searchsorted))
        out, experts, order, first = jax.jit(run)(params, x)
    experts = np.asarray(experts)
    T, K = experts.shape
    C = max(1, int(np.ceil(cfg.capacity_factor * K * T
                           / cfg.padded_experts)))
    order = np.asarray(order)
    pos = np.arange(T * K) - np.asarray(first)
    slot = experts.reshape(-1)[order] * C + pos
    return out, (experts, np.repeat(np.arange(T), K)[order], slot, pos < C)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_routing_and_output_equal_reference(case, monkeypatch):
    kw = MOE_CASES[case]
    ref_cfg, cfg = ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    rp = jax.tree.map(np.asarray, ref_moe.moe_init(KEY, 16, ref_cfg))
    pp = L.tree_from_reference(rp)
    x = normal((2, 12, 16), 9)
    want, waux = jax.jit(ref_moe.moe_apply_batched, static_argnums=2)(
        rp, jnp.asarray(x), ref_cfg)
    got, gaux = moe.moe_apply_batched(pp, torch.from_numpy(x), cfg)
    close(got, want)
    close(gaux, waux)
    rows = [x[b] for b in range(2)] if kw.get("dispatch") == "row" \
        else [x.reshape(24, 16)]
    drops = 0
    for xr in rows:
        (wo, wa), (w_exp, w_tok, w_slot, w_keep) = ref_routing(
            monkeypatch, rp, jnp.asarray(xr), ref_cfg)
        xt = torch.from_numpy(xr)
        _, gates, experts, C = moe._route(pp, xt, cfg)
        tok, _, slot, keep = moe._buckets(experts, gates, C)
        assert np.array_equal(experts.numpy(), w_exp)
        assert np.array_equal(tok.numpy(), w_tok)
        assert np.array_equal(keep.numpy(), w_keep)
        assert np.array_equal(slot.numpy()[w_keep], w_slot[w_keep])
        drops += int((~keep).sum())
        go, ga = moe.moe_apply(pp, xt, cfg)
        close(go, wo)
        close(ga, wa)
    if case.startswith("cf"):              # 8: none dropped; 0.1: many
        assert (drops > 0) == (case == "cf0.1")
    if case == "padded":
        assert cfg.padded_experts == 8 and pp["w_up"].shape[0] == 8


def test_moe_row_dispatch_differs_from_global_as_in_reference():
    """Row dispatch buckets each row with its own capacity; at a tight
    capacity it drops other tokens than global dispatch, in both packages
    alike."""
    kw = dict(num_experts=4, top_k=2, d_ff=24, capacity_factor=0.5)
    rp = jax.tree.map(np.asarray,
                      ref_moe.moe_init(KEY, 16, ref_moe.MoEConfig(**kw)))
    pp = L.tree_from_reference(rp)
    x = normal((2, 12, 16), 10)
    outs = {}
    for dispatch in ("row", "global"):
        want, _ = jax.jit(ref_moe.moe_apply_batched, static_argnums=2)(
            rp, jnp.asarray(x), ref_moe.MoEConfig(dispatch=dispatch, **kw))
        got, _ = moe.moe_apply_batched(
            pp, torch.from_numpy(x), moe.MoEConfig(dispatch=dispatch, **kw))
        close(got, want)
        outs[dispatch] = got
    assert not torch.allclose(outs["row"], outs["global"])


# ------------------------------------------------------------ transformer

@functools.lru_cache(maxsize=None)
def ref_fns(cfg):
    """The reference's entry points for ``cfg``, jitted once each."""
    return (jax.jit(lambda p, t: ref_tfm.forward(p, t, cfg)),
            jax.jit(lambda p, t, y: ref_tfm.train_loss(p, t, y, cfg)),
            jax.jit(lambda p, t: ref_tfm.prefill(p, t, cfg)),
            jax.jit(lambda p, t, c, n: ref_tfm.decode_step(p, t, c, n, cfg)))


@pytest.mark.parametrize("arch", LM)
def test_smoke_arch_equals_reference(arch):
    ref_cfg, cfg, rp, pp = both_params(arch)
    fwd, loss, pre, dec = ref_fns(ref_cfg)
    toks = rng(11).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    labels = rng(12).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    (wx, waux), (gx, gaux) = fwd(rp, toks), tfm.forward(pp, tt, cfg)
    close(gx, wx)
    close(gaux, waux)
    close(tfm.train_loss(pp, tt, tl, cfg), loss(rp, toks, labels))
    (wl, wkv), (gl, gkv) = pre(rp, toks), tfm.prefill(pp, tt, cfg)
    assert gl.shape == (2, 1, cfg.vocab) and gkv.shape == wkv.shape
    close(gl, wl)
    close(gkv, wkv)
    cache = np.zeros((cfg.n_layers, 2, 2, 32, cfg.n_kv_heads, cfg.d_head),
                     np.float32)
    cache[:, :, :, :24] = np.asarray(wkv)
    wl, wc = dec(rp, toks[:, :1], cache, 24)
    gl, gc = tfm.decode_step(pp, tt[:, :1], torch.from_numpy(cache), 24, cfg)
    close(gl, wl)
    close(gc, wc)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()


@pytest.mark.parametrize("vocab_parallel_ce", [False, True])
def test_knobs_that_change_no_value(vocab_parallel_ce):
    """``remat``, ``scan_layers`` and ``cast_norm_scale`` at float32 change
    no bit; ``vocab_parallel_ce`` is the reference's other cross-entropy."""
    ref_cfg, cfg, rp, pp = both_params("granite_moe")
    toks = torch.from_numpy(rng(13).integers(0, cfg.vocab, (2, 16)))
    base = tfm.train_loss(pp, toks, toks, cfg)
    for knob in (dict(remat=False), dict(scan_layers=False),
                 dict(cast_norm_scale=True)):
        assert torch.equal(tfm.train_loss(
            pp, toks, toks, dataclasses.replace(cfg, **knob)), base)
    want = ref_tfm.train_loss(
        rp, jnp.asarray(toks.numpy()), jnp.asarray(toks.numpy()),
        dataclasses.replace(ref_cfg, vocab_parallel_ce=vocab_parallel_ce))
    close(tfm.train_loss(pp, toks, toks, dataclasses.replace(
        cfg, vocab_parallel_ce=vocab_parallel_ce)), want)


def test_chunked_path_used_above_threshold():
    """At ``S >= chunk_threshold`` prefill runs the chunked path, equal to
    the reference's chunked prefill and to the port's full path."""
    ref_cfg, cfg, rp, pp = both_params("deepseek_7b")
    kw = dict(chunk_threshold=16, q_block=8, kv_block=8)
    toks = rng(14).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    wl, wkv = ref_tfm.prefill(rp, jnp.asarray(toks),
                              dataclasses.replace(ref_cfg, **kw))
    gl, gkv = tfm.prefill(pp, torch.from_numpy(toks),
                          dataclasses.replace(cfg, **kw))
    close(gl, wl)
    close(gkv, wkv)
    fl, _ = tfm.prefill(pp, torch.from_numpy(toks), cfg)
    close(gl, fl.numpy())


def test_decode_matches_forward():
    """The KV-cache invariant (the reference's test at SMOKE width): a
    decode step after a prefill gives the logits of the full forward."""
    _, cfg, _, pp = both_params("minitron_8b")
    toks = torch.from_numpy(rng(15).integers(0, cfg.vocab, (2, 12)))
    x, _ = tfm.forward(pp, toks, cfg)
    full = (x @ pp["lm_head"]).float()
    lp, kv = tfm.prefill(pp, toks[:, :11], cfg)
    close(lp[:, 0], full[:, 10].numpy(), atol=2e-4)
    cache = tfm.make_kv_cache(cfg, 2, 16, torch.float32)
    cache[:, :, :, :11] = kv
    ld, _ = tfm.decode_step(pp, toks[:, 11:12], cache, 11, cfg)
    close(ld[:, 0], full[:, 11].numpy(), atol=2e-4)


@pytest.mark.parametrize("arch", ["granite_moe", "deepseek_7b"])
def test_decode_step_writes_one_copy(arch):
    """``decode_step`` leaves its input caches as they were and returns a
    copy that differs from them only at ``cache_len``; attention with
    ``cache_in_place`` writes that row into the cache it is given."""
    _, cfg, _, pp = both_params(arch)
    cache = torch.from_numpy(normal((cfg.n_layers, 2, 2, 8, cfg.n_kv_heads,
                                     cfg.d_head), 17))
    before = cache.clone()
    tok = torch.from_numpy(rng(18).integers(0, cfg.vocab, (2, 1)))
    _, new = tfm.decode_step(pp, tok, cache, 5, cfg)
    assert torch.equal(cache, before)
    assert torch.equal(new[:, :, :, :5], before[:, :, :, :5])
    assert torch.equal(new[:, :, :, 6:], before[:, :, :, 6:])
    assert not torch.equal(new[:, :, :, 5], before[:, :, :, 5])
    x = torch.from_numpy(normal((2, 1, cfg.d_model), 19))
    pos = torch.full((2, 1), 5)
    lp = L.tree_index(pp["layers"], 0)["attn"]
    kw = dict(n_rep=cfg.n_rep, causal=False, cache_len=5)
    want, (wk, wv) = L.attention(lp, x, pos, kv_cache=(cache[0, 0],
                                                       cache[0, 1]), **kw)
    got, (gk, gv) = L.attention(lp, x, pos, kv_cache=(cache[0, 0],
                                                      cache[0, 1]),
                                cache_in_place=True, **kw)
    assert gk.data_ptr() == cache[0, 0].data_ptr()
    assert torch.equal(got, want)
    assert torch.equal(cache[0, 0], wk) and torch.equal(cache[0, 1], wv)


def test_init_draws_layers_in_order():
    """``init_params`` draws layer ``i`` into row ``i`` of the stacked
    leaves: the same bits as drawing every layer's tree in turn and
    stacking them."""
    cfg = configs("granite_moe")[1]
    params = tfm.init_params(seeded_generator(0), cfg)
    gen = seeded_generator(0)
    embed = L.normal(gen, (cfg.vocab, cfg.d_model), cfg.dtype)
    stacked = L.stack_trees([tfm._init_layer(cfg, gen, torch.device("cpu"))
                             for _ in range(cfg.n_layers)])
    lm_head = L.normal(gen, (cfg.d_model, cfg.vocab), cfg.dtype)
    s = cfg.d_model ** -0.5
    assert torch.equal(params["embed"], embed.mul_(s))
    assert torch.equal(params["lm_head"], lm_head.mul_(s))
    for (path, got), (_, want) in zip(flatten_with_paths(params["layers"]),
                                      flatten_with_paths(stacked)):
        assert torch.equal(got, want), path


@pytest.mark.parametrize("arch", ["granite_moe", "deepseek_7b"])
def test_bfloat16_prefill_close_and_float32_cache_raises(arch):
    """At the configs' own ``dtype=bfloat16`` prefill is close to the
    reference's; decode over a float32 cache promotes the residual stream
    to float32, which the reference's ``scan`` refuses as the port's loop
    does (``TypeError``)."""
    ref_cfg, cfg, rp, pp = both_params(arch, "bfloat16")
    assert cfg.dtype == torch.bfloat16
    assert pp["lm_head"].dtype == torch.bfloat16
    toks = rng(16).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    wl, wkv = ref_tfm.prefill(rp, jnp.asarray(toks), ref_cfg)
    gl, gkv = tfm.prefill(pp, torch.from_numpy(toks), cfg)
    assert gkv.dtype == torch.bfloat16
    close(gl, wl, **BF16_TOL)
    close(gkv, np.asarray(wkv, np.float32), **BF16_TOL)
    cache32 = np.zeros((cfg.n_layers, 2, 2, 16, cfg.n_kv_heads, cfg.d_head),
                       np.float32)
    with pytest.raises(TypeError):
        ref_tfm.decode_step(rp, jnp.asarray(toks[:, :1]),
                            jnp.asarray(cache32), jnp.asarray(12), ref_cfg)
    with pytest.raises(TypeError, match="carry"):
        tfm.decode_step(pp, torch.from_numpy(toks[:, :1]),
                        torch.from_numpy(cache32), 12, cfg)
    # A bfloat16 cache runs in both.
    cache16 = torch.zeros(cache32.shape, dtype=torch.bfloat16)
    gl, _ = tfm.decode_step(pp, torch.from_numpy(toks[:, :1]), cache16, 12,
                            cfg)
    assert gl.dtype == torch.float32 and torch.isfinite(gl).all()


def ref_shapes(cfg):
    tree = jax.eval_shape(functools.partial(ref_tfm.init_params, cfg=cfg),
                          KEY)
    paths, leaves, _ = _flatten_with_paths(tree)
    return {p: (tuple(x.shape), str(x.dtype)) for p, x in zip(paths, leaves)}


@pytest.mark.parametrize("arch", LM)
def test_full_config_tree_equals_reference(arch):
    """The FULL config's tree on the ``meta`` device (no memory): every
    leaf's path, shape and dtype equal to the reference's."""
    ref_cfg, cfg = ref_get_arch(arch).FULL, get_arch(arch).FULL
    params = tfm.init_params(seeded_generator(0), cfg, device="meta")
    got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in flatten_with_paths(params)}
    assert got == ref_shapes(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()


# ---------------------------------------------------------------- serving

def top2_margin(logits):
    top = torch.topk(logits, 2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


@pytest.mark.parametrize("arch", LM)
def test_serve_loop_equals_reference(arch, monkeypatch):
    """Tokens and ``ServeStats`` of the continuous-batching loop equal to
    the reference's: 3 requests (two prompt lengths, so lanes step at the
    larger position) over 2 slots, the third refilling a freed lane."""
    ref_cfg, cfg, rp, pp = both_params(arch)
    prompts = [rng(20 + i).integers(0, cfg.vocab, 6 + 2 * (i % 2))
               .astype(np.int32) for i in range(3)]
    want, wstats = ref_serve.continuous_batching_loop(
        rp, ref_cfg, [jnp.asarray(p) for p in prompts], 2, 4, cache_cap=14)
    margins = []
    real = tfm.decode_step

    def spy(*a, **k):
        out = real(*a, **k)
        margins.append(top2_margin(out[0]))
        return out
    monkeypatch.setattr(tfm, "decode_step", spy)
    got, stats = serve.continuous_batching_loop(
        pp, cfg, [torch.from_numpy(p) for p in prompts], 2, 4, cache_cap=14,
        seed=3)
    assert stats.completed == 3 and stats.busy_steps < stats.lane_steps
    assert min(margins) > TOL["atol"] + TOL["rtol"] * 10
    assert got == want
    assert dataclasses.asdict(stats) == dataclasses.asdict(wstats)
    assert stats.bubble_ratio == wstats.bubble_ratio


def test_serve_main_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                "--requests", "3", "--slots", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "completed=3" in out and "device=cpu" in out
    with pytest.raises(ValueError, match="LM archs"):
        serve.main(["--device", "cpu", "--arch", "pna"])


def test_serve_main_draws_the_same_weights_on_every_device(monkeypatch):
    """``launch.serve.main`` draws its weights on a CPU generator and
    places them on ``--device``, so ``--device cpu`` and a CUDA device
    serve the same weights (the reference's ``jax.random`` draw is the
    same on every backend).  Checked here by stopping the launcher at its
    draw, ``resolve_device`` replaced so that ``cuda`` needs no card."""
    class Drawn(Exception):
        pass
    real = tfm.init_params
    seen = []

    def spy(generator, cfg, device=None):
        seen.append((generator.device, torch.device(device), real(
            generator, cfg, device="cpu")))
        raise Drawn
    monkeypatch.setattr(tfm, "init_params", spy)
    monkeypatch.setattr(serve, "resolve_device", torch.device)
    for dev in ("cpu", "cuda"):
        with pytest.raises(Drawn):
            serve.main(["--device", dev, "--arch", "granite_moe"])
    cfg = dataclasses.replace(get_arch("granite_moe").SMOKE,
                              dtype=torch.float32)
    want = flatten_with_paths(real(seeded_generator(0), cfg))
    assert [(g.type, d.type) for g, d, _ in seen] == [("cpu", "cpu"),
                                                       ("cpu", "cuda")]
    for _, _, tree in seen:
        got = flatten_with_paths(tree)
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
