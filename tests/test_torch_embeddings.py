"""Walks → embeddings on the port, held against the reference on the CPU.

``repro_torch``'s corpus ring, batch sampler, embedding-bag and
segment-sum plain versions, row gathers, AdamW, SGNS step, checkpoints and
``Walker.train_embeddings`` against ``repro``'s, on the same inputs (made
with numpy, or the reference's own tables carried across with
``params_from_reference``).

Tolerances, each with its reason:
- integer outputs (ring rows, sampled batches) and the embedding bag are
  bit-equal: the port's plain embedding bag rounds as XLA compiles the
  reference's kernel in interpret mode (an fma per slot after the first);
- segment sums: the reference's own ``atol`` (1e-4 for float32), since
  its one-hot matmul adds in another order; empty segments exactly 0;
- the gathers' gradient: 1e-6 (the same scatter, another order);
- AdamW and anything trained: ``rtol=1e-5, atol=1e-6`` on the tables —
  XLA fuses the update into fused multiply-adds, and its ``cos``, ``pow``
  and reductions differ from PyTorch's by a few ulps.
"""
import fractions
import functools
import glob
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import walker as ref_walker
from repro.core import corpus_ring as ref_ring
from repro.core import rng as ref_rng
from repro.graph import make_dataset as ref_make_dataset
from repro.kernels.embedding_bag.ops import embedding_bag as ref_embedding_bag
from repro.kernels.segment_sum.ops import segment_sum as ref_segment_sum
from repro.models import embeddings as ref_emb
from repro.optim import adamw as ref_adamw
from repro_torch import walker
from repro_torch.checkpoint import checkpointer
from repro_torch.core import corpus_ring, rng
from repro_torch.graph import make_dataset
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import fma
from repro_torch.kernels.segment_sum import SegmentSumOp, segment_sum
from repro_torch.models import embeddings as emb
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

H = 10  # hop budget of the pipeline tests
TABLE_TOL = dict(rtol=1e-5, atol=1e-6)


def _train_kw(**over):
    kw = dict(seed=3, rounds=2, walks_per_round=16, steps_per_round=8,
              batch_size=32, dim=8, window=3, num_negatives=4)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def graphs():
    """The WG stand-in at scale 9 with alias tables, built independently by
    each package."""
    kw = dict(weighted=True, with_alias=True, scale_override=9)
    return ref_make_dataset("WG", **kw), make_dataset("WG", device="cpu", **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_ring_equal(port, ref):
    for a, b in zip(port, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(_np(a), _np(b))


# --------------------------------------------------------------- ring unit

def test_salts_equal_the_reference():
    assert (rng.SALT_CORPUS, rng.SALT_NEGATIVE) == (ref_rng.SALT_CORPUS,
                                                    ref_rng.SALT_NEGATIVE)


def test_ring_init_and_validation():
    ring = corpus_ring.init_ring(8, H + 1)
    assert ring.capacity == 8 and ring.path_width == H + 1
    assert_ring_equal(ring, ref_ring.init_ring(8, H + 1))
    assert int(corpus_ring.filled(ring)) == 0
    for args in ((0, H + 1), (8, 0)):
        with pytest.raises(ValueError):
            ref_ring.init_ring(*args)
        with pytest.raises(ValueError):
            corpus_ring.init_ring(*args)


def test_ring_append_wraps_and_pads():
    """Narrow rows padded with -1, then a wrap that overwrites slots 3 and
    0: every step equal to the reference's ring."""
    ring, ref = corpus_ring.init_ring(4, 6), ref_ring.init_ring(4, 6)
    p0 = np.arange(12, dtype=np.int32).reshape(3, 4)
    p1 = np.full((2, 6), 7, np.int32)
    for p, n in ((p0, 4), (p1, 6)):
        lengths = np.full((p.shape[0],), n, np.int32)
        before = ring
        ring = corpus_ring.append(ring, torch.from_numpy(p),
                                  torch.from_numpy(lengths))
        ref = ref_ring.append(ref, jnp.asarray(p), jnp.asarray(lengths))
        assert_ring_equal(ring, ref)
        assert int(corpus_ring.filled(ring)) == int(ref_ring.filled(ref))
    assert int(ring.tail) == 5 and int(before.tail) == 3
    np.testing.assert_array_equal(ring.paths[1].numpy(), [4, 5, 6, 7, -1, -1])


def test_ring_append_rejects_oversize():
    ring = corpus_ring.init_ring(4, 6)
    with pytest.raises(ValueError, match="would overwrite"):
        corpus_ring.append(ring, torch.zeros((5, 6), dtype=torch.int32),
                           torch.zeros((5,), dtype=torch.int32))
    with pytest.raises(ValueError, match="wide"):
        corpus_ring.append(ring, torch.zeros((2, 7), dtype=torch.int32),
                           torch.zeros((2,), dtype=torch.int32))


# ----------------------------------------------------------- batch sampler

def _filled_rings(nv, rows, capacity, width=H + 1, seed=0):
    r = np.random.default_rng(seed)
    paths = r.integers(0, nv, (rows, width), dtype=np.int32)
    lengths = r.integers(1, width + 1, (rows,), dtype=np.int32)
    for i in range(rows):
        paths[i, lengths[i]:] = -1
    return (corpus_ring.append(corpus_ring.init_ring(capacity, width),
                               torch.from_numpy(paths),
                               torch.from_numpy(lengths)),
            ref_ring.append(ref_ring.init_ring(capacity, width),
                            jnp.asarray(paths), jnp.asarray(lengths)))


@functools.lru_cache(maxsize=None)
def _ref_sampler(nv, batch, window, negs):
    """One jitted reference sampler per configuration (its compile is most
    of these tests' time)."""
    return ref_ring.make_batch_sampler(nv, batch, window, negs)


@pytest.mark.parametrize("nv,rows,capacity,batch,window,negs,seed,step", [
    (64, 16, 16, 48, 3, 5, 9, 4),
    (64, 16, 16, 48, 3, 5, 9, 5),
    (1000, 5, 12, 200, 1, 1, 0, 0),       # a partly filled ring
    (777, 40, 40, 129, 10, 7, 2**31 + 5, 123_456),
])
def test_batch_sampler_bit_equal(nv, rows, capacity, batch, window, negs,
                                 seed, step):
    ring, ref = _filled_rings(nv, rows, capacity, seed=rows)
    got = corpus_ring.make_batch_sampler(nv, batch, window, negs)(
        ring, rng.stream_key(seed), step)
    want = _ref_sampler(nv, batch, window, negs)(
        ref, ref_rng.stream_key(seed), step)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[3].any() and got[0].dtype == torch.int32
    assert got[2].shape == (batch, negs)


def test_batch_sampler_empty_ring_masks_everything():
    sample = corpus_ring.make_batch_sampler(64, 48, window=3, num_negatives=5)
    got = sample(corpus_ring.init_ring(16, H + 1), rng.stream_key(0), 0)
    want = _ref_sampler(64, 48, 3, 5)(ref_ring.init_ring(16, H + 1),
                                      ref_rng.stream_key(0), 0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not bool(got[3].any())


def test_sampler_validation():
    with pytest.raises(ValueError):
        corpus_ring.make_batch_sampler(64, 16, window=0, num_negatives=3)
    with pytest.raises(ValueError):
        corpus_ring.make_batch_sampler(64, 16, window=2, num_negatives=0)


def test_no_host_copies_guard_counts_and_raises():
    before = corpus_ring.host_copies()
    corpus_ring.record_host_copy("test")
    assert corpus_ring.host_copies() == before + 1
    with pytest.raises(RuntimeError, match="no_host_copies.*site: here"):
        with corpus_ring.no_host_copies():
            corpus_ring.record_host_copy("here")
    corpus_ring.record_host_copy("after the guard")   # disarmed again


# ------------------------------------------------------------ embedding bag

@pytest.mark.parametrize("B,H_,R,D,tb", [
    (8, 3, 40, 8, 8), (100, 1, 500, 16, 32), (33, 6, 64, 4, 16),
    (64, 7, 300, 100, 16),
])
def test_embedding_bag_bit_equal_to_reference_kernel(B, H_, R, D, tb):
    """The reference's sweep shapes (and H = 7, D = 100): the Pallas kernel
    in interpret mode, as the reference's tests run it, against the port's
    plain version — bit for bit, with and without weights."""
    r = np.random.default_rng(B)
    idx = r.integers(-1, R, (B, H_)).astype(np.int32)
    w = r.random((B, H_), dtype=np.float32)
    tbl = r.standard_normal((R, D)).astype(np.float32)
    for weights in (w, None):
        want = ref_embedding_bag(jnp.asarray(idx), jnp.asarray(tbl),
                                 None if weights is None
                                 else jnp.asarray(weights), tile_b=tb)
        got = embedding_bag(torch.from_numpy(idx), torch.from_numpy(tbl),
                            None if weights is None
                            else torch.from_numpy(weights))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_embedding_bag_all_padding_and_clamp():
    want = ref_embedding_bag(jnp.full((4, 3), -1, jnp.int32),
                             jnp.ones((10, 8), jnp.float32), tile_b=4)
    got = embedding_bag(torch.full((4, 3), -1, dtype=torch.int32),
                        torch.ones((10, 8)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).all()
    tbl = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    got = embedding_bag(torch.tensor([[5], [1]], dtype=torch.int32), tbl)
    assert torch.equal(got, tbl[[2, 1]])   # an id past the table clamps


def test_embedding_bag_checks_its_inputs():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    tbl = torch.zeros((10, 8))
    with pytest.raises(TypeError):
        embedding_bag(idx.long(), tbl)
    with pytest.raises(TypeError):
        embedding_bag(idx, tbl.double())
    with pytest.raises(ValueError, match="slot"):
        embedding_bag(idx[:, :0], tbl)
    with pytest.raises(ValueError, match="match"):
        embedding_bag(idx, tbl, torch.ones((4, 3)))
    with pytest.raises(ValueError, match="2-D"):
        embedding_bag(idx, tbl[:, ::2])


def _offset_view(rows, dim, floats):
    """A (rows, dim) view ``floats`` float32 words into a fresh buffer."""
    return torch.zeros(rows * dim + floats)[floats:].view(rows, dim)


@pytest.mark.parametrize("dim,table_off,out_off,want", [
    (128, 0, 0, True),     # the SGNS shape
    (100, 0, 0, True),     # 25 float4 words a row
    (102, 0, 0, False),    # D % 4 != 0
    (128, 1, 0, False),    # a table 4 bytes past 16-byte alignment
    (128, 0, 1, False),    # an output 4 bytes past it
    (128, 4, 4, True),     # 16 bytes past: still aligned
])
def test_embedding_bag_float4_path_needs_d_and_alignment(dim, table_off,
                                                         out_off, want):
    """The wrapper takes the kernel's float4 path only when D % 4 == 0 and
    the table and output both start on 16 bytes; else the scalar path."""
    from repro_torch.kernels.embedding_bag.ops import vectorized
    table, out = _offset_view(50, dim, table_off), _offset_view(9, dim,
                                                                out_off)
    assert vectorized(table, out) is want


@pytest.mark.parametrize("name,headers", [
    ("walk_step", {"dependent_launch.cuh", "walk_common.cuh"}),
    ("fused_superstep", {"walk_common.cuh"}),
    ("embedding_bag", {"dependent_launch.cuh"}),
    ("segment_sum", {"dependent_launch.cuh"}),
])
def test_kernel_build_key_covers_its_shared_headers(name, headers,
                                                    tmp_path, monkeypatch):
    """A library's build is keyed by its source and every shared header it
    includes, so an edit to a header rebuilds each library that uses it."""
    from repro_torch.kernels import build
    src = (build._KERNELS / build.SOURCES[name]).resolve()
    assert {f.name for f in build._sources(src)} == {src.name, *headers}
    before = build.library_path(name)
    for h in headers:
        copy = tmp_path / h
        copy.write_text((build.INCLUDE_DIR / h).read_text() + "\n")
    for h in {"dependent_launch.cuh", "walk_common.cuh"} - headers:
        (tmp_path / h).write_text((build.INCLUDE_DIR / h).read_text())
    monkeypatch.setattr(build, "INCLUDE_DIR", tmp_path)
    assert build.library_path(name) != before


def _round_to_f32(x: fractions.Fraction) -> np.float32:
    """The float32 nearest to the rational ``x`` (ties to even)."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(fractions.Fraction(float(c)) - x)
        even = (int(np.array(c).view(np.uint32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_fma_rounds_once():
    """The plain version's fma equals the exactly rounded a·b + c on random
    triples and on near-cancellations and far-apart exponents, where
    rounding twice would differ."""
    r = np.random.default_rng(0)
    n = 3000
    a = r.standard_normal(n).astype(np.float32)
    b = r.standard_normal(n).astype(np.float32)
    c = (r.standard_normal(n) * 10.0 ** r.integers(-8, 8, n)).astype(
        np.float32)
    c[:500] = -(a[:500].astype(np.float64) * b[:500]).astype(np.float32)
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    for i in range(n):
        exact = (fractions.Fraction(float(a[i])) * fractions.Fraction(
            float(b[i])) + fractions.Fraction(float(c[i])))
        assert got[i].item() == float(_round_to_f32(exact)), i


# ------------------------------------------------------------- segment sum

@pytest.mark.parametrize("E,V,D,sort", [
    (64, 16, 8, True), (1000, 177, 16, True), (333, 64, 4, True),
    (1000, 177, 16, False), (300, 50, 9, False),
])
def test_segment_sum_against_reference(E, V, D, sort):
    """Within the reference's own atol for float32 (its one-hot matmul adds
    in another order); the reference sorts unsorted ids on the host."""
    r = np.random.default_rng(E + V)
    seg = r.integers(0, V, E).astype(np.int32)
    if sort:
        seg = np.sort(seg)
    dat = r.random((E, D), dtype=np.float32)
    want = ref_segment_sum(jnp.asarray(dat), seg, V, tile_e=32, row_block=16)
    got = segment_sum(torch.from_numpy(dat), torch.from_numpy(seg), V)
    assert got.shape == (V, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    empty = np.setdiff1d(np.arange(V), seg)
    assert (got.numpy()[empty] == 0).all()


def test_segment_sum_adds_in_position_order():
    """The plain version (the CUDA kernel's order): each segment starts at
    0.0 and adds its rows in ascending position, bit for bit; ids outside
    [0, S) are dropped, as jax.ops.segment_sum drops them."""
    r = np.random.default_rng(1)
    E, S, D = 2000, 40, 5
    seg = r.integers(-3, S + 3, E).astype(np.int32)
    seg[::5] = 7                                # a hub segment
    dat = (r.standard_normal((E, D)) * 10.0 ** r.integers(-4, 4, (E, 1))
           ).astype(np.float32)
    want = np.zeros((S, D), np.float32)
    for e in range(E):
        if 0 <= seg[e] < S:
            want[seg[e]] = want[seg[e]] + dat[e]
    got = segment_sum(torch.from_numpy(dat), torch.from_numpy(seg), S)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.ops.segment_sum(
            jnp.asarray(dat), jnp.asarray(seg), num_segments=S)),
        rtol=1e-5, atol=1e-4)


def test_segment_sum_op_and_input_checks():
    seg = torch.tensor([0, 0, 2, 5], dtype=torch.int32)
    dat = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    op = SegmentSumOp(seg, 6)
    assert torch.equal(op(dat), segment_sum(dat, seg, 6))
    with pytest.raises(ValueError, match="sorted"):
        SegmentSumOp(seg.flip(0), 6)
    with pytest.raises(TypeError, match="bfloat16"):
        segment_sum(dat.bfloat16(), seg, 6)
    with pytest.raises(TypeError):
        segment_sum(dat, seg.long(), 6)
    with pytest.raises(ValueError, match="rows"):
        segment_sum(dat[:3], seg, 6)


# ------------------------------------------------- gathers, AdamW, SGNS

def test_gather_rows_forward_bit_equal_backward_close():
    r = np.random.default_rng(0)
    table = r.standard_normal((128, 16)).astype(np.float32)
    ids = r.integers(0, 128, (32, 3)).astype(np.int32)
    want = ref_emb.gather_rows(jnp.asarray(table), jnp.asarray(ids),
                               use_kernel=True)
    t = torch.from_numpy(table).requires_grad_(True)
    got = emb.gather_rows(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (g_got,) = torch.autograd.grad(torch.sum(got ** 2), t)
    g_want = jax.grad(lambda x: jnp.sum(ref_emb.gather_rows(
        x, jnp.asarray(ids), use_kernel=True) ** 2))(jnp.asarray(table))
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(torch.from_numpy(table)[torch.from_numpy(ids).long()],
                       got.detach())


def _tables(r, nv=50, dim=8):
    return {"in_embed": r.standard_normal((nv, dim)).astype(np.float32),
            "out_embed": r.standard_normal((nv, dim)).astype(np.float32)}


def test_adamw_apply_updates_close_to_reference():
    """Four steps through warmup and decay (the update in place on the
    port's side) within the stated tolerance."""
    r = np.random.default_rng(3)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    params = _tables(r)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = ref_adamw.init_state(ref_p)
    got_p = emb.params_from_reference(params)
    got_s = adamw.init_state(got_p)
    for _ in range(4):
        grads = _tables(r)
        ref_p, ref_s, ref_stats = ref_adamw.apply_updates(
            ref_p, {k: jnp.asarray(v) for k, v in grads.items()}, ref_s,
            ref_adamw.AdamWConfig(**cfg))
        got_p, got_s, stats = adamw.apply_updates(
            got_p, emb.params_from_reference(grads), got_s,
            adamw.AdamWConfig(**cfg))
        for k in params:
            np.testing.assert_allclose(got_p[k].numpy(), np.asarray(ref_p[k]),
                                       **TABLE_TOL)
            np.testing.assert_allclose(got_s.nu[k].numpy(),
                                       np.asarray(ref_s.nu[k]), **TABLE_TOL)
        assert int(got_s.step) == int(ref_s.step)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(stats[name]),
                                       float(ref_stats[name]), rtol=1e-6)


def test_sgns_step_from_carried_params():
    r = np.random.default_rng(5)
    nv, dim, B, K = 60, 8, 24, 4
    cfg = dict(num_vertices=nv, dim=dim, num_negatives=K, window=3)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    params = _tables(r, nv, dim)
    batch = (r.integers(0, nv, B).astype(np.int32),
             r.integers(0, nv, B).astype(np.int32),
             r.integers(0, nv, (B, K)).astype(np.int32),
             r.random(B) < 0.8)
    ref_params = {k: jnp.asarray(v) for k, v in params.items()}
    ref_step = ref_emb.make_sgns_step(ref_emb.SkipGramConfig(**cfg),
                                      ref_adamw.AdamWConfig(**opt))
    want_p, want_s, want_aux = ref_step(
        ref_params, ref_adamw.init_state(ref_params),
        tuple(jnp.asarray(x) for x in batch))
    got_params = emb.params_from_reference(params)
    step = emb.make_sgns_step(emb.SkipGramConfig(**cfg),
                              adamw.AdamWConfig(**opt))
    got_p, got_s, aux = step(got_params, adamw.init_state(got_params),
                             tuple(torch.from_numpy(x) for x in batch))
    np.testing.assert_allclose(float(aux["loss"]), float(want_aux["loss"]),
                               rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]),
                                   **TABLE_TOL)
        np.testing.assert_allclose(got_s.mu[k].numpy(),
                                   np.asarray(want_s.mu[k]), **TABLE_TOL)
    carried = emb.opt_state_from_reference(want_s)
    assert int(carried.step) == 1 and torch.equal(
        carried.mu["in_embed"], torch.from_numpy(np.array(
            want_s.mu["in_embed"])))


def test_sgns_steps_on_one_batch_lower_its_loss():
    """Steps repeated on one batch lower its loss every time: the step
    descends the SGNS objective (the check chip_smoke.py makes at full
    width)."""
    r = np.random.default_rng(6)
    nv, dim, B, K = 200, 16, 64, 5
    cfg = emb.SkipGramConfig(num_vertices=nv, dim=dim, num_negatives=K,
                             window=3)
    step = emb.make_sgns_step(cfg, adamw.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=8))
    params = emb.init_params(torch.Generator().manual_seed(0), cfg)
    opt = adamw.init_state(params)
    batch = (torch.from_numpy(r.integers(0, nv, B).astype(np.int32)),
             torch.from_numpy(r.integers(0, nv, B).astype(np.int32)),
             torch.from_numpy(r.integers(0, nv, (B, K)).astype(np.int32)),
             torch.ones(B, dtype=torch.bool))
    losses = []
    for _ in range(6):
        params, opt, aux = step(params, opt, batch)
        losses.append(float(aux["loss"]))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_pairs_from_walks_equals_reference():
    r = np.random.default_rng(2)
    paths = r.integers(-1, 30, (6, 9)).astype(np.int32)
    lengths = r.integers(0, 10, 6).astype(np.int32)
    for max_pairs in (None, 20):
        got = emb.pairs_from_walks(paths, lengths, 2,
                                   np.random.default_rng(0), max_pairs)
        want = ref_emb.pairs_from_walks(paths, lengths, 2,
                                        np.random.default_rng(0), max_pairs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip(tmp_path):
    tree = {"b": (torch.arange(4, dtype=torch.int32),
                  adamw.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                                   mu={"x": torch.ones(2, 3)},
                                   nu={"x": torch.full((2, 3), 0.5)})),
            "a": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}
    d = str(tmp_path)
    checkpointer.save(d, 7, tree)
    checkpointer.save(d, 12, tree)
    assert checkpointer.latest_step(d) == 12
    assert not glob.glob(d + "/*.tmp")
    back = checkpointer.restore(d, 7, tree)
    assert isinstance(back["b"][1], adamw.AdamWState)
    for (p, x), (q, y) in zip(checkpointer.flatten_with_paths(back),
                              checkpointer.flatten_with_paths(tree)):
        assert p == q and x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="leaves"):
        checkpointer.restore(d, 7, {"a": tree["a"]})
    assert checkpointer.latest_step(str(tmp_path / "none")) is None


# ------------------------------------------------------- the whole pipeline

def _record_into(log):
    def hook(step, batch):
        log.append((step, tuple(_np(x).copy() for x in batch)))
    return hook


@pytest.mark.parametrize("name", ["urw", "deepwalk"])
def test_train_embeddings_matches_reference(graphs, monkeypatch, name):
    """Both packages start from the reference's tables: ring contents and
    every batch bit-equal, the trained tables within TABLE_TOL."""
    rg, pg = graphs
    ref_log, log = [], []
    kw = _train_kw()
    want = ref_walker.compile(getattr(ref_walker.WalkProgram, name)(
        max_hops=H)).train_embeddings(rg, **kw, use_kernel=False,
                                      batch_hook=_record_into(ref_log))
    ref_init = ref_emb.init_params(ref_rng.stream_key(kw["seed"]),
                                   want["config"])
    monkeypatch.setattr(emb, "init_params", lambda gen, cfg, device=None:
                        emb.params_from_reference(ref_init, device))
    got = walker.compile(getattr(walker.WalkProgram, name)(
        max_hops=H)).train_embeddings(pg, **kw, batch_hook=_record_into(log))
    assert got["step"] == want["step"] == 16
    assert_ring_equal(got["ring"], want["ring"])
    assert [s for s, _ in log] == [s for s, _ in ref_log] == list(range(16))
    for (_, a), (_, b) in zip(log, ref_log):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for k in ("in_embed", "out_embed"):
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   np.asarray(want["params"][k]), **TABLE_TOL)
    assert int(got["opt_state"].step) == 16


@pytest.fixture(scope="module")
def urw():
    return walker.compile(walker.WalkProgram.urw(H))


def test_overlap_mode_makes_zero_host_copies(graphs, urw):
    before = corpus_ring.host_copies()
    with corpus_ring.no_host_copies():
        out = urw.train_embeddings(graphs[1], **_train_kw())
    assert corpus_ring.host_copies() == before
    assert out["step"] == 16


def test_serial_mode_trips_the_guard(graphs, urw):
    with pytest.raises(RuntimeError, match="no_host_copies"):
        with corpus_ring.no_host_copies():
            urw.train_embeddings(graphs[1], **_train_kw(overlap=False))


def test_serial_mode_counts_round_trips(graphs, urw):
    before = corpus_ring.host_copies()
    urw.train_embeddings(graphs[1], **_train_kw(overlap=False))
    # One path round-trip per round plus one batch staging per step.
    assert corpus_ring.host_copies() - before == 2 + 2 * 8


def test_overlap_and_serial_are_bit_identical(graphs, urw):
    over = urw.train_embeddings(graphs[1], **_train_kw(overlap=True))
    ser = urw.train_embeddings(graphs[1], **_train_kw(overlap=False))
    for k in ("in_embed", "out_embed"):
        assert torch.equal(over["params"][k], ser["params"][k])
    assert torch.equal(over["opt_state"].nu["out_embed"],
                       ser["opt_state"].nu["out_embed"])
    assert_ring_equal(over["ring"], ser["ring"])


def test_checkpoint_resume_is_bit_identical(graphs, urw, tmp_path):
    kw = _train_kw(log_every=4)
    ref_log = []
    ref = urw.train_embeddings(graphs[1], **kw,
                               batch_hook=_record_into(ref_log))
    ckpt = str(tmp_path / "ckpt")
    urw.train_embeddings(graphs[1], **kw, ckpt_dir=ckpt, ckpt_every=4)
    # Simulate preemption after step 8: drop every later checkpoint.
    kept = 0
    for p in glob.glob(ckpt + "/step_*"):
        if int(p.rsplit("_", 1)[1]) > 8:
            shutil.rmtree(p)
        else:
            kept += 1
    assert kept == 2
    res_log = []
    res = urw.train_embeddings(graphs[1], **kw, ckpt_dir=ckpt, ckpt_every=4,
                               batch_hook=_record_into(res_log))
    assert res["step"] == ref["step"] == 16
    # The resumed run replays exactly steps 8..15 with the uninterrupted
    # run's batches, and lands on bit-identical tables and moments.
    tail = {s: b for s, b in ref_log if s >= 8}
    assert [s for s, _ in res_log] == sorted(tail)
    for s, batch in res_log:
        for x, y in zip(batch, tail[s]):
            np.testing.assert_array_equal(x, y)
    for k in ("in_embed", "out_embed"):
        assert torch.equal(res["params"][k], ref["params"][k])
        assert torch.equal(res["opt_state"].mu[k], ref["opt_state"].mu[k])
    assert_ring_equal(res["ring"], ref["ring"])
    assert [h["step"] for h in ref["history"]] == [4, 8, 12, 16]
    assert all(np.isfinite(h["loss"]) for h in ref["history"])


# ------------------------------------------------ the overlapped pipeline

OVERLAP_TIMEOUT_S = 60   # a serial order of issue deadlocks into this


def _fake_pipeline(rounds=3, spr=4, produce=None, step=None):
    """``run_pipelined`` over fakes: a round's walks are ``(round,)``, the
    ring is the list of rounds appended and the state counts steps."""
    def append(ring, walks):
        return ring + [walks[0]]

    def sample(ring, s):
        return (s, tuple(ring))

    def step_fn(state, batch):
        return state + 1, {}
    cfg = train_loop.PipelineConfig(rounds=rounds, steps_per_round=spr)
    return train_loop.run_pipelined(produce or (lambda r: (r,)), append,
                                    sample, step or step_fn, 0, [], cfg)


def test_run_pipelined_produces_while_the_steps_are_issued():
    """Round 1's producer waits for round 0's first grad step: only an
    order that issues round 0's steps while round 1 is produced, off the
    caller's thread, gets past it."""
    stepped = threading.Event()
    threads, batches = {}, []

    def produce(r):
        threads[r] = threading.get_ident()
        if r == 1 and not stepped.wait(OVERLAP_TIMEOUT_S):
            raise TimeoutError("round 0's first step was never issued "
                               "while round 1 was produced")
        return (r,)

    def step(state, batch):
        batches.append(batch)
        stepped.set()
        return state + 1, {}
    before = threading.active_count()
    state, ring, n, _, _ = _fake_pipeline(produce=produce, step=step)
    assert (state, ring, n) == (12, [0, 1, 2], 12)
    assert set(threads) == {0, 1, 2}
    assert threading.get_ident() not in threads.values()
    # Step s of round r sees rounds 0..r, and no later one.
    assert batches == [(s, tuple(range(s // 4 + 1))) for s in range(12)]
    assert threading.active_count() == before


class _Boom(Exception):
    pass


@pytest.mark.parametrize("where", ["producer", "step"])
def test_run_pipelined_raises_and_joins_its_thread(where):
    """An exception in the producer reaches the caller when its round is
    taken; one in a step while a round is in flight ends the loop too.
    Either way the producer's thread is joined."""
    def produce(r):
        if where == "producer" and r == 1:
            raise _Boom("producer")
        return (r,)

    def step(state, batch):
        if where == "step" and batch[0] == 2:
            raise _Boom("step")
        return state + 1, {}
    before = threading.active_count()
    with pytest.raises(_Boom, match=where):
        _fake_pipeline(produce=produce, step=step)
    assert threading.active_count() == before


def test_overlapped_serial_and_resumed_runs_are_bit_identical(graphs,
                                                              tmp_path):
    """DeepWalk on the fused engine over 3 rounds: the overlapped run, the
    serial one and one resumed from a checkpoint taken inside round 1
    (round 2 in flight, so the checkpoint's ring holds rounds 0 and 1)
    agree bit for bit in tables, moments and ring."""
    w = walker.compile(walker.WalkProgram.deepwalk(H), execution=(
        walker.ExecutionConfig(step_impl="fused", num_slots=16)))
    kw = _train_kw(rounds=3)
    before = threading.active_count()
    over = w.train_embeddings(graphs[1], **kw)
    ser = w.train_embeddings(graphs[1], **kw, overlap=False)
    ckpt = str(tmp_path / "ckpt")
    w.train_embeddings(graphs[1], **kw, ckpt_dir=ckpt, ckpt_every=4)
    for p in glob.glob(ckpt + "/step_*"):
        if int(p.rsplit("_", 1)[1]) > 12:
            shutil.rmtree(p)
    assert checkpointer.latest_step(ckpt) == 12
    saved = checkpointer.restore(ckpt, 12, {"state": (over["params"],
                                                      over["opt_state"]),
                                            "ring": over["ring"]})
    assert int(saved["ring"].tail) == 2 * kw["walks_per_round"]
    res = w.train_embeddings(graphs[1], **kw, ckpt_dir=ckpt, ckpt_every=4)
    assert threading.active_count() == before
    for out in (ser, res):
        assert out["step"] == over["step"] == 24
        for k in ("in_embed", "out_embed"):
            assert torch.equal(out["params"][k], over["params"][k])
            assert torch.equal(out["opt_state"].mu[k],
                               over["opt_state"].mu[k])
            assert torch.equal(out["opt_state"].nu[k],
                               over["opt_state"].nu[k])
        assert_ring_equal(out["ring"], over["ring"])


def test_train_embeddings_producer_error_reaches_the_caller(graphs, urw,
                                                            monkeypatch):
    """A round that fails on the producer's thread fails the call, and no
    thread outlives it."""
    import importlib
    module = importlib.import_module("repro_torch.walker.compile")
    real = module.build_engine

    def failing(*a, **k):
        run = real(*a, **k)

        def produce(graph, starts, key):
            if int(starts[0]) != 0:
                raise _Boom("round")
            return run(graph, starts, key)
        return produce
    monkeypatch.setattr(module, "build_engine", failing)
    w = walker.compile(walker.WalkProgram.urw(H - 1))
    before = threading.active_count()
    with pytest.raises(_Boom, match="round"):
        w.train_embeddings(graphs[1], **_train_kw())
    assert threading.active_count() == before


def test_train_embeddings_has_only_the_kernel_gathers(graphs, urw):
    """``use_kernel`` stays for the reference's signature; False would be
    plain indexing, whose backward on the card is not deterministic."""
    with pytest.raises(ValueError, match="use_kernel=False"):
        urw.train_embeddings(graphs[1], **_train_kw(), use_kernel=False)


def test_train_embeddings_validation(graphs, urw):
    with pytest.raises(ValueError, match="positive"):
        urw.train_embeddings(graphs[1], rounds=0)
    with pytest.raises(ValueError, match="would overwrite"):
        urw.train_embeddings(graphs[1], **_train_kw(ring_capacity=8))
