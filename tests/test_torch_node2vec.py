"""Node2Vec parity: the port's rejection (unweighted) and reservoir
(weighted, Efraimidis–Spirakis) samplers against the reference's.

Executor by executor, then whole closed batches: the port's ``torch`` and
``fused`` steps (on the CPU, the fused kernel's plain version) against the
reference's ``jnp`` step and its ``fused`` kernel in interpret mode, as the
reference's own tests run it.  Sizes follow ``tests/test_fused_step.py``:
the WG stand-in at scale 9, weighted, 32 slots, 10 hops, 60-100 starts.

Every comparison is exact except one: the E-S key ``log(u + 1e-20) / w``
takes a float32 log, and XLA's and torch's float32 log differ in the last
bit for some inputs (about one in seven on the CPU).  The log is pinned
within 1 ulp of the reference's, the division exact given the same log,
and so the key within 2 ulps.  Paths can differ only where two keys of one
lane-hop lie that close; at these sizes none do, and paths, lengths and
all 12 stats are held bit-equal.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import walker as ref_walker
from repro.configs.ridgewalker import ALGORITHMS as REF_ALGORITHMS
from repro.core import rng as ref_rng
from repro.core import samplers as ref_samplers
from repro.core.phase_program import chunk_gather as ref_chunk_gather
from repro.core.phase_program import make_sampler as ref_make_sampler
from repro.core.samplers import SamplerSpec as RefSpec
from repro.core.tasks import WalkerSlots as RefSlots
from repro.core.walk_engine import EngineConfig as RefConfig
from repro.core.walk_engine import _run_walks as ref_run_walks
from repro.graph import build_csr as ref_build_csr
from repro.graph import make_dataset as ref_make_dataset
from repro_torch import walker
from repro_torch.configs.ridgewalker import ALGORITHMS
from repro_torch.core import rng, samplers
from repro_torch.core.phase_program import chunk_gather, make_sampler
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.tasks import WalkerSlots
from repro_torch.core.walk_engine import EngineConfig, _run_walks
from repro_torch.graph import build_csr, make_dataset

REPO = pathlib.Path(__file__).resolve().parents[1]
SPECS = {
    "node2vec": dict(kind="rejection_n2v", p=2.0, q=0.5, rejection_rounds=6),
    "node2vec_w": dict(kind="reservoir_n2v", p=2.0, q=0.5,
                       reservoir_chunk=8),
}
DEFAULTS = {"node2vec": dict(kind="rejection_n2v", p=2.0, q=0.5),
            "node2vec_w": dict(kind="reservoir_n2v", p=2.0, q=0.5)}
CFG = dict(num_slots=32, max_hops=10)


@pytest.fixture(scope="module")
def graphs():
    """The weighted WG stand-in at scale 9, built by each package."""
    kw = dict(weighted=True, scale_override=9)
    return ref_make_dataset("WG", **kw), make_dataset("WG", device="cpu", **kw)


def starts_of(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def assert_same(port, want, launches=True):
    assert np.array_equal(port.paths.numpy(), np.asarray(want.paths))
    assert np.array_equal(port.lengths.numpy(), np.asarray(want.lengths))
    assert port.stats._fields == want.stats._fields
    for f in want.stats._fields:
        if f == "launches" and not launches:
            continue
        assert int(getattr(port.stats, f)) == int(getattr(want.stats, f)), f


def lane_vertices(pg, width, seed):
    """Vertices for ``width`` lanes: random ones plus hop-0 (-1), dangling
    and max-degree hub entries."""
    rng_ = np.random.default_rng(seed)
    deg = (pg.row_ptr[1:] - pg.row_ptr[:-1]).numpy()
    v = rng_.integers(0, pg.num_vertices, width).astype(np.int32)
    v[0::7] = -1
    v[1::7] = rng_.choice(np.flatnonzero(deg == 0), len(v[1::7]))
    v[2::7] = int(np.argmax(deg))
    return v


# ------------------------------------------------------------ executors


def test_edge_exists_equals_reference(graphs):
    """Sources at hop 0 (-1), dangling, the hub and random vertices; dst
    their true neighbors, their neighbors' ids shifted by one, and random
    vertices (so hits and misses both occur)."""
    rg, pg = graphs
    src = lane_vertices(pg, 200, seed=1)
    rng_ = np.random.default_rng(2)
    rp, col = pg.row_ptr.numpy(), pg.col.numpy()
    dst = rng_.integers(-1, pg.num_vertices, (200, 9)).astype(np.int32)
    for i, s in enumerate(src):
        if s >= 0 and rp[s + 1] > rp[s]:
            nbrs = col[rp[s]:rp[s + 1]]
            dst[i, :3] = rng_.choice(nbrs, 3)
            dst[i, 3] = nbrs[-1] + 1
    want = np.asarray(ref_samplers.edge_exists(rg, jnp.asarray(src),
                                               jnp.asarray(dst)))
    got = samplers.edge_exists(pg, torch.from_numpy(src),
                               torch.from_numpy(dst)).numpy()
    assert np.array_equal(got, want)
    assert 0 < got.sum() < got.size and not got[src < 0].any()
    assert samplers.bisect_iters(pg.max_degree) == max(
        1, int(np.ceil(np.log2(max(pg.max_degree, 2) + 1))))


@pytest.mark.parametrize("p,q", [(2.0, 0.5), (0.3, 3.0)])
def test_n2v_bias_equals_reference(graphs, p, q):
    """float32 biases equal, including a p whose 1/p float32 cannot hold:
    the constant is rounded once, as the reference's weak-typed scalar."""
    rg, pg = graphs
    v_prev = lane_vertices(pg, 120, seed=3)
    y = np.random.default_rng(4).integers(0, pg.num_vertices,
                                          (120, 6)).astype(np.int32)
    y[::5, 0] = v_prev[::5]                  # returns to v_prev
    want = np.asarray(ref_samplers.n2v_bias(RefSpec("rejection_n2v", p, q),
                                            rg, jnp.asarray(v_prev),
                                            jnp.asarray(y)))
    got = samplers.n2v_bias(SamplerSpec("rejection_n2v", p, q), pg,
                            torch.from_numpy(v_prev),
                            torch.from_numpy(y)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert len(np.unique(got)) >= 3


@pytest.mark.parametrize("p,q", [(2.0, 0.5), (0.3, 3.0)])
def test_rejection_choose_equals_reference(p, q):
    """The first accepted round wins; rows with no accept take the forced
    last round; u_acc · w_max lands exactly on w in some rows."""
    rng_ = np.random.default_rng(5)
    spec_kw = dict(kind="rejection_n2v", p=p, q=q, rejection_rounds=6)
    inv_p, inv_q, w_max = samplers.n2v_constants(SamplerSpec(**spec_kw))
    w = rng_.choice(np.float32([inv_p, 1.0, inv_q]), (300, 6))
    u = rng_.random((300, 6), dtype=np.float32)
    u[::4] = 0.999999                         # nothing accepts early
    u[1::9, 2] = w[1::9, 2] / np.float32(w_max)   # the boundary
    want = np.asarray(ref_samplers.rejection_choose(
        RefSpec(**spec_kw), jnp.asarray(u), jnp.asarray(w)))
    got = samplers.rejection_choose(SamplerSpec(**spec_kw),
                                    torch.from_numpy(u), torch.from_numpy(w))
    assert np.array_equal(got.numpy(), want)
    assert (want == 5).any() and (want == 0).any()


def _ulps(a, b):
    """Distance in float32 ulps (finite values of one sign)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_es_key_log_within_one_ulp_of_reference():
    """The E-S key log(u + 1e-20) / w.  XLA's and torch's float32 log differ
    in the last bit for some inputs, so the log is held within 1 ulp; the
    division and the mask to -inf are exact given the same log, and the
    key, the quotient of a log 1 ulp apart, lies within 2 ulps."""
    rng_ = np.random.default_rng(6)
    u = rng_.random((4096, 16), dtype=np.float32)
    u[0, :2] = [0.0, np.nextafter(np.float32(1), np.float32(0))]
    w = (rng_.random((4096, 16), dtype=np.float32) * 4).astype(np.float32)
    w[::3, 5] = 0.0
    valid = rng_.random((4096, 16)) < 0.9
    want_log = np.asarray(jnp.log(jnp.asarray(u) + 1e-20))
    log = torch.log(torch.from_numpy(u) + 1e-20)
    assert _ulps(log.numpy(), want_log).max() <= 1
    assert (_ulps(log.numpy(), want_log) == 1).any()
    mask = torch.from_numpy(valid & (w > 0))
    key = torch.where(mask, log / torch.from_numpy(w), -torch.inf).numpy()
    same_log = np.asarray(jnp.where(jnp.asarray(valid) & (jnp.asarray(w) > 0),
                                    jnp.asarray(log.numpy()) / jnp.asarray(w),
                                    -jnp.inf))
    assert np.array_equal(key, same_log)
    want_key = _ref_keys(u, valid, w)
    finite = np.isfinite(want_key)
    assert np.array_equal(finite, np.isfinite(key))
    assert _ulps(key[finite], want_key[finite]).max() <= 2


def _ref_keys(u, valid, w):
    """The reference's E-S keys (the expression inside es_chunk_score)."""
    key = jnp.where(jnp.asarray(valid) & (jnp.asarray(w) > 0),
                    jnp.log(jnp.asarray(u) + 1e-20) / jnp.asarray(w),
                    -jnp.inf)
    return np.asarray(key)


def test_es_chunk_score_and_merge_equal_reference():
    rng_ = np.random.default_rng(7)
    u = rng_.random((500, 8), dtype=np.float32)
    w = rng_.random((500, 8), dtype=np.float32) + np.float32(1e-3)
    valid = rng_.random((500, 8)) < 0.8
    valid[::11] = False                       # all-invalid chunks: index 0
    w[3::13, :] = 0.0
    want_best, want_key = ref_samplers.es_chunk_score(
        jnp.asarray(u), jnp.asarray(valid), jnp.asarray(w))
    got_best, got_key = samplers.es_chunk_score(
        torch.from_numpy(u), torch.from_numpy(valid), torch.from_numpy(w))
    assert np.array_equal(got_best.numpy(), np.asarray(want_best))
    want_key = np.array(want_key)
    finite = np.isfinite(want_key)
    assert np.array_equal(finite, np.isfinite(got_key.numpy()))
    assert _ulps(got_key.numpy()[finite], want_key[finite]).max() <= 2
    # The merge itself is exact: feed both the same chunk scores.
    best_key = np.where(rng_.random(500) < 0.3, -np.inf,
                        -rng_.random(500) * 50).astype(np.float32)
    best_key[::7] = want_key[::7]             # ties keep the earlier chunk
    best_idx = rng_.integers(0, 16, 500).astype(np.int32)
    want = ref_samplers.es_merge(jnp.asarray(best_key), jnp.asarray(best_idx),
                                 3, 8, want_best, jnp.asarray(want_key))
    got = samplers.es_merge(torch.from_numpy(best_key),
                            torch.from_numpy(best_idx), 3, 8,
                            torch.from_numpy(np.array(want_best)),
                            torch.from_numpy(want_key))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert ref_samplers.es_num_chunks(18_507, 64) == samplers.es_num_chunks(
        18_507, 64) == 290


@pytest.mark.parametrize("weighted", [True, False])
def test_chunk_gather_equals_reference(graphs, weighted):
    """Candidates and edge weights of one chunk, with (-1, 0.0) past each
    lane's degree; an unweighted graph weighs every edge 1.0."""
    rg, pg = graphs
    if not weighted:
        rg = dataclasses.replace(rg, weights=None)
        pg = dataclasses.replace(pg, weights=None)
    v = lane_vertices(pg, 64, seed=8)
    vc = np.clip(v, 0, pg.num_vertices - 1)
    rp = pg.row_ptr.numpy()
    addr = rp[vc]
    deg = np.where(v >= 0, rp[vc + 1] - rp[vc], 0).astype(np.int32)
    chunk = np.random.default_rng(9).integers(0, 3, 64).astype(np.int32)
    want = ref_chunk_gather(rg, jnp.asarray(addr), jnp.asarray(deg),
                            jnp.asarray(chunk), 8)
    got = chunk_gather(pg, torch.from_numpy(addr), torch.from_numpy(deg),
                       torch.from_numpy(chunk), 8)
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert (got[0] == -1).any() and (got[1] == 0.0).any()


@pytest.mark.parametrize("algo", sorted(SPECS))
def test_sampler_executors_equal_reference(graphs, algo):
    """One superstep's sample over a lane pool with idle lanes, hop-0
    lanes, dangling vertices and the hub: (index, ok) equal."""
    rg, pg = graphs
    W = 96
    rng_ = np.random.default_rng(10)
    v = lane_vertices(pg, W, seed=11)
    v_prev = rng_.integers(-1, pg.num_vertices, W).astype(np.int32)
    v_prev[::3] = -1
    qid = rng_.integers(0, 1000, W).astype(np.int32)
    hop = rng_.integers(0, 10, W).astype(np.int32)
    active = rng_.random(W) < 0.8
    epoch = np.zeros(W, np.int32)
    vc = np.clip(v, 0, pg.num_vertices - 1)
    rp = pg.row_ptr.numpy()
    addr = rp[vc]
    deg = np.where(v >= 0, rp[vc + 1] - rp[vc], 0).astype(np.int32)
    ref_slots = RefSlots(*(jnp.asarray(x) for x in
                           (v, v_prev, qid, hop, active, epoch)))
    slots = WalkerSlots(*(torch.from_numpy(np.asarray(x)) for x in
                          (v, v_prev, qid, hop, active, epoch)))
    want = ref_make_sampler(RefSpec(**SPECS[algo]))(
        rg, jnp.asarray(addr), jnp.asarray(deg), ref_slots,
        ref_rng.stream_key(4))
    got = make_sampler(SamplerSpec(**SPECS[algo]))(
        pg, torch.from_numpy(addr), torch.from_numpy(deg), slots,
        rng.stream_key(4))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ whole runs


def run_ref(rg, starts, spec, seed, **cfg):
    return ref_run_walks(rg, starts, RefSpec(**spec),
                         RefConfig(**{**CFG, **cfg}), seed=seed)


def run_port(pg, starts, spec, seed, **cfg):
    return _run_walks(pg, starts, SamplerSpec(**spec),
                      EngineConfig(**{**CFG, **cfg}), seed=seed)


@pytest.mark.parametrize("algo", sorted(SPECS))
@pytest.mark.parametrize("mode", [dict(mode="zero_bubble"),
                                  dict(mode="static", injection_delay=2)],
                         ids=["zero_bubble", "static_delay2"])
@pytest.mark.parametrize("impl,ref_impl", [("torch", "jnp"),
                                           ("fused", "fused")])
def test_run_bit_equal_to_reference(graphs, algo, mode, impl, ref_impl):
    """The port's torch step against the reference's jnp step, its fused
    launch (plain version) against the reference's fused kernel in
    interpret mode: paths, lengths and all 12 stats."""
    rg, pg = graphs
    starts = starts_of(80, seed=len(algo))
    kw = dict(step_impl=impl, hops_per_launch=4, **mode)
    want = run_ref(rg, starts, SPECS[algo], 9,
                   **{**kw, "step_impl": ref_impl})
    got = run_port(pg, starts, SPECS[algo], 9, **kw)
    assert_same(got, want)
    if impl == "fused":
        assert 0 < int(got.stats.launches) < int(got.stats.supersteps)
        assert_same(got, run_port(pg, starts, SPECS[algo], 9, **mode),
                    launches=False)


@pytest.mark.parametrize("algo", sorted(DEFAULTS))
def test_default_spec_bit_equal_to_reference(graphs, algo):
    """K = 12 rejection rounds, CH = 64 reservoir chunks (the defaults, as
    the main path runs them): torch and fused equal the reference's jnp."""
    rg, pg = graphs
    starts = starts_of(100, seed=12)
    want = run_ref(rg, starts, DEFAULTS[algo], 5)
    assert_same(run_port(pg, starts, DEFAULTS[algo], 5), want)
    assert_same(run_port(pg, starts, DEFAULTS[algo], 5, step_impl="fused"),
                want, launches=False)


def test_adaptive_chunks_change_no_path(graphs):
    """adaptive_chunks True, False and "auto" sample the same walks, under
    the torch and fused steps."""
    _, pg = graphs
    starts = starts_of(60, seed=13)
    runs = [run_port(pg, starts, {**SPECS["node2vec_w"],
                                  "adaptive_chunks": adaptive}, 3,
                     step_impl=impl)
            for adaptive in (True, False, "auto")
            for impl in ("torch", "fused")]
    for r in runs[1:]:
        assert_same(r, runs[0], launches=False)


def test_partial_final_chunk_equal_to_reference():
    """A hub whose degree is not a multiple of the chunk (partial final
    chunk) beside degree-4 ring vertices (one partial chunk), with the p/q
    biases live through the ring's back-edges."""
    n = 48
    edges = []
    for v in range(1, n):          # star: hub 0 <-> every spoke
        edges += [(0, v), (v, 0)]
    for v in range(1, n):          # ring over the spokes
        w = v % (n - 1) + 1
        edges += [(v, w), (w, v)]
    edges = np.asarray(edges, np.int64)
    weights = np.random.default_rng(14).random(len(edges)).astype(
        np.float32) + np.float32(1e-3)
    rg = ref_build_csr(edges, n, weights=weights)
    pg = build_csr(edges, n, weights=weights, device="cpu")
    spec = dict(kind="reservoir_n2v", p=4.0, q=0.25, reservoir_chunk=16)
    deg0 = int(pg.row_ptr[1] - pg.row_ptr[0])
    assert deg0 % 16 != 0 and deg0 > 16
    starts = np.random.default_rng(15).integers(0, n, 40).astype(np.int32)
    cfg = dict(num_slots=16, max_hops=6)
    want = run_ref(rg, starts, spec, 12, **cfg)
    assert_same(run_port(pg, starts, spec, 12, **cfg), want)
    assert_same(run_port(pg, starts, spec, 12, step_impl="fused", **cfg),
                want, launches=False)


@pytest.mark.parametrize("algo", sorted(SPECS))
def test_p_that_float32_cannot_hold(graphs, algo):
    """p = 0.3, q = 3.0: 1/p and 1/q round once to float32, as in the
    reference."""
    rg, pg = graphs
    spec = {**SPECS[algo], "p": 0.3, "q": 3.0}
    starts = starts_of(80, seed=16)
    want = run_ref(rg, starts, spec, 2)
    assert_same(run_port(pg, starts, spec, 2), want)
    assert_same(run_port(pg, starts, spec, 2, step_impl="fused"), want,
                launches=False)
    assert samplers.n2v_constants(SamplerSpec(**spec))[0] != 1.0 / 0.3


def test_node2vec_program_and_algorithms(graphs):
    """WalkProgram.node2vec and the ALGORITHMS entries mirror the
    reference's; compile(...).run runs both kinds."""
    _, pg = graphs
    for weighted in (False, True):
        prog = walker.WalkProgram.node2vec(weighted=weighted)
        ref = ref_walker.WalkProgram.node2vec(weighted=weighted)
        assert prog.name == ref.name and prog.max_hops == ref.max_hops
        assert prog.second_order and ref.second_order
        assert dataclasses.asdict(prog.spec) == dataclasses.asdict(ref.spec)
        res = walker.compile(
            dataclasses.replace(prog, max_hops=6),
            execution=walker.ExecutionConfig(num_slots=32, step_impl="fused")
        ).run(pg, starts_of(40), seed=1)
        assert int(res.stats.terminations) == 40
    assert not walker.WalkProgram.urw().second_order
    for name in ("node2vec", "node2vec_w"):
        assert dataclasses.asdict(ALGORITHMS[name]) == dataclasses.asdict(
            REF_ALGORITHMS[name])


def test_cli_node2vec_w_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.walk", "--device", "cpu",
         "--scale", "9", "--queries", "100", "--slots", "32",
         "--max-hops", "8", "--algo", "node2vec_w", "--step-impl", "fused",
         "--hops-per-launch", "4"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    line = out.stdout.strip().splitlines()[-1]
    fields = dict(f.split("=", 1) for f in line.split() if "=" in f)
    assert 0 < int(fields["launches"]) < int(fields["supersteps"])
    assert int(fields["steps"]) > 0
