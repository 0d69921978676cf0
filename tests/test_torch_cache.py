"""Hot-vertex cache parity: the port's builder, payload sets, counters and
cached fused runs against the reference's.

The builder (``graph/hot_cache.py``) must pack the same block array for
array; ``PhaseProgram.cache_payloads`` must name the same payloads; the
plain counter function (``kernels/fused_superstep/ref.py::cache_counts``)
must count what a sequential transliteration of the reference's
``_cached_row_access`` counts; and a cached ``step_impl="fused"`` run on
the CPU (the kernel's plain version) must equal the reference's cached
fused run in interpret mode in paths, lengths and all 12 ``WalkStats``
fields.  Sizes follow ``tests/test_torch_fused.py``: the WG stand-in at
scale 9 with every payload, 32 slots, 10 hops, 80 starts.

Every comparison is exact: the packed arrays are verbatim copies and the
counters, paths and lengths are integers.
"""
import math

import numpy as np
import pytest
import torch

from repro.core.phase_program import lower as ref_lower
from repro.core.samplers import SamplerSpec as RefSpec
from repro.core.walk_engine import EngineConfig as RefConfig
from repro.core.walk_engine import _run_walks as ref_run_walks
from repro.graph import make_dataset as ref_make_dataset
from repro.graph.hot_cache import build_hot_cache as ref_build_hot_cache
from repro_torch import walker
from repro_torch.core.phase_program import lower
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.walk_engine import (EngineConfig, _run_walks,
                                          maybe_build_cache)
from repro_torch.graph import build_hot_cache, make_dataset
from repro_torch.kernels.fused_superstep import ops
from repro_torch.kernels.fused_superstep.ref import cache_counts

SPECS = {
    "urw": dict(kind="uniform"),
    "ppr": dict(kind="uniform", stop_prob=0.15),
    "deepwalk": dict(kind="alias"),
    "metapath": dict(kind="metapath", metapath=(0, 1, 2)),
    "node2vec": dict(kind="rejection_n2v", p=2.0, q=0.5, rejection_rounds=6),
    "node2vec_w": dict(kind="reservoir_n2v", p=2.0, q=0.5,
                       reservoir_chunk=8),
}
CFG = dict(num_slots=32, max_hops=10, step_impl="fused", hops_per_launch=4)
BUDGET = 1 << 13            # partial cover on the scale-9 graph
FULL = 1 << 22              # caches every vertex of the scale-9 graph
CACHE_ONLY = ("launches", "cache_hits", "cache_misses", "cache_coalesced")
ARRAYS = ("hot_ids", "hot_deg", "hot_off", "col", "weights", "alias_prob",
          "alias_idx", "type_offsets")
PAYLOAD_SETS = [("col",), ("col", "weights"),
                ("col", "alias_prob", "alias_idx"), ("col", "type_offsets"),
                ("col", "weights", "alias_prob", "alias_idx",
                 "type_offsets")]


@pytest.fixture(scope="module")
def graphs():
    """The WG stand-in at scale 9 with every payload the six programs
    sample from, built independently by each package."""
    kw = dict(weighted=True, with_alias=True, num_edge_types=3,
              scale_override=9)
    return ref_make_dataset("WG", **kw), make_dataset("WG", device="cpu", **kw)


def starts_of(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def run_ref(rg, starts, algo, seed, **cfg):
    return ref_run_walks(rg, starts, RefSpec(**SPECS[algo]),
                         RefConfig(**{**CFG, **cfg}), seed=seed)


def run_port(pg, starts, algo, seed, **cfg):
    return _run_walks(pg, starts, SamplerSpec(**SPECS[algo]),
                      EngineConfig(**{**CFG, **cfg}), seed=seed)


def assert_same(port, want, skip=()):
    assert np.array_equal(port.paths.numpy(), np.asarray(want.paths))
    assert np.array_equal(port.lengths.numpy(), np.asarray(want.lengths))
    assert port.stats._fields == want.stats._fields
    for f in want.stats._fields:
        if f not in skip:
            assert int(getattr(port.stats, f)) == int(getattr(want.stats, f)), f


# ------------------------------------------------------------ (a) builder

@pytest.mark.parametrize("payloads", PAYLOAD_SETS, ids="+".join)
@pytest.mark.parametrize("seed", [0, 5])
def test_build_hot_cache_equals_reference(seed, payloads):
    """Same graph, payloads and budget: the same block, array for array,
    over budgets that admit nothing, part of the graph, or all of it."""
    kw = dict(weighted=seed == 0, with_alias=True, num_edge_types=3,
              seed=seed, scale_override=8)
    rg = ref_make_dataset("WG", **kw)
    pg = make_dataset("WG", device="cpu", **kw)
    for budget in (0, -5, 16, 100, 1 << 10, 1 << 12, 1 << 14, FULL):
        got = build_hot_cache(pg, payloads, budget)
        want = ref_build_hot_cache(rg, payloads, budget)
        assert (got is None) == (want is None), budget
        if want is None:
            continue
        for name in ARRAYS:
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None), name
            if b is not None:
                b = np.asarray(b)
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert got.payloads == want.payloads
        assert got.budget_bytes == want.budget_bytes
        assert got.nbytes() == want.nbytes() <= budget
        assert got.num_hot == want.num_hot
        assert got.num_entries == want.num_entries
        assert got.probe_trips == want.probe_trips
        for v in [-1, 0, 1, pg.num_vertices - 1, pg.num_vertices,
                  *want.hot_ids[:5].tolist()]:
            assert got.slot_of(v) == want.slot_of(v), v


def test_full_budget_caches_every_vertex(graphs):
    _, pg = graphs
    cache = build_hot_cache(pg, ("col",), FULL)
    deg = (pg.row_ptr[1:] - pg.row_ptr[:-1]).numpy()
    assert cache.num_hot == pg.num_vertices
    assert np.array_equal(cache.hot_deg, deg)
    assert np.array_equal(cache.col[:pg.num_edges], pg.col.numpy())
    assert cache.probe_trips == math.ceil(math.log2(pg.num_vertices + 1))


# ---------------------------------------------------- (b) payload sets

@pytest.mark.parametrize("algo", sorted(SPECS))
def test_cache_payloads_equal_reference(algo):
    got, want = lower(SamplerSpec(**SPECS[algo])), ref_lower(
        RefSpec(**SPECS[algo]))
    assert got.cache_payloads == want.cache_payloads
    assert ([p.cacheable for p in got.phases]
            == [p.cacheable for p in want.phases])


# ------------------------------------------------------ (c) the counters

def sequential_counts(v_curr, active, hot_ids, num_vertices):
    """Passes 1, 2 and 4 of the reference's ``_cached_row_access``, lane by
    lane: the tag table filled in reverse lane order, each lane's leader
    and ``_cache_probe`` (a fixed-trip lower-bound bisection), and the
    live lanes' hit / miss / coalesced counts."""
    W = len(v_curr)
    H = len(hot_ids)
    trips = max(1, math.ceil(math.log2(H + 1)))
    tagv, tagl = [0] * W, [0] * W

    def vv_of(i):
        return min(max(int(v_curr[i]), 0), num_vertices - 1)
    for t in range(W):
        i = W - 1 - t
        s = vv_of(i) % W
        tagv[s], tagl[s] = vv_of(i), i
    hits = misses = coal = 0
    for i in range(W):
        vv = vv_of(i)
        s = vv % W
        lead = tagl[s] if tagv[s] == vv else i
        lo, hi = 0, H
        for _ in range(trips):
            mid = (lo + hi) // 2
            go = int(hot_ids[min(max(mid, 0), H - 1)]) < vv
            if lo < hi and go:
                lo = mid + 1
            elif lo < hi:
                hi = mid
        hit = lo < H and int(hot_ids[min(lo, H - 1)]) == vv
        follower = lead != i
        if active[i]:
            hits += (not follower) and hit
            misses += (not follower) and not hit
            coal += follower
    return hits, misses, coal


@pytest.mark.parametrize("width,num_vertices,num_hot", [
    (1, 5, 1), (7, 10, 3), (64, 40, 8), (64, 1000, 30), (1000, 300, 50),
    (1000, 5000, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_cache_counts_equal_sequential_passes(width, num_vertices, num_hot,
                                              seed):
    """Random lanes with never-filled lanes (-1, which clips to vertex 0),
    vertices past the last, duplicate vertices, and distinct vertices that
    share a tag slot mod W."""
    rng = np.random.default_rng(seed * 1000 + width)
    v = rng.integers(-1, num_vertices + 2, width).astype(np.int32)
    if width > 4:
        v[rng.integers(0, width, width // 3)] = v[0]        # duplicates
        v[1::5] = (v[1::5] % max(num_vertices // width, 1)) * width + 3
        v[2::9] = -1
        v = np.minimum(v, num_vertices + 1)
    active = rng.random(width) < 0.7
    hot = np.sort(rng.choice(num_vertices, num_hot, replace=False))
    hot[0] = 0 if seed == 0 else hot[0]
    hot = np.unique(hot).astype(np.int32)
    got = cache_counts(torch.from_numpy(v), torch.from_numpy(active),
                       torch.from_numpy(hot), num_vertices)
    want = sequential_counts(v, active, hot, num_vertices)
    assert tuple(int(x) for x in got) == want
    assert sum(want) == int(active.sum())


# -------------------------------------------- (d) cached runs, reference

@pytest.mark.parametrize("algo", sorted(SPECS))
@pytest.mark.parametrize("mode", ["zero_bubble", "static"])
def test_cached_fused_equal_to_reference(graphs, algo, mode):
    rg, pg = graphs
    starts = starts_of(80, seed=len(algo))
    kw = dict(mode=mode, cache_budget=BUDGET)
    got = run_port(pg, starts, algo, 9, **kw)
    assert_same(got, run_ref(rg, starts, algo, 9, **kw))
    assert int(got.stats.cache_hits) > 0
    assert 0.0 < float(got.stats.cache_hit_rate()) < 1.0


@pytest.mark.parametrize("algo", sorted(SPECS))
def test_cached_fused_full_cover_equal_to_reference(graphs, algo):
    """A budget that caches every vertex: every leader probe hits."""
    rg, pg = graphs
    starts = starts_of(60, seed=3)
    got = run_port(pg, starts, algo, 4, cache_budget=FULL)
    assert_same(got, run_ref(rg, starts, algo, 4, cache_budget=FULL))
    assert int(got.stats.cache_misses) == 0 < int(got.stats.cache_hits)


# ---------------------------------------- (e) cached == uncached (port)

@pytest.mark.parametrize("algo", sorted(SPECS))
def test_cached_equal_to_uncached_but_cache_counters(graphs, algo):
    _, pg = graphs
    starts = starts_of(70, seed=11)
    off = run_port(pg, starts, algo, 2)
    on = run_port(pg, starts, algo, 2, cache_budget=BUDGET)
    assert_same(on, off, skip=CACHE_ONLY)
    assert int(on.stats.launches) == int(off.stats.launches)
    assert all(int(getattr(off.stats, f)) == 0 for f in CACHE_ONLY[1:])
    per_hop = run_port(pg, starts, algo, 2, step_impl="torch",
                       cache_budget=BUDGET)
    assert_same(on, per_hop, skip=CACHE_ONLY)
    assert all(int(getattr(per_hop.stats, f)) == 0 for f in CACHE_ONLY[1:])
    live = int(on.stats.slot_steps) - int(on.stats.bubbles)
    assert sum(int(getattr(on.stats, f)) for f in CACHE_ONLY[1:]) == live


def test_budget_that_admits_no_vertex_turns_the_cache_off(graphs):
    rg, pg = graphs
    spec = SamplerSpec(**SPECS["urw"])
    cfg = EngineConfig(**CFG, cache_budget=16)
    assert maybe_build_cache(spec, cfg, pg) is None
    assert maybe_build_cache(spec, EngineConfig(**CFG), pg) is None
    assert maybe_build_cache(spec, EngineConfig(
        **{**CFG, "step_impl": "torch"}, cache_budget=BUDGET), pg) is None
    starts = starts_of(50)
    got = run_port(pg, starts, "urw", 1, cache_budget=16)
    assert_same(got, run_ref(rg, starts, "urw", 1, cache_budget=16))
    assert all(int(getattr(got.stats, f)) == 0 for f in CACHE_ONLY[1:])


def test_cache_block_layout(graphs):
    """The device block holds the cache's arrays in the kernel's order,
    floats as their bits, at the offsets it names."""
    _, pg = graphs
    cache = build_hot_cache(pg, PAYLOAD_SETS[-1], BUDGET)
    block = ops.cache_block(cache, torch.device("cpu"))
    w = block.words.numpy()
    H, P = cache.num_hot, cache.num_entries
    assert block.nbytes() == cache.nbytes()
    assert np.array_equal(block.hot_ids.numpy(), cache.hot_ids)
    assert np.array_equal(w[H:2 * H], cache.hot_deg)
    assert np.array_equal(w[2 * H:3 * H + 1], cache.hot_off)
    assert np.array_equal(w[block.col:block.col + P], cache.col)
    for name in ("weights", "alias_prob"):
        at = getattr(block, name)
        assert np.array_equal(w[at:at + P].view(np.float32),
                              getattr(cache, name))
    assert np.array_equal(w[block.alias_idx:block.alias_idx + P],
                          cache.alias_idx)
    at, T1 = block.type_offsets, block.type_stride
    assert np.array_equal(w[at:at + H * T1].reshape(H, T1),
                          cache.type_offsets)
    bare = ops.cache_block(build_hot_cache(pg, ("col",), BUDGET),
                           torch.device("cpu"))
    assert (bare.weights, bare.alias_prob, bare.alias_idx,
            bare.type_offsets, bare.type_stride) == (-1, -1, -1, -1, 0)


# ---------------------------------------------------- (f) Walker memo

def test_walker_memo_keeps_one_engine_per_graph(graphs):
    _, pg = graphs
    other = make_dataset("WG", weighted=True, with_alias=True,
                         num_edge_types=3, scale_override=9, device="cpu")
    starts = starts_of(40)
    prog = walker.WalkProgram.urw(8)
    cached = walker.compile(prog, execution=walker.ExecutionConfig(
        num_slots=32, step_impl="fused", cache_budget=BUDGET))
    first = cached.run(pg, starts, seed=1)
    again = cached.run(pg, starts, seed=1)
    assert len(cached._engines) == 1
    assert torch.equal(first.paths, again.paths)
    assert int(again.stats.cache_hits) == int(first.stats.cache_hits) > 0
    cached.run(other, starts, seed=1)
    assert len(cached._engines) == 2
    (engine, held), = [v for k, v in cached._engines.items()
                       if k[2] == id(pg)]
    assert held is pg
    plain = walker.compile(prog, execution=walker.ExecutionConfig(
        num_slots=32, step_impl="fused"))
    plain.run(pg, starts, seed=1)
    plain.run(other, starts, seed=1)
    assert len(plain._engines) == 1
