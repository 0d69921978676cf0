"""Open-system parity: the port's stream (``walk_engine.inject_queries`` /
``make_superstep_runner`` and ``Walker.stream``) against the reference's
stream, and against closed batches.

Inputs come from numpy with a seed.  The reference's stream runs its
``jnp`` step, and its ``fused`` step in interpret mode, as its own tests
run them; the port's ``cuda`` and ``fused`` steps run their kernels'
plain versions on the CPU.  Sizes follow ``tests/test_streaming.py``: the
WG stand-in at scale 9 (weighted, alias tables, 3 edge types), 16-32
lanes, 8-10 hops, capacity 32-200.

Every comparison is exact: paths, lengths, the queue counters, the head
history and all 12 ``WalkStats`` fields are integers.  Against the
reference's ``jnp`` stream all fields but ``launches`` must be equal
(the port's ``fused`` counts one launch per launch); against its
``fused`` stream with a cache every field, ``launches`` and the three
cache counters included.
"""
import numpy as np
import pytest
import torch

from repro import walker as ref_walker
from repro.core.samplers import SamplerSpec as RefSpec
from repro.core.walk_engine import EngineConfig as RefConfig
from repro.core.walk_engine import init_stream_state as ref_init
from repro.core.walk_engine import inject_queries as ref_inject
from repro.core.walk_engine import make_superstep_runner as ref_runner
from repro.core.walk_engine import maybe_build_cache as ref_cache
from repro.graph import make_dataset as ref_make_dataset
from repro_torch import walker
from repro_torch.core.rng import stream_key
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.walk_engine import (EngineConfig, _run_walks,
                                          init_stream_state, inject_queries,
                                          make_superstep_runner,
                                          maybe_build_cache)
from repro_torch.graph import make_dataset
from repro_torch.kernels.fused_superstep import ops as fused_ops

SPECS = {
    "uniform": dict(kind="uniform"),
    "alias": dict(kind="alias"),
    "rejection": dict(kind="rejection_n2v", p=2.0, q=0.5),
    "reservoir": dict(kind="reservoir_n2v", p=2.0, q=0.5),
    "metapath": dict(kind="metapath", metapath=(0, 1, 2)),
    "ppr": dict(kind="uniform", stop_prob=0.15),
}
#: The kinds every impl's chunked stream is held to the reference in.
KINDS = ("alias", "metapath", "rejection", "reservoir", "uniform")
#: Port impl variants -> (step_impl, cache_budget).
IMPLS = {"torch": ("torch", 0), "cuda": ("cuda", 0), "fused": ("fused", 0),
         "fused_cache": ("fused", 1 << 13)}
CFG = dict(num_slots=32, max_hops=10, hops_per_launch=4)
REF_IMPL = {"torch": "jnp", "cuda": "pallas", "fused": "fused"}


@pytest.fixture(scope="module")
def graphs():
    """The WG stand-in at scale 9 with every payload the five kinds sample
    from, built independently by each package."""
    kw = dict(weighted=True, with_alias=True, num_edge_types=3,
              scale_override=9)
    return ref_make_dataset("WG", **kw), make_dataset("WG", device="cpu", **kw)


def starts_of(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


class RefEngine:
    """The reference's engine-level stream: inject, then chunks."""

    def __init__(self, graph, algo, capacity, impl="jnp", seed=3, **cfg):
        spec = RefSpec(**SPECS[algo])
        self.cfg = RefConfig(**{**CFG, **cfg, "step_impl": impl})
        self.run = ref_runner(spec, self.cfg,
                              cache=ref_cache(spec, self.cfg, graph))
        self.graph, self.seed = graph, seed
        self.state = ref_init(self.cfg, capacity)

    def inject(self, qids, starts, epochs, n):
        self.state = ref_inject(self.state, np.asarray(qids, np.int32),
                                np.asarray(starts, np.int32),
                                np.asarray(epochs, np.int32), n)

    def advance(self, k):
        self.state = self.run(self.graph, self.state, self.seed, k)

    def done(self):
        return np.asarray(self.state.done)


class PortEngine:
    """The port's engine-level stream, packed once under ``fused``."""

    def __init__(self, graph, algo, capacity, impl="torch", seed=3, **cfg):
        step_impl, budget = IMPLS[impl]
        spec = SamplerSpec(**SPECS[algo])
        self.cfg = EngineConfig(**{**CFG, **cfg, "step_impl": step_impl,
                                   "cache_budget": budget})
        self.run = make_superstep_runner(
            spec, self.cfg, cache=maybe_build_cache(spec, self.cfg, graph))
        self.graph, self.key = graph, stream_key(seed)
        self.state = init_stream_state(self.cfg, capacity, graph.device)
        self.block = None
        if step_impl == "fused":
            self.state, self.block = fused_ops.pack(self.state)

    def inject(self, qids, starts, epochs, n):
        self.state = inject_queries(self.state, qids, starts, epochs, n)

    def advance(self, k):
        chunk = self.run(self.graph, self.state, self.key, k, self.block)
        self.state = chunk.state
        return chunk.supersteps

    def done(self):
        return self.state.done.numpy()


def inject_fresh(engine, starts, qid0=0):
    """Fresh (epoch 0) queries at sequential slots from ``qid0``."""
    n = len(starts)
    engine.inject(np.arange(qid0, qid0 + n), starts, np.zeros(n), n)


def drain(engine, chunk, injected=None):
    """Advance until the first ``injected`` slots (all by default) are
    done."""
    for _ in range(10_000):
        if engine.done()[:injected].all():
            return
        engine.advance(chunk)
    raise AssertionError("stream did not drain")


def state_ints(state):
    """Every integer of an engine state but the lanes: queue counters,
    head history, stats (by name), done, paths and lengths."""
    q = state.queue
    out = {f"queue.{f}": np.asarray(getattr(q, f)).astype(np.int64)
           for f in ("start_vertex", "head", "staged", "tail", "order",
                     "epoch")}
    out["head_hist"] = np.asarray(state.head_hist).astype(np.int64)
    out.update({f"stats.{f}": int(getattr(state.stats, f))
                for f in state.stats._fields})
    for f in ("done", "paths", "lengths"):
        out[f] = np.asarray(getattr(state, f)).astype(np.int64)
    return out


CACHE_COUNTERS = ("cache_hits", "cache_misses", "cache_coalesced")


def assert_state_equal(port, ref, skip=()):
    """Equal in every integer of :func:`state_ints` but the stats named in
    ``skip``."""
    got, want = state_ints(port), state_ints(ref)
    assert got.keys() == want.keys()
    for name in want:
        if name.startswith("stats.") and name[6:] in skip:
            continue
        assert np.array_equal(got[name], want[name]), name


_REF_CHUNKED = {}


def ref_chunked(rg, algo, impl):
    """The reference's chunked stream of 120 starts (chunks of 7), once
    per (kind, impl): ``jnp``, or ``fused`` with an 8 KiB cache."""
    if (algo, impl) not in _REF_CHUNKED:
        budget = dict(cache_budget=1 << 13) if impl == "fused" else {}
        ref = RefEngine(rg, algo, 120, impl=impl, **budget)
        inject_fresh(ref, starts_of(120, seed=len(algo)))
        drain(ref, 7)
        _REF_CHUNKED[algo, impl] = ref.state
    return _REF_CHUNKED[algo, impl]


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("algo", KINDS)
def test_chunked_stream_equals_reference_and_oneshot(graphs, algo, impl):
    """A stream drained in chunks of 7 supersteps equals the reference's
    stream (every field but ``launches`` against its ``jnp`` stream; with
    a cache every field against its ``fused`` stream) and the port's
    one-shot closed batch in paths and lengths."""
    rg, pg = graphs
    starts = starts_of(120, seed=len(algo))
    port = PortEngine(pg, algo, 120, impl=impl)
    inject_fresh(port, starts)
    drain(port, 7)
    skip = () if impl in ("torch", "cuda") else ("launches",)
    if impl == "fused_cache":
        skip += CACHE_COUNTERS
    assert_state_equal(port.state, ref_chunked(rg, algo, "jnp"), skip)
    if impl == "fused_cache":
        assert_state_equal(port.state, ref_chunked(rg, algo, "fused"))
        assert int(port.state.stats.cache_hits) > 0
    step_impl, budget = IMPLS[impl]
    one = _run_walks(pg, starts, SamplerSpec(**SPECS[algo]), EngineConfig(
        **CFG, step_impl=step_impl, cache_budget=budget), seed=3)
    assert torch.equal(one.paths, port.state.paths)
    assert torch.equal(one.lengths, port.state.lengths)
    assert int(port.state.stats.terminations) == 120


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
def test_midstream_injection_preserves_paths(graphs, impl):
    """Queries injected while the engine is mid-flight sample the same
    paths as the reference's stream given the same sequence, and as one
    up-front batch."""
    rg, pg = graphs
    starts = starts_of(100, seed=5)
    engines = (PortEngine(pg, "alias", 100, impl=impl, seed=5),
               RefEngine(rg, "alias", 100, impl=REF_IMPL[impl], seed=5))
    for e in engines:
        inject_fresh(e, starts[:40])
        e.advance(4)
        assert not e.done().all()
        inject_fresh(e, starts[40:], qid0=40)
        drain(e, 6)
    assert_state_equal(engines[0].state, engines[1].state)
    one = _run_walks(pg, starts, SamplerSpec(kind="alias"),
                     EngineConfig(**CFG), seed=5)
    assert torch.equal(one.paths, engines[0].state.paths)


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_inject_padding_is_inert(graphs, impl):
    """A padded injection creates no phantom query: ``tail`` advances by
    ``n_valid`` only, and nothing is written for the pad entries."""
    rg, pg = graphs
    starts = starts_of(48, seed=2)
    engines = (PortEngine(pg, "uniform", 48, impl=impl, seed=2),
               RefEngine(rg, "uniform", 48, impl=REF_IMPL[impl], seed=2))
    pad_q = np.full((32,), 48, np.int32)       # 48 = capacity = inert pad
    pad_s = np.full((32,), 7, np.int32)
    pad_q[:20] = np.arange(20)
    pad_s[:20] = starts[:20]
    for e in engines:
        e.inject(pad_q, pad_s, np.full((32,), 3, np.int32) * (
            np.arange(32) >= 20), 20)
        assert int(e.state.queue.tail) == 20
        inject_fresh(e, starts[20:], qid0=20)
        assert int(e.state.queue.tail) == 48
        drain(e, 5)
    assert_state_equal(engines[0].state, engines[1].state)


@pytest.mark.parametrize("impl", ["torch", "fused"])
@pytest.mark.parametrize("algo,mode,delay", [("uniform", "zero_bubble", 0),
                                             ("ppr", "static", 2)])
def test_staged_watermark_tracks_arrivals(graphs, algo, mode, delay, impl):
    """The controller stages only queries that arrived (``staged <=
    tail``), following arrivals chunk by chunk exactly as the reference's
    does; PPR in static mode with a delay reads the head history."""
    rg, pg = graphs
    cfg = dict(mode=mode, injection_delay=delay)
    engines = (PortEngine(pg, algo, 512, impl=impl, seed=0, **cfg),
               RefEngine(rg, algo, 512, impl=REF_IMPL[impl], seed=0, **cfg))
    starts = starts_of(90, seed=1)
    for e in engines:
        inject_fresh(e, starts[:16])
        e.advance(3)
        assert int(e.state.queue.head) <= int(e.state.queue.staged)
        assert int(e.state.queue.staged) <= int(e.state.queue.tail) == 16
    assert_state_equal(engines[0].state, engines[1].state, ("launches",))
    for at in range(16, 90, 37):
        for e in engines:
            inject_fresh(e, starts[at:at + 37], qid0=at)
            e.advance(5)
        assert_state_equal(engines[0].state, engines[1].state,
                           ("launches",))
    for e in engines:
        drain(e, 8, injected=90)
    assert_state_equal(engines[0].state, engines[1].state, ("launches",))


def soak(stream, num_vertices, total, rng, wave=8, chunk=5):
    """Push ``total`` queries through the stream's ring: inject waves of
    free slots, advance, harvest every finished live slot, release it.
    Returns {(epoch, qid): (start, path, length)}; each identity is
    harvested once and a slot's epochs increase."""
    pending = list(rng.integers(0, num_vertices, total).astype(np.int32))
    harvested, live = {}, {}
    last_epoch = np.full((stream.capacity,), -1)
    for _ in range(10 * total):
        if not (pending or live):
            break
        n = min(wave, stream.num_free, len(pending))
        if n:
            starts = np.asarray(pending[:n], np.int32)
            del pending[:n]
            qids, epochs = stream.inject(starts)
            for q, e, s in zip(qids, epochs, starts):
                assert int(e) > last_epoch[q], "epochs must increase"
                last_epoch[q] = int(e)
                live[int(q)] = (int(e), int(s))
        stream.advance(chunk)
        done = stream.done_live_mask()
        ready = [q for q in live if done[q]]
        if ready:
            paths, lengths = stream.harvest_ids(ready)
            for i, q in enumerate(ready):
                e, s = live.pop(q)
                assert (e, q) not in harvested, "harvested twice"
                harvested[e, q] = (s, paths[i].copy(), int(lengths[i]))
            stream.release(ready)
    assert len(harvested) == total, "the stream stalled"
    return harvested


PROGRAMS = {"uniform": "urw", "alias": "deepwalk", "rejection": "node2vec"}
_REF_SOAK = {}


@pytest.mark.parametrize("algo,impl", [
    ("uniform", "torch"), ("uniform", "fused"), ("uniform", "fused_cache"),
    ("alias", "cuda"), ("alias", "fused"), ("alias", "fused_cache"),
    ("rejection", "torch"), ("rejection", "fused")])
def test_soak_ring_equals_reference_stream_and_closed_batches(graphs, algo,
                                                              impl):
    """More than 3x capacity queries through a 32-slot ring of 16 lanes:
    every (epoch, qid) harvested equals the reference stream's harvest of
    the same sequence, and the row of a closed batch under ``stream_key
    (seed, epoch)``; the ring wraps, so epochs 0-3 occur."""
    rg, pg = graphs
    name = PROGRAMS[algo]
    if algo not in _REF_SOAK:
        prog = getattr(ref_walker.WalkProgram, name)(max_hops=8)
        ref = ref_walker.compile(prog, execution=ref_walker.ExecutionConfig(
            num_slots=16)).stream(rg, capacity=32, seed=11)
        _REF_SOAK[algo] = soak(ref, 512, 100, np.random.default_rng(0))
        assert ref.walk_stats().drops == 0
    step_impl, budget = IMPLS[impl]
    w = walker.compile(getattr(walker.WalkProgram, name)(max_hops=8),
                       execution=walker.ExecutionConfig(
                           num_slots=16, step_impl=step_impl,
                           cache_budget=budget))
    stream = w.stream(pg, capacity=32, seed=11)
    got = soak(stream, 512, 100, np.random.default_rng(0))
    want = _REF_SOAK[algo]
    assert got.keys() == want.keys()
    for key, (s, path, length) in want.items():
        assert got[key][0] == s and got[key][2] == length, key
        assert np.array_equal(got[key][1], path), key
    epochs = sorted({e for e, _ in got})
    assert epochs == [0, 1, 2, 3]
    for e in epochs:
        rows = {q: rec for (ee, q), rec in got.items() if ee == e}
        starts = np.zeros((32,), np.int32)
        for q, (s, _, _) in rows.items():
            starts[q] = s
        closed = w.run(pg, starts, seed=stream_key(11, e))
        for q, (_, path, length) in rows.items():
            assert np.array_equal(closed.paths[q].numpy(), path), (e, q)
            assert int(closed.lengths[q]) == length, (e, q)
    st = stream.walk_stats()
    assert st.drops == 0 and st.terminations == 100
    if step_impl == "fused":
        assert 0 < st.launches < st.supersteps
    else:
        assert st.launches == st.supersteps


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
def test_inject_after_full_drain(graphs, impl):
    """A stream drained to empty takes new arrivals: the second wave's
    walks (epoch 1 in reused slots, epoch 0 in fresh ones) equal their
    closed batches, so the fused runner re-arms its work word."""
    _, pg = graphs
    w = walker.compile(walker.WalkProgram.deepwalk(8),
                       execution=walker.ExecutionConfig(num_slots=16,
                                                        step_impl=impl))
    stream = w.stream(pg, capacity=40, seed=4)
    first = starts_of(30, seed=8)
    qids, epochs = stream.inject(first)
    stream.drain(chunk=6)
    assert stream.advance(6) == 0      # nothing left: no superstep runs
    stream.release(qids)
    second = starts_of(24, seed=9)
    qids2, epochs2 = stream.inject(second)
    assert stream.advance(3) == 3       # the arrivals are work
    stream.drain(chunk=6)
    paths, lengths = stream.harvest_ids(qids2)
    assert sorted(set(epochs2.tolist())) == [0, 1]
    for e in (0, 1):
        sel = epochs2 == e
        starts = np.zeros((40,), np.int32)
        starts[qids2[sel]] = second[sel]
        closed = w.run(pg, starts, seed=stream_key(4, e))
        assert np.array_equal(closed.paths[qids2[sel]].numpy(), paths[sel])
        assert np.array_equal(closed.lengths[qids2[sel]].numpy(),
                              lengths[sel])
    st = stream.walk_stats()
    assert st.terminations == 54


def _stream(pg, capacity=8):
    w = walker.compile(walker.WalkProgram.urw(6),
                       execution=walker.ExecutionConfig(num_slots=4))
    return w.stream(pg, capacity=capacity, seed=1)


def _overflow(s):
    s.inject(np.zeros((9,), np.int32))


def _duplicate(s):
    q, _ = s.inject(np.zeros((2,), np.int32))
    s.drain()
    s.release([q[0], q[0]])


def _not_live(s):
    s.release([3])


def _unfinished(s):
    q, _ = s.inject(np.zeros((2,), np.int32))
    s.release(q)


def _rewind(s):
    q, _ = s.inject(np.zeros((2,), np.int32))
    s.drain()
    s.release(q)
    s.seek_epochs(0)


def _seek_live(s):
    s.inject(np.zeros((2,), np.int32))
    s.seek_epochs(3)


def _reset_live(s):
    s.inject(np.zeros((2,), np.int32))
    s.reset()


def _bad_n_valid(s):
    s.inject(np.zeros((2,), np.int32), n_valid=3)


@pytest.mark.parametrize("case,error,match", [
    (_overflow, ValueError, "overflows the slot ring"),
    (_duplicate, ValueError, "duplicate"),
    (_not_live, ValueError, "not live"),
    (_unfinished, ValueError, "unfinished"),
    (_rewind, ValueError, "rewind"),
    (_seek_live, RuntimeError, "live queries"),
    (_reset_live, RuntimeError, "live queries"),
    (_bad_n_valid, ValueError, "n_valid"),
])
def test_ring_errors(graphs, case, error, match):
    """The ring's error cases raise as the reference's do."""
    with pytest.raises(error, match=match):
        case(_stream(graphs[1]))


def test_ring_economy_seek_reset_and_harvest(graphs):
    """seek_epochs moves the next occupants to that epoch; reset gives a
    fresh ring; harvest(lo, hi) reads the slots in injection order; an
    out-of-range slot id is refused before anything is written."""
    _, pg = graphs
    s = _stream(pg, capacity=8)
    q, e = s.inject(starts_of(5, seed=3))
    assert q.tolist() == [0, 1, 2, 3, 4] and e.tolist() == [0] * 5
    s.drain()
    paths, lengths = s.harvest()
    assert paths.shape == (5, 7) and (lengths >= 1).all()
    s.release(q)
    s.seek_epochs(4)
    q2, e2 = s.inject(starts_of(2, seed=4))
    assert q2.tolist() == [5, 6] and e2.tolist() == [4, 4]
    assert s.num_live == 2 and s.num_free == 6 and s.num_injected == 7
    s.drain()
    s.release(q2)
    s.reset(seed=2)
    assert s.num_free == 8 and s.num_injected == 0 and s.seed == 2
    assert s.walk_stats().supersteps == 0
    with pytest.raises(ValueError, match="slot ids"):
        inject_queries(s.state, [8], [0], [0], 1)
    assert int(s.state.queue.tail) == 0
