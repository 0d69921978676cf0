"""Service parity: the port's walk service (``repro_torch.serve`` over
``Walker.serve``) against the reference's (``repro.serve``), its chunk
controller, its open-load runner, the deprecated 3-argument
``inject_queries`` shim and the serving CLI.

Inputs come from numpy with a seed, on the WG stand-in at scale 9
(weighted, alias tables, 3 edge types), built by each package.  The
reference's services run its ``jnp`` step, and its ``fused`` step in
interpret mode, as its own tests run them; the port's ``cuda`` and
``fused`` steps run their kernels' plain versions on the CPU.

Every comparison is exact: the requests' slot ids, epochs, paths,
lengths and superstep clocks are integers, the stats are integers, and
every ``ServiceAnalysis`` field compared is an integer or a ratio of the
same integers computed in the same order.  Wall-clock fields
(``wall_*``, ``msteps_per_s``) are never compared.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import walker as ref_walker
from repro.core.samplers import SamplerSpec as RefSpec
from repro.core.walk_engine import EngineConfig as RefConfig
from repro.core.walk_engine import _run_walks as ref_run_walks
from repro.graph import make_dataset as ref_make_dataset
from repro.serve import HopsController as RefHopsController
from repro.serve import OpenLoad as RefOpenLoad
from repro.serve import run_open_load as ref_run_open_load
from repro_torch import walker
from repro_torch.core.rng import stream_key
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.scheduler import ServiceAnalysis
from repro_torch.core.walk_engine import (EngineConfig, _run_walks,
                                          init_stream_state, inject_queries,
                                          make_superstep_runner)
from repro_torch.graph import make_dataset
from repro_torch.kernels.fused_superstep import ops as fused_ops
from repro_torch.serve import (AdaptationEvent, HopsController, OpenLoad,
                               WalkRequest, WalkService, run_open_load)

REPO = pathlib.Path(__file__).resolve().parents[1]
#: kind -> (program constructor name, its arguments)
PROGRAMS = {
    "uniform": ("urw", ()),
    "ppr": ("ppr", (0.15,)),
    "alias": ("deepwalk", ()),
    "metapath": ("metapath", ((0, 1, 2),)),
    "rejection": ("node2vec", (2.0, 0.5)),
    "reservoir": ("node2vec", (2.0, 0.5)),
}
#: The kinds every service is held to the reference's in.
KINDS = ("alias", "metapath", "rejection", "reservoir", "uniform")
REQ_FIELDS = ("qids", "epochs", "paths", "lengths", "submitted_at",
              "admitted_at", "completed_at")
EXEC = dict(num_slots=16, hops_per_launch=4)
MAX_HOPS = 8


@pytest.fixture(scope="module")
def graphs():
    """The WG stand-in at scale 9 with every payload the five kinds sample
    from, built independently by each package."""
    kw = dict(weighted=True, with_alias=True, num_edge_types=3,
              scale_override=9)
    return ref_make_dataset("WG", **kw), make_dataset("WG", device="cpu", **kw)


def program(pkg, kind, max_hops=MAX_HOPS):
    name, args = PROGRAMS[kind]
    kw = dict(weighted=True) if kind == "reservoir" else {}
    return getattr(pkg.WalkProgram, name)(*args, max_hops=max_hops, **kw)


def ref_service(rg, kind, impl="jnp", capacity=40, chunk=5, seed=3,
                max_hops=MAX_HOPS, **kw):
    execution = ref_walker.ExecutionConfig(**{**EXEC, "step_impl": impl})
    return ref_walker.compile(program(ref_walker, kind, max_hops),
                              execution=execution).serve(
        rg, capacity=capacity, chunk=chunk, seed=seed, **kw)


def port_service(pg, kind, impl="torch", capacity=40, chunk=5, seed=3,
                 max_hops=MAX_HOPS, **kw):
    execution = walker.ExecutionConfig(**{**EXEC, "step_impl": impl})
    return walker.compile(program(walker, kind, max_hops),
                          execution=execution).serve(
        pg, capacity=capacity, chunk=chunk, seed=seed, **kw)


def drive(svc, seed=0):
    """One fixed sequence of submissions and steps: ten requests of 3-30
    walks into a 40-slot ring (the ring wraps and a large request blocks
    the head of the queue), a step after every second submission, one
    step with an explicit ``k``, then a drain.  Returns the completed
    requests."""
    rng = np.random.default_rng(seed)
    for i, n in enumerate((8, 20, 5, 16, 30, 12, 7, 24, 3, 18)):
        svc.submit(rng.integers(0, 512, n).astype(np.int32))
        if i % 2:
            svc.step()
        if i == 5:
            svc.step(k=3)
    return svc.drain()


def assert_requests_equal(got, want):
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for g, w in zip(got, want):
        assert g.num_walks == w.num_walks
        for f in REQ_FIELDS:
            assert np.array_equal(np.asarray(getattr(g, f)),
                                  np.asarray(getattr(w, f))), (g.request_id, f)


def assert_stats_equal(got, want, skip=("launches",)):
    assert got._fields == want._fields
    for f, a, b in zip(got._fields, got, want):
        if f not in skip:
            assert int(a) == int(b), f


def analysis_fields(a, skip=("msteps_per_s",)):
    """Every ServiceAnalysis field but ``skip``, the adaptation trace as
    plain tuples."""
    out = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)
           if f.name not in skip}
    out["adaptation"] = tuple(dataclasses.astuple(e) for e in a.adaptation)
    return out


# ----------------------------------- the reference's service tests, ported


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_service_two_waves(graphs, impl):
    """Two request waves through the legacy constructor (a bare spec and
    an EngineConfig); every walk completes and each tenant harvests
    exactly its own queries, real walks on the graph."""
    _, pg = graphs
    rng = np.random.default_rng(0)
    cfg = EngineConfig(num_slots=64, max_hops=8, step_impl=impl)
    svc = WalkService(pg, SamplerSpec(kind="uniform"), cfg,
                      capacity=512, chunk=4, seed=1)
    assert svc.cfg.step_impl == impl and svc.num_slots == 64
    waves, rids = [], []
    for _ in range(3):
        waves.append(rng.integers(0, pg.num_vertices, 16).astype(np.int32))
        rids.append(svc.submit(waves[-1]))
    svc.step()
    assert svc.num_inflight == 3
    for _ in range(2):
        waves.append(rng.integers(0, pg.num_vertices, 24).astype(np.int32))
        rids.append(svc.submit(waves[-1]))
    done = svc.drain()
    assert len(done) == 5 and svc.num_pending == svc.num_inflight == 0

    seen = set()
    for rid, starts in zip(rids, waves):
        r = svc.poll(rid)
        assert isinstance(r, WalkRequest) and r.done
        assert r.paths.shape == (len(starts), cfg.max_hops + 1)
        assert np.array_equal(r.paths[:, 0], starts)
        assert (r.lengths >= 1).all() and (r.lengths <= cfg.max_hops + 1).all()
        assert r.sojourn >= 1
        assert r.admission_wait >= 0
        assert r.sojourn >= r.admission_wait
        assert r.wall_sojourn >= r.wall_admission_wait >= 0
        ids = {(int(e), int(q)) for e, q in zip(r.epochs, r.qids)}
        assert len(ids) == r.num_walks
        assert not (ids & seen)
        seen |= ids

    rp, col = pg.row_ptr.numpy(), pg.col.numpy()
    r = svc.poll(rids[0])
    for q in range(r.num_walks):
        for t in range(r.lengths[q] - 1):
            u, v = r.paths[q, t], r.paths[q, t + 1]
            assert v in col[rp[u]:rp[u + 1]]


def test_service_ring_reclamation_bounded_buffer(graphs):
    """An unbounded request stream is served with a bounded device buffer
    via ring-buffer slot reclamation: all requests complete and recycled
    slots carry bumped epochs."""
    _, pg = graphs
    rng = np.random.default_rng(0)
    svc = WalkService(pg, SamplerSpec(kind="uniform"),
                      EngineConfig(num_slots=64, max_hops=6),
                      capacity=64, chunk=4, seed=2)
    rids = [svc.submit(rng.integers(0, pg.num_vertices, 32))
            for _ in range(6)]
    done = svc.drain()
    assert len(done) == 6
    assert all(svc.poll(rid).done for rid in rids)
    assert int(svc.walk_stats().terminations) == 6 * 32
    assert max(int(r.epochs.max()) for r in done) >= 2
    by_slot = {}
    for r in done:
        for e, q in zip(r.epochs, r.qids):
            by_slot.setdefault(int(q), []).append(int(e))
    assert any(len(v) > 1 for v in by_slot.values())
    for q, epochs in by_slot.items():
        assert len(set(epochs)) == len(epochs), f"slot {q} epoch reused"


def test_open_load_below_saturation_completes(graphs):
    """Poisson arrivals at moderate utilization: everything completes and
    the sojourn percentiles are finite."""
    _, pg = graphs
    svc = WalkService(pg, SamplerSpec(kind="uniform"),
                      EngineConfig(num_slots=64, max_hops=8),
                      capacity=1024, chunk=4, seed=3)
    a = run_open_load(svc, OpenLoad(num_requests=20, request_size=8,
                                    utilization=0.5), seed=0)
    assert isinstance(a, ServiceAnalysis)
    assert a.requests == 20
    assert a.walks == 20 * 8
    assert a.p50_sojourn <= a.p99_sojourn < float("inf")
    assert a.p50_admission_wait <= a.p99_admission_wait < float("inf")
    assert 0.0 <= a.bubble_ratio <= 1.0


# ------------------------------------------------- against the reference

_REF_DRIVEN = {}


def ref_driven(rg, kind, impl):
    if (kind, impl) not in _REF_DRIVEN:
        svc = ref_service(rg, kind, impl)
        _REF_DRIVEN[kind, impl] = (drive(svc), svc.walk_stats())
    return _REF_DRIVEN[kind, impl]


@pytest.mark.parametrize("kind", KINDS)
def test_service_equals_reference(graphs, kind):
    """The same submissions and steps into the reference's service (jnp)
    and the port's (torch): every request equal in slot ids, epochs,
    paths, lengths and its three superstep clocks; every stat but
    ``launches`` equal."""
    rg, pg = graphs
    want, want_stats = ref_driven(rg, kind, "jnp")
    svc = port_service(pg, kind, "torch")
    got = drive(svc)
    assert len(got) == 10
    assert_requests_equal(got, want)
    assert_stats_equal(svc.walk_stats(), want_stats)
    assert max(int(r.epochs.max()) for r in got) >= 1   # the ring wrapped


def test_fused_service_equals_reference_fused(graphs):
    """The port's fused service (the kernel's plain version) against the
    reference's fused service in interpret mode: equal requests and every
    stat, ``launches`` included; and equal to the jnp service."""
    rg, pg = graphs
    want, want_stats = ref_driven(rg, "uniform", "fused")
    svc = port_service(pg, "uniform", "fused")
    got = drive(svc)
    assert_requests_equal(got, want)
    assert_stats_equal(svc.walk_stats(), want_stats, skip=())
    assert 0 < want_stats.launches < want_stats.supersteps
    assert_requests_equal(got, ref_driven(rg, "uniform", "jnp")[0])


@pytest.mark.parametrize("rho", [0.5, 2.5])
def test_open_load_analysis_equals_reference(graphs, rho):
    """``run_open_load`` below and past saturation: the port's
    ServiceAnalysis equals the reference's in every field but
    ``msteps_per_s`` (wall time)."""
    rg, pg = graphs
    out = []
    for make, load_cls, run in (
            (lambda: ref_service(rg, "uniform", capacity=64, chunk=4),
             RefOpenLoad, ref_run_open_load),
            (lambda: port_service(pg, "uniform", capacity=64, chunk=4),
             OpenLoad, run_open_load)):
        load = load_cls(num_requests=24, request_size=8, utilization=rho)
        out.append(analysis_fields(run(make(), load, seed=1)))
    want, got = out
    assert got == want
    assert got["requests"] == 24 and got["walks"] == 24 * 8
    if rho > 1:
        assert got["p99_admission_wait"] > 0   # overload queues at the host


def test_reset_metrics_reseeds_as_the_reference(graphs):
    """``reset_metrics`` forgets the records and re-seeds the stream with
    ``seed + 1``; the next load point equals the reference's."""
    rg, pg = graphs
    out = []
    for svc, load_cls, run in (
            (ref_service(rg, "alias", capacity=64, chunk=4), RefOpenLoad,
             ref_run_open_load),
            (port_service(pg, "alias", capacity=64, chunk=4), OpenLoad,
             run_open_load)):
        for rho in (0.5, 1.5):
            load = load_cls(num_requests=12, request_size=8, utilization=rho)
            a = analysis_fields(run(svc, load, seed=2))
            reqs = svc.drain()
            out.append((a, reqs, svc.stream.seed))
            svc.reset_metrics()
            assert svc.clock == 0 and svc.poll(0) is None
    for (ga, greqs, gseed), (wa, wreqs, wseed) in zip(out[2:], out[:2]):
        assert ga == wa and gseed == wseed
        assert_requests_equal(greqs, wreqs)
    assert [s for _, _, s in out[2:]] == [3, 4]


@pytest.mark.parametrize("kind", sorted(PROGRAMS))
def test_serve_every_program_under_every_impl(graphs, kind):
    """``compile(program).serve(...)`` returns a WalkService on the graph's
    device for every program under torch, cuda and fused; the three serve
    the same requests, with every stat but ``launches`` equal."""
    _, pg = graphs
    runs = {}
    for impl in ("torch", "cuda", "fused"):
        svc = port_service(pg, kind, impl, capacity=24, chunk=3, seed=2,
                           max_hops=6)
        assert isinstance(svc, WalkService)
        assert svc.stream.state.paths.device == pg.device
        rng = np.random.default_rng(4)
        for n in (10, 14, 9):
            svc.submit(rng.integers(0, 512, n))
        runs[impl] = svc.drain(), svc.walk_stats()
    for impl in ("cuda", "fused"):
        assert_requests_equal(runs[impl][0], runs["torch"][0])
        assert_stats_equal(runs[impl][1], runs["torch"][1])
    assert runs["torch"][1].launches == runs["torch"][1].supersteps


def test_service_errors(graphs):
    _, pg = graphs
    with pytest.raises(ValueError, match="prebuilt stream"):
        WalkService()
    svc = port_service(pg, "uniform", capacity=8)
    with pytest.raises(ValueError, match="empty request"):
        svc.submit([])
    with pytest.raises(ValueError, match="exceeds slot-ring capacity"):
        svc.submit(np.zeros((9,), np.int32))
    with pytest.raises(KeyError):
        svc.result(5)
    rid = svc.submit(np.arange(6))
    svc.submit(np.arange(4))            # blocked behind the first
    with pytest.raises(RuntimeError, match="outstanding"):
        svc.reset_metrics()
    assert svc.result(rid).done and svc.num_pending == 1
    svc.drain()
    assert svc.step() == 0 and svc.num_free_slots == 8


# ------------------------------------------------------ chunk controller


def test_controller_bounds_and_validation():
    c = HopsController(min_chunk=2, max_chunk=32)
    assert c.clamp(1) == 2 and c.clamp(1000) == 32 and c.clamp(8) == 8
    with pytest.raises(ValueError):
        HopsController(min_chunk=0)
    with pytest.raises(ValueError):
        HopsController(low_water=0.5, high_water=0.1)
    with pytest.raises(ValueError):
        HopsController(patience=0)


def test_controller_shrinks_on_starvation():
    c = HopsController(min_chunk=1, max_chunk=64, high_water=0.15)
    chunk, ev = c.propose(32, starved_ratio=0.5, bubble_ratio=0.6)
    assert chunk == 16 and ev.reason == "shrink"
    assert isinstance(ev, AdaptationEvent)
    # at the floor the event degrades to "hold", never below min_chunk
    chunk, ev = c.propose(1, starved_ratio=0.9, bubble_ratio=0.9)
    assert chunk == 1 and ev.reason == "hold"


def test_controller_grows_only_after_patience():
    c = HopsController(min_chunk=1, max_chunk=64, patience=3)
    for _ in range(2):
        chunk, ev = c.propose(8, starved_ratio=0.0, bubble_ratio=0.1)
        assert chunk == 8 and ev is None
    chunk, ev = c.propose(8, starved_ratio=0.0, bubble_ratio=0.1)
    assert chunk == 16 and ev.reason == "grow"
    # a bad window resets the streak
    c.propose(16, starved_ratio=0.5, bubble_ratio=0.5)
    chunk, ev = c.propose(8, starved_ratio=0.0, bubble_ratio=0.0)
    assert chunk == 8 and ev is None


def test_controller_holds_between_watermarks():
    c = HopsController(low_water=0.02, high_water=0.15, patience=1)
    chunk, ev = c.propose(8, starved_ratio=0.08, bubble_ratio=0.3)
    assert chunk == 8 and ev is None


def test_controller_converges_under_synthetic_load():
    """Feedback loop against a synthetic plant where starvation grows with
    the chunk: the controller settles inside its bounds without
    oscillating forever."""
    c = HopsController(min_chunk=1, max_chunk=256, patience=2)
    chunk = 256
    history = []
    for _ in range(64):
        starved = min(0.9, chunk / 64.0 * 0.2)   # plant: starved ~ chunk
        chunk, _ = c.propose(chunk, starved, bubble_ratio=starved)
        history.append(chunk)
    tail = history[-16:]
    assert all(1 <= h <= 256 for h in history)
    assert max(tail) - min(tail) <= max(tail) // 2 + 1  # bounded cycle
    assert max(tail) <= 64    # settled well below the starved regime


def test_controllers_agree_on_a_seeded_sequence():
    """Both packages' controllers fed one seeded sequence of (chunk,
    starved, bubble, clock) windows, crossing both watermarks and the
    bounds, give identical (chunk, event) streams."""
    rng = np.random.default_rng(7)
    kw = dict(min_chunk=2, max_chunk=64, low_water=0.02, high_water=0.15,
              patience=2)
    ctrls = (RefHopsController(**kw), HopsController(**kw))
    streams = ([], [])
    chunks = [16, 16]
    for clock in range(400):
        starved = float(rng.choice([0.0, 0.01, 0.05, 0.1, 0.2, 0.6]))
        starved *= float(rng.random()) if clock % 3 else 1.0
        bubble = float(rng.random())
        jump = int(rng.integers(0, 300)) if clock % 37 == 0 else None
        for i, c in enumerate(ctrls):
            chunk = chunks[i] if jump is None else jump
            chunks[i], ev = c.propose(chunk, starved, bubble, clock=clock)
            streams[i].append((chunks[i], None if ev is None
                               else dataclasses.astuple(ev)))
    assert streams[0] == streams[1]
    reasons = {ev[-1] for _, ev in streams[1] if ev is not None}
    assert reasons == {"shrink", "grow", "hold"}


def test_service_adaptation_trace(graphs):
    """An overloaded service grows its chunk; the trace lands in
    analyze() and equals the reference's, event for event."""
    rg, pg = graphs
    out = []
    for pkg, ctrl, g in ((ref_walker, RefHopsController, rg),
                         (walker, HopsController, pg)):
        w = pkg.compile(pkg.WalkProgram.urw(12),
                        execution=pkg.ExecutionConfig(num_slots=64))
        svc = w.serve(g, seed=0, chunk=2, adapt=True,
                      controller=ctrl(min_chunk=1, max_chunk=32, patience=2))
        rng = np.random.default_rng(0)
        for _ in range(30):
            svc.submit(rng.integers(0, g.num_vertices,
                                    size=64).astype(np.int32))
            svc.step()
        reqs = svc.drain()
        out.append((svc, reqs))
    (ref_svc, ref_reqs), (svc, reqs) = out
    events = svc.analyze().adaptation
    assert events, "overload produced no adaptation events"
    assert any(e.reason == "grow" for e in events)
    assert all(1 <= e.chunk_after <= 32 for e in events)
    assert svc.chunk <= 32
    assert events == svc.adaptation
    assert ([dataclasses.astuple(e) for e in events]
            == [dataclasses.astuple(e) for e in ref_svc.adaptation])
    assert svc.chunk == ref_svc.chunk
    assert_requests_equal(reqs, ref_reqs)


def test_service_fixed_without_adapt(graphs):
    _, pg = graphs
    w = walker.compile(walker.WalkProgram.urw(8),
                       execution=walker.ExecutionConfig(num_slots=64))
    svc = w.serve(pg, seed=0, chunk=4)
    svc.submit(np.arange(16, dtype=np.int32))
    svc.drain()
    assert svc.chunk == 4
    assert svc.analyze().adaptation == ()


# -------------------------------------------------- legacy injection shim


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_legacy_inject_shim_warns_and_matches(graphs, impl):
    """The pre-ring ``inject_queries(state, starts, n_valid)`` form warns
    and appends at sequential slots from ``tail`` with epoch 0, also
    mid-stream and on a fused stream's packed state (``tail`` read
    through the control block): the drained paths equal the reference's
    and the port's closed batches.  A slot past the capacity raises."""
    rg, pg = graphs
    starts = np.random.default_rng(6).integers(0, 512, 40).astype(np.int32)
    want = ref_run_walks(rg, starts, RefSpec(kind="uniform"),
                         RefConfig(num_slots=16, max_hops=10), seed=6)
    closed = _run_walks(pg, starts, SamplerSpec(kind="uniform"),
                        EngineConfig(num_slots=16, max_hops=10), seed=6)
    cfg = EngineConfig(num_slots=16, max_hops=10, step_impl=impl,
                       hops_per_launch=4)
    run = make_superstep_runner(SamplerSpec(kind="uniform"), cfg)
    state, block = init_stream_state(cfg, 40, pg.device), None
    if impl == "fused":
        state, block = fused_ops.pack(state)
    key = stream_key(6)
    with pytest.deprecated_call():
        state = inject_queries(state, starts[:25], 25)
    state = run(pg, state, key, 3, block).state
    padded = np.concatenate([starts[25:], np.full((9,), 7, np.int32)])
    with pytest.deprecated_call():
        state = inject_queries(state, torch.from_numpy(padded), 15)
    assert int(state.queue.tail) == 40
    for _ in range(100):
        if bool(state.done.all()):
            break
        state = run(pg, state, key, 5, block).state
    assert np.array_equal(state.paths.numpy(), np.asarray(want.paths))
    assert np.array_equal(state.lengths.numpy(), np.asarray(want.lengths))
    assert torch.equal(state.paths, closed.paths)
    assert int(state.stats.terminations) == 40
    with pytest.deprecated_call(), pytest.raises(ValueError,
                                                 match="slot ids"):
        inject_queries(state, [0], 1)     # slot 40 of a 40-slot ring
    assert int(state.queue.tail) == 40


# --------------------------------------------------------------------- CLI


def test_walk_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.walk_serve", "--device",
         "cpu", "--scale", "9", "--slots", "64", "--max-hops", "12",
         "--requests", "24", "--request-size", "8", "--capacity", "512",
         "--step-impl", "fused", "--hops-per-launch", "4"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    lines = out.stdout.splitlines()
    assert len(lines) == 5
    assert "sojourn supersteps: p50=" in out.stdout
    assert "requests=24 walks=192" in out.stdout and "drops=0" in out.stdout
    assert "MStep/s" in lines[-1]
