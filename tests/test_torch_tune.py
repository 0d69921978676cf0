"""Autotuner parity: ``repro_torch.tune`` against ``repro.tune`` on the same
graphs, then the port's own tuning pipeline on the CPU.

The graphs are built from the same seeds by each package (the WG stand-in
at scale 9: plain, weighted with alias tables, and typed).  Signatures,
buckets, candidate grids, the reservoir gate, the hit-rate model and the
three feature columns that do not depend on the byte count are held equal
to the reference exactly; the least-squares fit within 1e-12 relative
(the same numpy solve on the same rows).  The byte count is the port's own
(the fused CUDA kernel's loads) and is pinned to its numbers here.
Measurement runs use the injected measurer, never a clock, so everything
below is deterministic.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro import tune as ref_tune
from repro import walker as ref_walker
from repro.graph import make_dataset as ref_make_dataset
from repro_torch import tune, walker
from repro_torch.core.samplers import bisect_iters, es_num_chunks
from repro_torch.graph import make_dataset
from repro_torch.tune import model as port_model
from repro_torch.tune.tuner import _key
from repro_torch.walker import ExecutionConfig, WalkProgram

REPO = pathlib.Path(__file__).resolve().parents[1]
#: The port's step impls and the reference's counterparts.
IMPLS = {"torch": "jnp", "cuda": "pallas", "fused": "fused"}
GRAPHS = {"small": {}, "weighted": dict(weighted=True, with_alias=True),
          "typed": dict(num_edge_types=3)}
PROGRAMS = {
    "urw": lambda pkg: pkg.WalkProgram.urw(12),
    "ppr": lambda pkg: pkg.WalkProgram.ppr(0.15, 12),
    "deepwalk": lambda pkg: pkg.WalkProgram.deepwalk(12),
    "metapath": lambda pkg: pkg.WalkProgram.metapath([0, 1, 2], 12),
    "node2vec": lambda pkg: pkg.WalkProgram.node2vec(2.0, 0.5, 12),
    "node2vec_w": lambda pkg: pkg.WalkProgram.node2vec(2.0, 0.5, 12,
                                                       weighted=True),
}


@pytest.fixture(scope="module")
def graphs():
    """name -> (reference graph, port graph on the CPU), same seeds."""
    return {name: (ref_make_dataset("WG", scale_override=9, **kw),
                   make_dataset("WG", scale_override=9, device="cpu", **kw))
            for name, kw in GRAPHS.items()}


@pytest.fixture(scope="module")
def sigs(graphs):
    return {name: tune.graph_signature(pg) for name, (_, pg) in graphs.items()}


def pair(name, impl="torch", **kw):
    """(reference program, execution), (port program, execution)."""
    ref = (PROGRAMS[name](ref_walker),
           ref_walker.ExecutionConfig(step_impl=IMPLS[impl], **kw))
    port = (PROGRAMS[name](walker), ExecutionConfig(step_impl=impl, **kw))
    return ref, port


# ------------------------------------------------------ against the reference


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_signature_equal(graphs, name):
    rg, pg = graphs[name]
    want, got = ref_tune.graph_signature(rg), tune.graph_signature(pg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.token() == want.token()


def test_workload_bucket_equal():
    for n in (None, 0, -3, 1, 63, 64, 65, 1000, 65_536, 70_000):
        assert tune.workload_bucket(n) == ref_tune.workload_bucket(n)


def test_candidate_apply_and_validity():
    (rp, rex), (pp, pex) = pair("urw", record_paths=False)
    cands = [tune.Candidate.of(num_slots=64, queue_depth_factor=2.0),
             tune.Candidate.of(num_slots=-1), tune.Candidate.of(bogus_knob=1),
             tune.Candidate.of(queue_depth_factor=0.0),
             tune.Candidate.of(num_slots=32, cache_budget=1 << 14)]
    for cand in cands:
        ref_cand = ref_tune.Candidate(cand.items)
        try:
            want = ref_cand.apply(rp, rex)
        except ValueError:
            with pytest.raises(ValueError):
                cand.apply(pp, pex)
            continue
        prog, ex = cand.apply(pp, pex)
        assert prog is pp
        for f in dataclasses.fields(ex):
            if f.name != "step_impl":
                assert getattr(ex, f.name) == getattr(want[1], f.name), f.name


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("resampling", [False, True])
def test_knobs_and_candidates_equal(name, impl, resampling):
    (rp, rex), (pp, pex) = pair(name, impl, record_paths=False)
    assert tune.knobs_for(pp, pex) == tuple(
        tune.Knob(**dataclasses.asdict(k)) for k in ref_tune.knobs_for(rp, rex))
    got = tune.enumerate_candidates(pp, pex, include_resampling=resampling)
    want = ref_tune.enumerate_candidates(rp, rex,
                                         include_resampling=resampling)
    assert [c.items for c in got] == [c.items for c in want]
    knobs = tune.knobs_for(pp, pex)
    assert (tune.default_candidate(pp, pex, knobs).items
            == ref_tune.default_candidate(rp, rex,
                                          ref_tune.knobs_for(rp, rex)).items)


def test_knobs_for_defaults_to_the_torch_step():
    prog = WalkProgram.urw(8)
    assert (tune.knobs_for(prog, object())
            == tune.knobs_for(prog, ExecutionConfig(step_impl="torch")))


@pytest.mark.parametrize("graph", ["small", "weighted"])
def test_gate_live_degree_and_walk_length_equal(graphs, sigs, graph):
    rsig = ref_tune.graph_signature(graphs[graph][0])
    sig = sigs[graph]
    for w in (1, 2, 32, 64, 1024, 4096, 65_536):
        assert tune.live_max_degree(sig, w) == ref_tune.live_max_degree(
            rsig, w)
        for ch in (4, 16, 64, 256):
            for margin in (0.5, 0.75, 1.0):
                assert (tune.adaptive_chunk_gate(sig, w, ch, margin)
                        == ref_tune.adaptive_chunk_gate(rsig, w, ch, margin))
    for name in PROGRAMS:
        (rp, _), (pp, _) = pair(name)
        assert tune.expected_walk_len(pp) == ref_tune.expected_walk_len(rp)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_predicted_hit_rate_equal(graphs, sigs, name):
    from repro.tune import model as ref_model
    graph = {"metapath": "typed"}.get(name, "weighted")
    rsig = ref_tune.graph_signature(graphs[graph][0])
    (rp, _), (pp, _) = pair(name)
    payloads = port_model._spec_payloads(pp.spec)
    assert payloads == ref_model._spec_payloads(rp.spec)
    for budget in (0, 1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 22):
        assert (port_model.predicted_hit_rate(sigs[graph], budget, payloads)
                == ref_model.predicted_hit_rate(rsig, budget, payloads))


def test_fit_equal():
    rng = np.random.default_rng(0)
    rows = [np.array([10.0, 100.0, 1000.0, 1.0]),
            np.array([20.0, 400.0, 2000.0, 1.0]),
            np.array([5.0, 50.0, 5000.0, 2.0]),
            np.array([40.0, 200.0, 1500.0, 4.0]),
            np.array([15.0, 300.0, 2500.0, 1.0])]
    cases = [(rows, [float(r @ np.array([10.0, 0.5, 0.01, 100.0]))
                     for r in rows]),
             (rows, list(rng.random(5) * 1e3)),   # clipped coefficients
             (rows[:1], [7.0]),                    # underdetermined: rescale
             (rows[:3], [1.0, 2.0, 3.0])]
    # The same base: the port's DEFAULT_COEFFS are the card's, not the
    # reference's, and an underdetermined fit rescales the base.
    base = tune.CostCoeffs(*ref_tune.DEFAULT_COEFFS.as_array().tolist())
    for x, y in cases:
        got = tune.fit(x, y, base=base).as_array()
        want = ref_tune.fit(x, y).as_array()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        tune.fit([], [])


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_features_equal_but_bytes_and_launches(graphs, sigs, name, impl):
    graph = {"metapath": "typed"}.get(name, "weighted")
    rsig = ref_tune.graph_signature(graphs[graph][0])
    (rp, rex), (pp, pex) = pair(name, impl, record_paths=False)
    cands = tune.enumerate_candidates(pp, pex)
    for nq in (100, 4_096):
        for cand in cands:
            prog, ex = cand.apply(pp, pex)
            got = port_model.features(prog, ex, sigs[graph], nq)
            want = ref_tune.model.features(
                *ref_tune.Candidate(cand.items).apply(rp, rex), rsig, nq)
            s, w = got[0], ex.num_slots
            assert got[0] == want[0] and got[1] == want[1] == s * w
            if impl == "fused":
                assert got[3] == want[3]
            else:
                assert got[3] == s        # one host round a superstep
            if impl != "fused" or ex.cache_budget == 0:
                adaptive = prog.spec.adaptive_chunks
                if adaptive == "auto":
                    adaptive = tune.adaptive_chunk_gate(
                        sigs[graph], w, prog.spec.reservoir_chunk)
                trips = port_model._reservoir_trips(prog.spec, sigs[graph],
                                                    w, adaptive)
                assert got[2] == s * w * tune.bytes_per_hop(
                    prog.spec, sigs[graph], chunk_trips=trips)


@pytest.mark.parametrize("paths", [False, True])
def test_bytes_per_hop_is_the_kernels_loads(sigs, paths):
    """12 / 20 / 24 bytes a hop for the first-order kinds (row-pointer pair
    and column; + prob and alias; + schedule entry and typed pair), as
    chip_smoke.py's launch bound counts them, + 8 for the path record and
    length; the Node2Vec kinds by rounds, bisection steps and chunks."""
    sig = sigs["weighted"]
    rec = 8.0 if paths else 0.0
    b = bisect_iters(sig.max_degree)
    member = 4.0 * (b + 1)

    def bph(name, **kw):
        return tune.bytes_per_hop(PROGRAMS[name](walker).spec, sig,
                                  record_paths=paths, **kw)
    for name, want, hit in (("urw", 12, 0), ("ppr", 12, 0),
                            ("deepwalk", 20, 0), ("metapath", 24, 4)):
        assert bph(name) == want + rec
        assert bph(name, cached=True) == hit + rec
    K = WalkProgram.node2vec(2.0, 0.5).spec.rejection_rounds
    assert bph("node2vec") == 16 + K * (4 + member) + rec
    assert bph("node2vec", cached=True) == 8 + K * member + rec
    CH = WalkProgram.node2vec(2.0, 0.5, weighted=True).spec.reservoir_chunk
    trips = es_num_chunks(sig.max_degree, CH)
    assert bph("node2vec_w") == 20 + trips * CH * (8 + member) + rec
    assert bph("node2vec_w", chunk_trips=1) == 20 + CH * (8 + member) + rec
    assert bph("node2vec_w", cached=True) == 8 + trips * CH * member + rec


#: Bytes a hop a lane on WG scale 9 (weighted, alias tables; typed for
#: MetaPath), without path records: (uncached, cached) as the port counts
#: the fused CUDA kernel's loads, beside the reference's count off its
#: Pallas DMA schedule.  PERF.md's table of bytes a hop comes from here.
BYTES_TABLE = {"urw": ((12, 0), (12, 0)), "ppr": ((12, 0), (12, 0)),
               "deepwalk": ((20, 0), (20, 0)),
               "metapath": ((24, 4), (20, 0)),
               "node2vec": ((448, 392), (448, 392)),
               "node2vec_w": ((5140, 4104), (1172, 136))}


@pytest.mark.parametrize("name", sorted(BYTES_TABLE))
def test_bytes_per_hop_table(graphs, sigs, name):
    graph = {"metapath": "typed"}.get(name, "weighted")
    rsig = ref_tune.graph_signature(graphs[graph][0])
    (rp, _), (pp, _) = pair(name)
    port, ref = BYTES_TABLE[name]
    assert tuple(tune.bytes_per_hop(pp.spec, sigs[graph], cached=c)
                 for c in (False, True)) == port
    assert tuple(ref_tune.bytes_per_hop(rp.spec, rsig, cached=c)
                 for c in (False, True)) == ref


def test_cache_files_load_in_both_packages(tmp_path, graphs, sigs):
    rsig = ref_tune.graph_signature(graphs["small"][0])
    pg = graphs["small"][1]
    prog, ex = WalkProgram.urw(8), ExecutionConfig(step_impl="fused")
    key = _key(pg, sigs["small"], prog, ex, "single", 200)
    # The key keeps the reference's shape; the device field is the graph's.
    assert key == ref_tune.cache_key(rsig, "uniform", "single", "fused",
                                     "cpu", False, 200)
    assert "|cpu|interp0|q256|" in key
    records = {key: ({"num_slots": 128, "hops_per_launch": 32},
                     {"source": "measured"}),
               "other": ({"queue_depth_factor": 0.5}, {})}
    for writer, reader in ((tune, ref_tune), (ref_tune, tune)):
        path = str(tmp_path / f"{writer.__name__}.json")
        cache = writer.TuningCache(path)
        for k, (knobs, meta) in records.items():
            cache.put(k, knobs, meta=meta)
        assert cache.save() == path
        assert json.load(open(path))["version"] == 1
        loaded = reader.TuningCache(path)
        assert len(loaded) == len(records)
        for k, (knobs, meta) in records.items():
            assert loaded.get(k) == {"knobs": knobs, "meta": meta}


def test_cache_tolerates_corrupt_file(tmp_path):
    path = tmp_path / "broken.json"
    path.write_text("{not json")
    assert len(tune.TuningCache(str(path))) == 0
    path.write_text(json.dumps({"version": 999, "entries": {"k": {}}}))
    assert len(tune.TuningCache(str(path))) == 0


def test_default_cache_path_reads_the_environment(monkeypatch):
    monkeypatch.setenv("RIDGEWALKER_TUNE_CACHE", " /x/tc.json ")
    assert tune.default_cache_path() == "/x/tc.json"
    monkeypatch.setenv("RIDGEWALKER_TUNE_CACHE", "")
    assert tune.default_cache_path() is None


# ------------------------------------------------------------ the tuner


def test_autotune_injected_measurer_is_deterministic(graphs):
    pg = graphs["small"][1]
    prog, ex = WalkProgram.urw(8), ExecutionConfig(record_paths=False)

    def cost(c):  # prefer small lane pools, mildly penalize deep queues
        return float(c.get("num_slots")) + 10.0 * float(
            c.get("queue_depth_factor"))

    results = []
    for _ in range(2):
        meas = tune.InjectedMeasurer(cost)
        res = tune.autotune(pg, prog, ex, num_queries=128, measurer=meas,
                            cache=tune.TuningCache(None), keep=4)
        assert res.source == "measured" and meas.calls == 2
        results.append(res.candidate)
    assert results[0] == results[1]
    assert results[0].get("num_slots") == 32
    assert results[0].get("queue_depth_factor") == 0.5


def test_autotune_min_gain_keeps_default(graphs):
    pg = graphs["small"][1]
    prog, ex = WalkProgram.urw(8), ExecutionConfig(record_paths=False)
    default = tune.default_candidate(prog, ex, tune.knobs_for(prog, ex))
    res = tune.autotune(pg, prog, ex, num_queries=128,
                        measurer=tune.InjectedMeasurer(
                            lambda c: 0.99 if c != default else 1.0),
                        cache=tune.TuningCache(None), min_gain=0.02)
    assert res.candidate == default


def test_autotune_writes_and_reuses_cache(graphs, tmp_path):
    pg = graphs["small"][1]
    prog = WalkProgram.urw(8)
    ex = ExecutionConfig(record_paths=False, step_impl="fused")
    cache = tune.TuningCache(str(tmp_path / "tc.json"))
    res = tune.autotune(pg, prog, ex, num_queries=128,
                        measurer=tune.InjectedMeasurer(
                            lambda c: float(c.get("hops_per_launch"))),
                        cache=cache, keep=3)
    assert len(cache) == 1 and res.candidate.get("hops_per_launch") == 2
    assert res.coeffs is not None and set(res.measured) >= {
        tune.default_candidate(prog, ex, tune.knobs_for(prog, ex))}
    again = tune.autotune(pg, prog, ex, num_queries=128,
                          measurer=tune.InjectedMeasurer(lambda c: 0.0),
                          cache=tune.TuningCache(str(tmp_path / "tc.json")),
                          keep=3)
    assert again.source == "cache" and again.candidate == res.candidate


def test_model_only_autotune(graphs):
    pg = graphs["small"][1]
    res = tune.autotune(pg, WalkProgram.urw(8),
                        ExecutionConfig(record_paths=False), num_queries=128,
                        measurer=None, cache=tune.TuningCache(None))
    assert res.source == "model" and not res.measured
    assert not res.execution.has_auto
    assert res.key.startswith("uniform|single|torch|cpu|interp0|q128|")


def test_measured_autotune_times_runs_on_the_graph(graphs):
    """WalkMeasurer times real runs (one repeat each) and picks a grid
    point; the chosen config is concrete."""
    pg = graphs["small"][1]
    res = tune.autotune(pg, WalkProgram.urw(6),
                        ExecutionConfig(record_paths=False, step_impl="fused"),
                        num_queries=64,
                        measurer=tune.WalkMeasurer(repeats=1, warmup=0),
                        cache=tune.TuningCache(None), keep=2)
    assert res.source == "measured" and len(res.measured) >= 3
    assert all(t > 0 for t in res.measured.values())
    with pytest.raises(ValueError):
        tune.WalkMeasurer(repeats=0)


def test_execution_config_auto_validation():
    ex = ExecutionConfig(num_slots="auto", hops_per_launch="auto")
    assert ex.has_auto
    assert ex.auto_knobs == ("num_slots", "hops_per_launch")
    with pytest.raises(ValueError):
        ExecutionConfig(num_slots="turbo")
    with pytest.raises(ValueError):
        ExecutionConfig(cache_budget="big")
    with pytest.raises(ValueError, match="auto"):
        ex.engine_config(WalkProgram.urw(8))
    r = ex.resolved(num_slots=64)
    assert r.num_slots == 64 and r.hops_per_launch == 16 and not r.has_auto
    assert ExecutionConfig().resolved() == ExecutionConfig()
    with pytest.raises(ValueError):
        ex.resolved(record_paths=False)   # not a tunable knob


def test_resolve_uses_cached_entry(graphs, tmp_path):
    pg = graphs["small"][1]
    path = str(tmp_path / "cache.json")
    prog = WalkProgram.urw(8)
    ex = ExecutionConfig(num_slots="auto", tune_cache=path)
    key = _key(pg, tune.graph_signature(pg), prog, ex, "single", 64)
    cache = tune.TuningCache(path)
    cache.put(key, {"num_slots": 96}, meta={"source": "test"})
    cache.save()
    _, ex2 = tune.resolve(prog, ex, pg, num_queries=64)
    assert ex2.num_slots == 96
    # The environment variable feeds the same lookup.
    ex_env = ExecutionConfig(num_slots="auto")
    os.environ["RIDGEWALKER_TUNE_CACHE"] = path
    try:
        _, ex3 = tune.resolve(prog, ex_env, pg, num_queries=64)
    finally:
        del os.environ["RIDGEWALKER_TUNE_CACHE"]
    assert ex3.num_slots == 96


def test_reservoir_auto_gate_resolution(graphs, sigs):
    pg = graphs["weighted"][1]
    prog = WalkProgram.node2vec(2.0, 0.5, 8, weighted=True)
    ex = ExecutionConfig(num_slots=32, record_paths=False)
    assert tune.needs_resolution(prog, ex)    # adaptive_chunks == "auto"
    prog2, ex2 = tune.resolve(prog, ex, pg, cache=tune.TuningCache(None))
    assert ex2 is ex
    assert prog2.spec.adaptive_chunks == tune.adaptive_chunk_gate(
        sigs["weighted"], 32, prog.spec.reservoir_chunk)
    rprog2, _ = ref_tune.resolve(
        PROGRAMS["node2vec_w"](ref_walker),
        ref_walker.ExecutionConfig(num_slots=32, record_paths=False),
        graphs["weighted"][0], cache=ref_tune.TuningCache(None))
    assert prog2.spec.adaptive_chunks == rprog2.spec.adaptive_chunks


def test_resolve_reads_no_clock(graphs, monkeypatch):
    def clock():
        raise AssertionError("resolve read a clock")
    for name in ("perf_counter", "perf_counter_ns", "time", "monotonic"):
        monkeypatch.setattr(time, name, clock)
    pg = graphs["weighted"][1]
    for prog in (WalkProgram.urw(8),
                 WalkProgram.node2vec(2.0, 0.5, 8, weighted=True)):
        ex = ExecutionConfig(num_slots="auto", queue_depth_factor="auto",
                             hops_per_launch="auto", cache_budget="auto",
                             step_impl="fused")
        prog2, ex2 = tune.resolve(prog, ex, pg, num_queries=300,
                                  cache=tune.TuningCache(None))
        assert not ex2.has_auto and not tune.needs_resolution(prog2, ex2)


@pytest.mark.parametrize("name,impl,graph", [
    ("urw", "torch", "small"), ("urw", "fused", "small"),
    ("node2vec_w", "torch", "weighted"), ("node2vec_w", "fused", "weighted")])
def test_auto_resolution_preserves_paths(graphs, name, impl, graph, monkeypatch):
    """A Walker with every tunable knob on "auto" resolves once per graph
    and workload and samples the reference's paths for the same seed."""
    rg, pg = graphs[graph]
    starts = np.arange(100, dtype=np.int32) * 5 % pg.num_vertices
    want = ref_walker.compile(
        PROGRAMS[name](ref_walker),
        execution=ref_walker.ExecutionConfig(num_slots=64)).run(
        rg, starts, seed=3)
    auto = dict(num_slots="auto", queue_depth_factor="auto")
    if impl == "fused":
        auto.update(hops_per_launch="auto", cache_budget="auto")
    calls = []
    resolve = tune.resolve
    monkeypatch.setattr(tune, "resolve",
                        lambda *a, **k: calls.append(k) or resolve(*a, **k))
    w = walker.compile(PROGRAMS[name](walker),
                       execution=ExecutionConfig(step_impl=impl, **auto))
    for _ in range(2):
        got = w.run(pg, starts, seed=3)
        assert np.array_equal(got.paths.numpy(), np.asarray(want.paths))
        assert np.array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert [k["num_queries"] for k in calls] == [100]     # memoized
    (program, execution), = w._resolved.values()
    assert not tune.needs_resolution(program, execution)


def test_stream_and_embeddings_bind_resolved(graphs, monkeypatch):
    """``stream`` (so ``serve``) binds with its capacity, and
    ``train_embeddings`` with ``walks_per_round``; both run the resolved
    config and give the fixed config's results."""
    pg = graphs["weighted"][1]
    calls = []
    resolve = tune.resolve
    monkeypatch.setattr(tune, "resolve",
                        lambda *a, **k: calls.append(k) or resolve(*a, **k))
    auto = ExecutionConfig(num_slots="auto", hops_per_launch="auto",
                           step_impl="fused")
    w = walker.compile(WalkProgram.deepwalk(6), execution=auto)
    stream = w.stream(pg, capacity=48)
    _, ex = resolve(WalkProgram.deepwalk(6), auto, pg, num_queries=48,
                    cache=tune.TuningCache(None))
    assert stream.num_slots == ex.num_slots
    assert stream.cfg.hops_per_launch == ex.hops_per_launch
    assert w.serve(pg, capacity=48).stream.num_slots == ex.num_slots
    kw = dict(rounds=1, walks_per_round=100, steps_per_round=2,
              batch_size=8, dim=4)
    got = w.train_embeddings(pg, **kw)
    want = walker.compile(WalkProgram.deepwalk(6), execution=ExecutionConfig(
        step_impl="fused")).train_embeddings(pg, **kw)
    assert torch.equal(got["ring"].paths, want["ring"].paths)
    # One resolution a workload bucket: 48 (the stream, then the service
    # from the memo), 100 (the producer).
    assert [k["num_queries"] for k in calls] == [48, 100]


def test_cli_model_only_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("RIDGEWALKER_TUNE_CACHE", None)
    path = tmp_path / "tc.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--no-measure",
         "--device", "cpu", "--scale", "9", "--queries", "192",
         "--max-hops", "12", "--step-impls", "torch,fused",
         "--cache", str(path)],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    assert "uniform/fused [model]" in out.stdout
    assert "model-only tuning cache: 4 entries" in out.stdout
    entries = json.loads(path.read_text())["entries"]
    assert all("|cpu|interp0|q256|" in k for k in entries)
    if not torch.cuda.is_available():
        # The default device is the card; without one the builder raises.
        bad = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune", "--no-measure",
             "--scale", "6", "--cache", str(tmp_path / "x.json")],
            env=env, capture_output=True, text=True, timeout=300)
        assert bad.returncode != 0 and "CUDA" in bad.stderr
