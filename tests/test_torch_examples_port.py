"""The port's counterparts of the reference's examples
(``examples/torch_*.py``), run in process on the CPU at a tiny size; the
walk examples' printed integers (steps, supersteps, lengths, the first
walk, each request's walks) held against the reference's walker API run
in process at the same size, and one example run as a script.

Walks are compared bit for bit: paths depend only on (seed, query,
hop), so the reference's ``jnp`` superstep gives the port's walks under
any step implementation and backend.
"""
import os
import pathlib
import runpy
import subprocess
import sys

import numpy as np
import pytest

from repro import walker as ref_walker
from repro.core.scheduler import analyze_run as ref_analyze
from repro.graph import build_csr as ref_build_csr
from repro.graph import make_dataset as ref_make_dataset
from repro.graph.generators import GRAPH500 as REF_GRAPH500
from repro.graph.generators import rmat_edges as ref_rmat_edges

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


def example(name):
    return runpy.run_path(str(EXAMPLES / f"torch_{name}.py"))["main"]


def assert_walks_equal(port_paths, port_lengths, ref_res):
    rp, rl = ref_res.as_numpy()
    np.testing.assert_array_equal(port_lengths, rl)
    np.testing.assert_array_equal(port_paths, rp)


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_quickstart_equals_the_reference(impl, capsys):
    out = example("quickstart")(
        ["--device", "cpu", "--scale", "8", "--queries", "64",
         "--max-hops", "8", "--slots", "32", "--step-impl", impl,
         "--hops-per-launch", "4"])
    printed = capsys.readouterr().out
    g = ref_make_dataset("WG", scale_override=8, weighted=True,
                         with_alias=True, num_edge_types=3)
    starts = np.random.default_rng(0).integers(0, g.num_vertices, 64)
    programs = {
        "URW": ref_walker.WalkProgram.urw(8),
        "PPR(α=.15)": ref_walker.WalkProgram.ppr(0.15, 8),
        "DeepWalk": ref_walker.WalkProgram.deepwalk(8),
        "Node2Vec(2,.5)": ref_walker.WalkProgram.node2vec(2.0, 0.5, 8),
        "MetaPath[0,1,2]": ref_walker.WalkProgram.metapath([0, 1, 2], 8)}
    assert list(out) == list(programs)
    for name, program in programs.items():
        ref = ref_walker.compile(
            program, execution=ref_walker.ExecutionConfig(num_slots=32)).run(
                g, starts)
        a, paths, lengths = out[name]
        want = ref_analyze(ref.stats)
        assert (a.steps, a.supersteps) == (want.steps, want.supersteps), name
        assert_walks_equal(paths, lengths, ref)
        assert (f"{name:16s} steps={want.steps:7d} "
                f"supersteps={want.supersteps:5d}") in printed
    assert a.launches == (-(-a.supersteps // 4) if impl == "fused"
                          else a.supersteps)
    first = paths[0][: lengths[0]]
    assert f"first MetaPath walk: {first}" in printed
    assert ("kernel launches: walk_step_uniform=0 walk_step_alias=0 "
            "fused_superstep=0") in printed


def test_serve_walk_requests_equals_the_reference(capsys):
    out = example("serve_walk_requests")(["--device", "cpu", "--scale", "8"])
    printed = capsys.readouterr().out
    g = ref_make_dataset("WG", scale_override=8)
    svc = ref_walker.compile(
        ref_walker.WalkProgram.urw(20),
        execution=ref_walker.ExecutionConfig(num_slots=256)).serve(
            g, capacity=4096, chunk=4, seed=0)
    rng = np.random.default_rng(0)
    a = [svc.submit(rng.integers(0, g.num_vertices, 32)) for _ in range(3)]
    svc.step()
    b = [svc.submit(rng.integers(0, g.num_vertices, 64)) for _ in range(2)]
    svc.drain()
    for got, rid in zip(out["a"] + out["b"], a + b):
        want = svc.poll(rid)
        assert got.request_id == rid and got.num_walks == want.num_walks
        for f in ("qids", "epochs", "lengths", "paths"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), err_msg=f)
        assert (got.admission_wait, got.sojourn) == (want.admission_wait,
                                                     want.sojourn)
    want = svc.analyze()
    got = out["analysis"]
    assert (got.walks, got.supersteps) == (want.walks, want.supersteps)
    assert "tenant B request 4: 64 walks" in printed
    r = svc.poll(b[0])
    assert (f"first walk of tenant B's first request: "
            f"{r.paths[0][: r.lengths[0]]}") in printed


def test_distributed_walks_equal_the_reference(capsys):
    out = example("distributed_walks")(
        ["--device", "cpu", "--scale", "8", "--queries", "128",
         "--max-hops", "8", "--step-impl", "fused"])
    printed = capsys.readouterr().out
    assert out["identical"]
    assert "bit-identical to single-device engine: True" in printed
    assert "drops=0 (must be 0)" in printed
    g = ref_make_dataset("CP", scale_override=8)
    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, 128).astype(np.int32)
    ref = ref_walker.compile(
        ref_walker.WalkProgram.urw(8),
        execution=ref_walker.ExecutionConfig(num_slots=512)).run(
            g, starts, seed=0)
    steps = int(ref.stats.steps)
    assert f"distributed: {steps} steps in" in printed
    assert int(out["sharded"].stats.steps) == steps
    assert_walks_equal(*out["sharded"].as_numpy(), ref)


def test_cached_superstep_smoke_equals_the_reference(capsys):
    off, on = example("cached_superstep_smoke")(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "OK" in printed and "kernel launches: fused_superstep=0" in printed
    edges, n = ref_rmat_edges(8, 8, REF_GRAPH500, seed=2)
    g = ref_build_csr(edges, n)
    starts = np.random.default_rng(7).integers(0, n, 96)
    ref = ref_walker.compile(
        ref_walker.WalkProgram.urw(10),
        execution=ref_walker.ExecutionConfig(num_slots=64)).run(
            g, starts, seed=0)
    for res in (off, on):
        assert int(res.stats.steps) == int(ref.stats.steps)
        assert int(res.stats.supersteps) == int(ref.stats.supersteps)
        assert_walks_equal(*res.as_numpy(), ref)
    assert f"hits={int(on.stats.cache_hits)} " in printed


def test_gnn_neighbor_sampling_trains(capsys):
    out = example("gnn_neighbor_sampling")(
        ["--device", "cpu", "--scale", "8", "--iters", "11", "--batch", "32"])
    printed = capsys.readouterr().out
    assert len(out["losses"]) == 11 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert "iter  10 sampled_nodes=" in printed and "done" in printed
    assert "kernel launches: embedding_bag=0 segment_sum=0" in printed


def test_serve_continuous_batching_serves_every_request(capsys):
    results, stats = example("serve_continuous_batching")(
        ["--device", "cpu", "--requests", "8"])
    printed = capsys.readouterr().out
    assert stats.completed == len(results) == 8
    assert all(len(r) == 13 for r in results)    # the prefill's + 12 new
    assert "served 8 requests in" in printed
    assert f"sample generation: {results[0]}" in printed
    assert "kernel launches: embedding_bag=0" in printed


def test_an_example_runs_as_a_script():
    r = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_cached_superstep_smoke.py"),
         "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "cache-off == cache-on: paths/lengths/stats bit-identical over " \
           "96 walks" in r.stdout
    assert r.stdout.splitlines()[-1] == "kernel launches: fused_superstep=0"
