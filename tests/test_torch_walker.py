"""Walker parity: ``repro_torch.walker.compile(program).run`` against
``repro.walker.compile(program).run`` on the same graph, starts and seed.

Every comparison is exact — paths, lengths and all 12 ``WalkStats``
fields are integers, so there is no float output to tolerate.  The port's
``torch`` step is held to the reference's ``jnp`` step and its ``cuda``
step (on CPU tensors: the plain walk-step version) to the reference's
``pallas`` step in interpret mode, as the reference's own tests run it.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import walker as ref_walker
from repro.core import rng as ref_rng
from repro.core.samplers import SamplerSpec as RefSpec
from repro.core.walk_engine import EngineConfig as RefConfig
from repro.core.walk_engine import _run_walks as ref_run_walks
from repro.graph import make_dataset as ref_make_dataset
from repro_torch import walker
from repro_torch.core.rng import stream_key
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.scheduler import analyze_run
from repro_torch.core.walk_engine import EngineConfig, _run_walks
from repro_torch.graph import make_dataset
from repro_torch.serve import WalkService

REPO = pathlib.Path(__file__).resolve().parents[1]
PROGRAMS = ("urw", "ppr", "deepwalk")
MAX_HOPS = 16


@pytest.fixture(scope="module")
def graphs():
    """The WG stand-in at scale 9, built independently by each package."""
    kw = dict(weighted=True, with_alias=True, scale_override=9)
    return ref_make_dataset("WG", **kw), make_dataset("WG", device="cpu", **kw)


@pytest.fixture(scope="module")
def starts():
    return np.random.default_rng(0).integers(0, 512, 300).astype(np.int32)


def program(pkg, name):
    return getattr(pkg.WalkProgram, name)(max_hops=MAX_HOPS)


def assert_bit_equal(port, ref):
    assert np.array_equal(port.paths.numpy(), np.asarray(ref.paths))
    assert np.array_equal(port.lengths.numpy(), np.asarray(ref.lengths))
    assert port.stats._fields == ref.stats._fields
    for f in ref.stats._fields:
        assert int(getattr(port.stats, f)) == int(getattr(ref.stats, f)), f


@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("mode", ["zero_bubble", "static"])
@pytest.mark.parametrize("impl,ref_impl", [("torch", "jnp"),
                                           ("cuda", "pallas")])
def test_run_bit_equal(graphs, starts, name, mode, impl, ref_impl):
    rg, pg = graphs
    want = ref_walker.compile(
        program(ref_walker, name), execution=ref_walker.ExecutionConfig(
            num_slots=64, mode=mode, step_impl=ref_impl)).run(rg, starts, 3)
    got = walker.compile(
        program(walker, name), execution=walker.ExecutionConfig(
            num_slots=64, mode=mode, step_impl=impl)).run(pg, starts, 3)
    assert_bit_equal(got, want)
    assert int(got.stats.supersteps) > 0 and int(got.stats.launches) == int(
        got.stats.supersteps)


@pytest.mark.parametrize("name", PROGRAMS)
def test_run_bit_equal_with_injection_delay(graphs, starts, name):
    rg, pg = graphs
    kw = dict(num_slots=256, injection_delay=2, queue_depth_factor=0.5)
    want = ref_walker.compile(
        program(ref_walker, name),
        execution=ref_walker.ExecutionConfig(**kw)).run(rg, starts, 11)
    got = walker.compile(
        program(walker, name),
        execution=walker.ExecutionConfig(**kw)).run(pg, starts, 11)
    assert_bit_equal(got, want)


def test_run_with_key_seed_and_no_paths(graphs, starts):
    """A key pair seeds like ``stream_key`` (epoch 2 of a stream); without
    path recording the stats still match."""
    rg, pg = graphs
    want = ref_walker.compile(
        program(ref_walker, "ppr"), execution=ref_walker.ExecutionConfig(
            num_slots=64, record_paths=False)).run(
        rg, starts, ref_rng.stream_key(5, 2))
    got = walker.compile(
        program(walker, "ppr"), execution=walker.ExecutionConfig(
            num_slots=64, record_paths=False)).run(pg, starts,
                                                   stream_key(5, 2))
    assert_bit_equal(got, want)
    a = analyze_run(got.stats, 1.0)
    assert a.steps == int(want.stats.steps) and a.drops == 0


def test_run_walks_engine_path(graphs, starts):
    """The engine-internal one-shot path equals the reference's."""
    rg, pg = graphs
    kw = dict(num_slots=64, max_hops=MAX_HOPS, mode="static")
    want = ref_run_walks(rg, starts, RefSpec(kind="alias"), RefConfig(**kw),
                         seed=9)
    got = _run_walks(pg, starts, SamplerSpec(kind="alias"),
                     EngineConfig(**kw), seed=9)
    assert_bit_equal(got, want)


def test_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.walk", "--device", "cpu",
         "--scale", "9", "--queries", "200", "--slots", "64",
         "--max-hops", "12", "--algo", "deepwalk", "--step-impl", "cuda"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert "steps=" in out.stdout and "MStep/s" in out.stdout


def test_unported_paths_raise_not_implemented(graphs, starts, monkeypatch):
    _, pg = graphs
    auto = walker.ExecutionConfig(num_slots="auto")   # ported: the tuner
    assert auto.auto_knobs == ("num_slots",)
    with pytest.raises(ValueError, match="hops_per_launch"):
        walker.ExecutionConfig(step_impl="fused", hops_per_launch="fast")
    with pytest.raises(ValueError, match="auto"):
        auto.engine_config(walker.WalkProgram.urw())
    with pytest.raises(ValueError, match="cache_budget"):
        walker.ExecutionConfig(cache_budget=-1)
    sharded = walker.compile(walker.WalkProgram.urw(4), backend="sharded",
                             execution=walker.ExecutionConfig(
                                 num_devices=2, num_slots=64))
    res = sharded.run(pg, starts)   # ported: runs, as the single backend
    single = walker.compile(walker.WalkProgram.urw(4)).run(pg, starts)
    assert torch.equal(res.paths, single.paths)
    assert int(res.stats.drops) == 0
    w = walker.compile(walker.WalkProgram.urw())
    assert isinstance(w.serve(pg), WalkService)   # ported: no longer raises
    with pytest.raises(ValueError):
        walker.ExecutionConfig(step_impl="jnp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_dataset("WG", scale_override=6)


def test_runs_where_the_graph_lives(graphs, starts):
    _, pg = graphs
    res = walker.compile(walker.WalkProgram.urw(4)).run(
        pg, torch.from_numpy(starts))
    assert res.paths.device == pg.device and res.stats.steps.device == pg.device


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)
    code = ("import sys, repro_torch, repro_torch.walker, repro_torch.graph, "
            "repro_torch.launch.walk, repro_torch.configs.ridgewalker, "
            "repro_torch.tune, repro_torch.tune.__main__, repro_torch.kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "raise SystemExit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
