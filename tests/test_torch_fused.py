"""Fused superstep parity: the port's ``step_impl="fused"`` against the
reference's ``step_impl="fused"`` and against the port's per-hop steps.

On the CPU the port's fused launch runs the kernel's plain version
(``repro_torch/kernels/fused_superstep/ref.py``); the reference's runs its
Pallas kernel in interpret mode, as the reference's own tests run it.
Sizes follow ``tests/test_fused_step.py``: the WG stand-in at scale 9,
weighted, with alias tables and 3 edge types, 32 slots, 10 hops, 60-100
starts.

Every comparison is exact: paths, lengths and all 12 ``WalkStats`` fields
are integers.  Against the reference's fused run all 12 fields must be
equal, ``launches`` included; against the port's ``torch`` step every
field but ``launches`` (one per superstep there, one per launch here).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.samplers import SamplerSpec as RefSpec
from repro.core.walk_engine import EngineConfig as RefConfig
from repro.core.walk_engine import _run_walks as ref_run_walks
from repro.graph import make_dataset as ref_make_dataset
from repro_torch import walker
from repro_torch.core import walk_engine
from repro_torch.core.phase_program import lower
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.walk_engine import EngineConfig, _run_walks
from repro_torch.graph import build_hot_cache, make_dataset
from repro_torch.kernels.fused_superstep import LAUNCHES, ops
from repro_torch.kernels.fused_superstep import ref as fused_ref
from repro_torch.kernels.walk_step import LAUNCHES as WALK_STEP_LAUNCHES

REPO = pathlib.Path(__file__).resolve().parents[1]
SPECS = {
    "urw": dict(kind="uniform"),
    "ppr": dict(kind="uniform", stop_prob=0.15),
    "deepwalk": dict(kind="alias"),
    "metapath": dict(kind="metapath", metapath=(0, 1, 2)),
}
CFG = dict(num_slots=32, max_hops=10)


@pytest.fixture(scope="module")
def graphs():
    """The WG stand-in at scale 9 with every payload the four programs
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


def assert_same(port, want, launches=True):
    assert np.array_equal(port.paths.numpy(), np.asarray(want.paths))
    assert np.array_equal(port.lengths.numpy(), np.asarray(want.lengths))
    assert port.stats._fields == want.stats._fields
    for f in want.stats._fields:
        if f == "launches" and not launches:
            continue
        assert int(getattr(port.stats, f)) == int(getattr(want.stats, f)), f


@pytest.mark.parametrize("algo", sorted(SPECS))
@pytest.mark.parametrize("mode", ["zero_bubble", "static"])
def test_fused_bit_equal_to_reference_and_torch_step(graphs, algo, mode):
    rg, pg = graphs
    starts = starts_of(80, seed=len(algo))
    kw = dict(mode=mode, step_impl="fused", hops_per_launch=4)
    want = run_ref(rg, starts, algo, 9, **kw)
    got = run_port(pg, starts, algo, 9, **kw)
    assert_same(got, want)
    per_hop = run_port(pg, starts, algo, 9, mode=mode)
    assert_same(got, per_hop, launches=False)
    assert 0 < int(got.stats.launches) < int(got.stats.supersteps)
    assert int(per_hop.stats.launches) == int(per_hop.stats.supersteps)


def test_hops_per_launch_changes_only_launches(graphs):
    _, pg = graphs
    starts = starts_of(60, seed=4)
    per_hop = run_port(pg, starts, "ppr", 4)
    launches = []
    for k in (1, 3, 16):
        got = run_port(pg, starts, "ppr", 4, step_impl="fused",
                       hops_per_launch=k)
        assert_same(got, per_hop, launches=False)
        launches.append(int(got.stats.launches))
    assert launches[0] == int(per_hop.stats.supersteps)
    assert launches[0] > launches[1] > launches[2] >= 1


@pytest.mark.parametrize("delay", [1, 3])
def test_injection_delay_equal_to_reference(graphs, delay):
    rg, pg = graphs
    starts = starts_of(100, seed=2)
    kw = dict(injection_delay=delay, step_impl="fused", hops_per_launch=4)
    assert_same(run_port(pg, starts, "urw", 2, **kw),
                run_ref(rg, starts, "urw", 2, **kw))


def test_no_record_paths_equal_to_reference(graphs):
    rg, pg = graphs
    starts = starts_of(64, seed=6)
    kw = dict(record_paths=False, step_impl="fused", hops_per_launch=4)
    got = run_port(pg, starts, "ppr", 6, **kw)
    assert tuple(got.paths.shape) == (1, 1) and int(got.paths[0, 0]) == -1
    assert_same(got, run_ref(rg, starts, "ppr", 6, **kw))


def test_max_supersteps_ending_mid_launch_equal_to_reference(graphs):
    rg, pg = graphs
    starts = starts_of(100, seed=7)
    kw = dict(max_supersteps=7, step_impl="fused", hops_per_launch=4)
    got = run_port(pg, starts, "deepwalk", 7, **kw)
    assert_same(got, run_ref(rg, starts, "deepwalk", 7, **kw))
    assert int(got.stats.supersteps) == 7 and int(got.stats.launches) == 2


def test_metapath_per_hop_steps_equal_to_reference(graphs):
    """MetaPath under ``torch`` equals the reference's ``jnp``; under
    ``cuda`` it runs the plain superstep (the one-hop kernels do not cover
    the typed gather), so no walk-step launch is counted."""
    rg, pg = graphs
    starts = starts_of(80, seed=3)
    want = run_ref(rg, starts, "metapath", 5, step_impl="jnp")
    assert_same(run_port(pg, starts, "metapath", 5), want)
    before = dict(WALK_STEP_LAUNCHES)
    assert_same(run_port(pg, starts, "metapath", 5, step_impl="cuda"), want)
    assert dict(WALK_STEP_LAUNCHES) == before


def test_metapath_walker_program(graphs):
    _, pg = graphs
    prog = walker.WalkProgram.metapath((0, 2), max_hops=6)
    assert prog.spec == SamplerSpec(kind="metapath", metapath=(0, 2))
    assert prog.name == "metapath" and prog.max_hops == 6
    res = walker.compile(prog, execution=walker.ExecutionConfig(
        num_slots=32, step_impl="fused")).run(pg, starts_of(40), seed=1)
    assert int(res.stats.terminations) == 40
    with pytest.raises(ValueError, match="edge type"):
        walker.compile(walker.WalkProgram.metapath((3,))).run(pg, [0])
    untyped = make_dataset("WG", scale_override=6, device="cpu")
    with pytest.raises(ValueError, match="typed graph"):
        walker.compile(prog).run(untyped, [0])


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(_clone(f) for f in x))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _tensors(f)]


def _state(cfg):
    """A batch's first state on the CPU, packed with its control block."""
    return ops.pack(walk_engine.init_state(cfg, 32,
                                           torch.from_numpy(starts_of(40))))


@pytest.mark.parametrize("bad", ["hop_dtype", "active_dtype", "paths_shape",
                                 "hist_shape", "alias_dtype", "k_negative",
                                 "metapath_type", "block_unpacked",
                                 "block_dtype", "weights_dtype",
                                 "inv_p_overflow", "cache_dtype",
                                 "cache_shape", "cache_type_stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(graphs, bad):
    _, pg = graphs
    cfg = EngineConfig(**CFG)
    spec = SamplerSpec(kind="alias")
    (state, block), k, g = _state(cfg), 4, pg
    if bad == "hop_dtype":
        state = state._replace(slots=state.slots._replace(
            hop=state.slots.hop.long()))
    elif bad == "active_dtype":
        state = state._replace(slots=state.slots._replace(
            active=state.slots.active.int()))
    elif bad == "paths_shape":
        state = state._replace(paths=state.paths[:, :-1].contiguous())
    elif bad == "hist_shape":
        state = state._replace(head_hist=torch.zeros(3, dtype=torch.int64))
    elif bad == "alias_dtype":
        g = dataclasses.replace(pg, alias_prob=pg.alias_prob.double())
    elif bad == "k_negative":
        k = -1
    elif bad == "metapath_type":
        spec = SamplerSpec(kind="metapath", metapath=(0, 3))
    elif bad == "block_unpacked":   # a block the state's scalars do not view
        block = block.clone()
    elif bad == "block_dtype":
        block = block.int()
    elif bad == "weights_dtype":
        spec = SamplerSpec(kind="reservoir_n2v")
        g = dataclasses.replace(pg, weights=pg.weights.double())
    elif bad == "inv_p_overflow":   # 1/p beyond float32's range
        spec = SamplerSpec(kind="rejection_n2v", p=1e-39)
    cache = None
    if bad.startswith("cache"):
        cache = ops.cache_block(build_hot_cache(
            pg, lower(spec).cache_payloads, 1 << 13), pg.device)
    if bad == "cache_dtype":
        cache = dataclasses.replace(cache, words=cache.words.long())
    elif bad == "cache_shape":   # a block shorter than its layout says
        cache = dataclasses.replace(cache, words=cache.words[:-1].clone())
    elif bad == "cache_type_stride":   # a cache of another graph's types
        spec = SamplerSpec(kind="metapath", metapath=(0, 1))
        cache = ops.cache_block(build_hot_cache(
            pg, lower(spec).cache_payloads, 1 << 13), pg.device)
        cache = dataclasses.replace(cache, type_stride=3)
    err = TypeError if bad.endswith("_dtype") else ValueError
    before = dict(LAUNCHES)
    with pytest.raises(err):
        ops.fused_superstep(g, spec, cfg, 32, state, (0, 1), k, block,
                            cache=cache)
    assert dict(LAUNCHES) == before


def test_cpu_launch_updates_the_packed_state_in_place(graphs):
    """On the CPU, as on the card, a launch writes its result into the
    packed state and its control block, whose first two words are the
    progress pair."""
    _, pg = graphs
    cfg = EngineConfig(**CFG, step_impl="fused")
    spec = SamplerSpec(kind="uniform", stop_prob=0.15)
    state, block = _state(cfg)
    want = fused_ref.fused_superstep_ref(pg, spec, cfg, 32, _clone(state),
                                         (0, 1), 3)
    got = ops.fused_superstep(pg, spec, cfg, 32, state, (0, 1), 3, block)
    assert got is state
    for a, b in zip(_tensors(got), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got.stats.launches) == 1 and int(got.stats.supersteps) == 3
    assert ops.progress(block) == (True, 3)


def test_unported_kinds_and_cache_raise(graphs):
    """The wrapper takes a hot-vertex cache (the kernel's gather hierarchy
    is ported): on the CPU it runs the plain version with the cache's hot
    ids, counting the three cache counters.  A cache without a payload the
    kind reads (DeepWalk's alias tables) is dropped, counting nothing."""
    _, pg = graphs
    cfg = EngineConfig(**CFG)
    spec = SamplerSpec(kind="alias")
    cache = ops.cache_block(build_hot_cache(
        pg, ("col", "alias_prob", "alias_idx"), 1 << 13), pg.device)
    state, block = _state(cfg)
    want = fused_ref.fused_superstep_ref(pg, spec, cfg, 32, _clone(state),
                                         (0, 1), 4, cache.hot_ids)
    got = ops.fused_superstep(pg, spec, cfg, 32, state, (0, 1), 4, block,
                              cache=cache)
    for a, b in zip(_tensors(got), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got.stats.cache_hits) > 0
    bare = ops.cache_block(build_hot_cache(pg, ("col",), 1 << 13), pg.device)
    state, block = _state(cfg)
    got = ops.fused_superstep(pg, spec, cfg, 32, state, (0, 1), 4, block,
                              cache=bare)
    assert int(got.stats.cache_hits) + int(got.stats.cache_misses) == 0


def test_cpu_launch_runs_the_plain_version_without_counting(graphs):
    _, pg = graphs
    before = dict(LAUNCHES)
    run_port(pg, starts_of(60), "urw", 0, step_impl="fused")
    assert dict(LAUNCHES) == before


def test_cli_fused_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.walk", "--device", "cpu",
         "--scale", "9", "--queries", "200", "--slots", "64",
         "--max-hops", "12", "--algo", "ppr", "--step-impl", "fused",
         "--hops-per-launch", "4"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    line = out.stdout.strip().splitlines()[-1]
    fields = dict(f.split("=", 1) for f in line.split() if "=" in f)
    assert 0 < int(fields["launches"]) < int(fields["supersteps"])
