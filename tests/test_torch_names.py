"""Public names: every name the reference exports from the modules below
imports from the port too, and the port's copies of the reference's small
functions (graph generators, scheduler formulas, ``task_fold``) give the
reference's results.

Integer and key outputs are compared exactly; the one float formula
(``peak_random_access_bandwidth``) is the same expression in float64 in
both packages, so it is compared exactly too.
"""
import importlib
import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as ref_rng
from repro_torch.core import rng as port_rng
from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.walk_engine import (EngineConfig, build_engine,
                                          make_engine, run_walks)
from repro_torch.graph import make_dataset

NAMES = [
    ("walker", "WalkStream"),
    ("core", "CorpusRing"), ("core", "corpus_ring"), ("core", "edge_exists"),
    ("core", "make_engine"), ("core", "run_walks"),
    ("kernels", "embedding_bag"), ("kernels", "segment_sum"),
    ("kernels", "SegmentSumOp"), ("kernels", "walk_step_uniform"),
    ("kernels", "walk_step_alias"),
    ("optim", "adamw"), ("runtime", "train_loop"),
    ("checkpoint", "checkpointer"),
    ("graph", "erdos_renyi_edges"),
    ("graph.generators", "erdos_renyi_edges"),
    ("graph.generators", "power_law_edges"),
    ("graph.generators", "dangling_fraction"),
    ("core.scheduler", "butterfly_feedback_delay"),
    ("core.scheduler", "per_pipeline_fifo_depth"),
    ("core.scheduler", "peak_random_access_bandwidth"),
    ("core.rng", "task_fold"),
    ("walker", "ShardedWalkStream"),
    ("core", "N2VSlots"), ("core", "ReservoirSlots"),
    ("core.tasks", "empty_n2v_slots"), ("core.tasks", "empty_reservoir_slots"),
    ("core.scheduler", "routing_capacity"),
    ("core.phase_program", "chunk_score"),
    ("graph", "partition_graph"), ("graph", "PartitionedGraph"),
    ("graph", "owner_of"), ("graph.partition", "local_id"),
    ("core.router", "RouteResult"), ("core.router", "pack_buckets"),
    ("core.router", "exchange"),
    ("core.distributed", "DistConfig"), ("core.distributed", "LocalView"),
    ("core.distributed", "DistLogs"), ("core.distributed", "StepOut"),
    ("core.distributed", "ProgramCapability"),
    ("core.distributed", "get_capability"),
    ("core.distributed", "make_distributed_engine"),
    ("core.distributed", "DistStreamState"),
    ("core.distributed", "init_dist_stream_state"),
    ("core.distributed", "inject_stream_queries"),
    ("core.distributed", "make_sharded_stream_engine"),
    ("core.distributed", "shard_starts"),
    ("core.distributed", "run_distributed"),
    ("core.distributed", "assemble_paths"),
]


def _kind(x) -> str:
    return ("module" if inspect.ismodule(x) else "class" if inspect.isclass(x)
            else "callable" if callable(x) else type(x).__name__)


@pytest.mark.parametrize("module,name", NAMES)
def test_name_imports_from_both_packages(module, name):
    ref = getattr(importlib.import_module(f"repro.{module}"), name)
    port = getattr(importlib.import_module(f"repro_torch.{module}"), name)
    assert _kind(port) == _kind(ref)
    # Importing the kernels' wrappers builds nothing (no nvcc here).
    from repro_torch.kernels import build
    assert build._loaded == {}


@pytest.mark.parametrize("seed", [0, 7])
def test_generators_equal(seed):
    from repro.graph import generators as ref_gen
    from repro_torch.graph import generators as port_gen
    for fn, args in (("erdos_renyi_edges", (300, 2_000)),
                     ("power_law_edges", (300, 2_000, 1.7))):
        want = getattr(ref_gen, fn)(*args, seed=seed)
        got = getattr(port_gen, fn)(*args, seed=seed)
        assert got.dtype == np.int64 and np.array_equal(got, want)
        assert (port_gen.dangling_fraction(got, 300)
                == ref_gen.dangling_fraction(want, 300))


def test_scheduler_formulas_equal():
    from repro.core import scheduler as ref_s
    from repro_torch.core import scheduler as port_s
    for n in range(2, 65):
        assert (port_s.butterfly_feedback_delay(n)
                == ref_s.butterfly_feedback_delay(n))
        assert (port_s.per_pipeline_fifo_depth(n)
                == ref_s.per_pipeline_fifo_depth(n))
        for w in (1, 7, 256, 1024):
            for margin in (0.5, 1.0, 2.0, 3.3):
                assert (port_s.routing_capacity(w, n, margin)
                        == ref_s.routing_capacity(w, n, margin))
    for args in ((1.6e9, 4.0, 4), (2.4e9, 6.5, 32, 128)):
        assert (port_s.peak_random_access_bandwidth(*args)
                == ref_s.peak_random_access_bandwidth(*args))


@pytest.mark.parametrize("salt", [0, 2, 17])
@pytest.mark.parametrize("epochs", ["none", "zero", "mixed"])
def test_task_fold_bit_equal(salt, epochs):
    rng = np.random.default_rng(salt)
    W = 65
    qid = rng.integers(0, 5000, W).astype(np.int32)
    hop = rng.integers(0, 80, W).astype(np.int32)
    ep = {"none": None, "zero": np.zeros(W, np.int32),
          "mixed": rng.integers(0, 4, W).astype(np.int32)}[epochs]
    ref = np.asarray(ref_rng.task_fold(
        ref_rng.stream_key(99), jnp.asarray(qid), jnp.asarray(hop), salt,
        None if ep is None else jnp.asarray(ep)))
    port = port_rng.task_fold(
        port_rng.stream_key(99), torch.from_numpy(qid), torch.from_numpy(hop),
        salt, None if ep is None else torch.from_numpy(ep))
    assert port.shape == (W, 2)
    assert np.array_equal(port.numpy().astype(np.uint32),
                          ref.astype(np.uint32))


def test_deprecated_shims_warn_and_walk_as_build_engine():
    g = make_dataset("WG", scale_override=9, device="cpu")
    spec = SamplerSpec(kind="uniform")
    cfg = EngineConfig(num_slots=32, max_hops=8)
    starts = torch.arange(100, dtype=torch.int32) % g.num_vertices
    want, _ = build_engine(spec, cfg)(g, starts, port_rng.stream_key(4))
    with pytest.warns(DeprecationWarning, match="make_engine"):
        engine = make_engine(spec, cfg)
    got, _ = engine(g, starts, port_rng.stream_key(4))
    with pytest.warns(DeprecationWarning, match="run_walks"):
        once = run_walks(g, starts.numpy(), spec, cfg, seed=4)
    for res in (got, once):
        assert torch.equal(res.paths, want.paths)
        assert torch.equal(res.lengths, want.lengths)
        assert tuple(res.stats) == tuple(want.stats)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        build_engine(spec, cfg)       # the supported path does not warn
