"""Public names: every name the reference exports from the modules below
imports from the port too, and the port's copies of the reference's small
functions (graph generators, scheduler formulas, ``task_fold``) give the
reference's results.

Integer and key outputs are compared exactly; the one float formula
(``peak_random_access_bandwidth``) is the same expression in float64 in
both packages, so it is compared exactly too.
"""
import ast
import importlib
import inspect
import os
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC
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
    ("optim", "grad_compression"), ("runtime", "elastic"),
    ("distributed", "pipeline"),
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
    ("core.rng", "SaltChannel"), ("core.rng", "SaltRegistry"),
    ("core.rng", "SALTS"), ("core.rng", "task_bits"),
    ("core.phase_program", "KINDS"), ("core.phase_program", "DrawStream"),
    ("core.phase_program", "fused_kinds"),
    ("core.phase_program", "support_rows"),
    ("core.phase_program", "render_support_matrix"),
    ("core.phase_program", "render_schedule_table"),
    ("core.walk_engine", "ENGINE_DRAW_STREAMS"),
    ("core.corpus_ring", "CORPUS_DRAW_STREAMS"),
    ("analysis", "Finding"), ("analysis", "render_findings"),
    ("analysis", "run_all"),
    ("analysis.rng_collisions", "spec_streams"),
    ("analysis.rng_collisions", "check_streams"),
    ("analysis.rng_collisions", "check_kinds"),
    ("analysis.rng_collisions", "check_call_sites"),
    ("analysis.rng_collisions", "check_source"),
    ("analysis.residency", "check_program"),
    ("analysis.determinism", "check_source"),
    ("analysis.tables", "render_salt_table"),
    ("analysis.tables", "render_stream_table"),
    ("analysis.tables", "render_table"),
    ("analysis.tables", "render_schedule_table"),
    ("analysis.fixtures", "FIXTURES"), ("analysis.fixtures", "run_fixture"),
]


# Names the port adds beside the reference's: the device groups of the
# LM training substrate (the reference's mesh and ``shard_map`` need none).
PORT_NAMES = [
    ("distributed", "ppermute"), ("distributed", "axis_devices"),
    ("distributed", "card_groups"), ("distributed", "place_stages"),
    ("distributed", "StageGroups"), ("distributed.mesh", "ppermute"),
    ("distributed.pipeline", "place_stages"),
]


def _kind(x) -> str:
    return ("module" if inspect.ismodule(x) else "class" if inspect.isclass(x)
            else "callable" if callable(x) else type(x).__name__)


# The model zoo (models, configs, data, sampler, loop, launchers, the
# dry-run tooling) and the DMA-schedule IR with its hazard pass: every
# public name the reference defines in these modules, found by reading the
# reference, less the DEFERRED ones: ``shard_batch``, a JAX sharding,
# which the port's ``data.pipeline.to_device`` replaces, and
# ``default_interpret``.
ZOO_MODULES = (
    "models.layers", "models.gnn", "models.gnn.common", "models.gnn.schnet",
    "models.gnn.pna", "models.gnn.meshgraphnet", "models.gnn.mace",
    "models.recsys", "models.recsys.embedding", "models.recsys.dcn",
    "configs", "configs.base", "configs.schnet", "configs.pna",
    "configs.meshgraphnet", "configs.mace", "configs.dcn_v2",
    "configs.ridgewalker", "data", "data.pipeline", "graph.datasets",
    "graph.sampling_service", "runtime.train_loop", "launch.train",
    "optim.adamw", "models.attention_chunked", "models.moe",
    "models.transformer", "configs.phi35_moe", "configs.granite_moe",
    "configs.deepseek_7b", "configs.minitron_8b", "configs.stablelm_12b",
    "launch.serve", "optim.grad_compression", "runtime.elastic",
    "distributed.pipeline", "launch.specs", "launch.mesh",
    "kernels.common", "analysis.dma_hazards",
)
DEFERRED = {
    ("data.pipeline", "shard_batch"),
    # Chooses Pallas interpret mode off a TPU; a CUDA wrapper has no such
    # mode (a CPU tensor runs the plain version), so it has no counterpart.
    ("kernels.common", "default_interpret"),
}
# Modules of the reference that set ``XLA_FLAGS`` when imported (512 host
# devices for the dry-run's mesh): their names are read from the source,
# so that no test process imports them.
SOURCE_MODULES = ("launch.dryrun", "launch.perf")


def _public_names(module: str):
    """The names ``repro.<module>`` defines: its functions and classes,
    its constants and the submodules its own source imports (not what it
    imports from elsewhere, nor submodules that other imports attached to
    a package: the list must not depend on what was imported before)."""
    ref = importlib.import_module(f"repro.{module}")
    own = {alias.name for node in ast.walk(ast.parse(inspect.getsource(ref)))
           if isinstance(node, ast.ImportFrom)
           and node.module == f"repro.{module}" for alias in node.names}
    out = []
    for name, obj in vars(ref).items():
        if name.startswith("_") or name == "annotations":
            continue
        if inspect.ismodule(obj):
            if name in own:
                out.append(name)
        elif inspect.isfunction(obj) or inspect.isclass(obj):
            if obj.__module__ == ref.__name__:
                out.append(name)
        elif type(obj).__module__ != "typing":
            out.append(name)
    return [(module, n) for n in sorted(out) if (module, n) not in DEFERRED]


ZOO_NAMES = [item for m in ZOO_MODULES for item in _public_names(m)]


def _source_names(module: str):
    """``(module, name, kind)`` for each public function, class and
    constant that ``repro.<module>``'s source defines at its top level,
    read with ``ast`` (the module is not imported)."""
    path = os.path.join(SRC, "repro", *module.split(".")) + ".py"
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            kind = "class" if isinstance(node, ast.ClassDef) else "callable"
            out.append((module, node.name, kind))
        elif isinstance(node, ast.Assign):
            out += [(module, t.id, "constant") for t in node.targets
                    if isinstance(t, ast.Name)]
    return [item for item in out if not item[1].startswith("_")]


SOURCE_NAMES = [item for m in SOURCE_MODULES for item in _source_names(m)]


def test_zoo_names_cover_the_deferred_list():
    """Every deferred name exists in the reference (the list is not
    stale), and the port's replacement for ``shard_batch`` exists."""
    for module, name in DEFERRED:
        assert hasattr(importlib.import_module(f"repro.{module}"), name)
    from repro_torch.data import pipeline
    assert callable(pipeline.to_device)


@pytest.mark.parametrize("module,name", NAMES + ZOO_NAMES)
def test_name_imports_from_both_packages(module, name):
    ref = getattr(importlib.import_module(f"repro.{module}"), name)
    port = getattr(importlib.import_module(f"repro_torch.{module}"), name)
    assert _kind(port) == _kind(ref)
    # Importing the kernels' wrappers builds nothing (no nvcc here).
    from repro_torch.kernels import build
    assert build._loaded == {}


@pytest.mark.parametrize("module,name", PORT_NAMES)
def test_port_name_imports_from_the_port(module, name):
    mod = importlib.import_module(f"repro_torch.{module}")
    assert callable(getattr(mod, name))
    if hasattr(mod, "__all__"):
        assert name in mod.__all__


@pytest.mark.parametrize("module,name,kind", SOURCE_NAMES)
def test_source_read_name_imports_from_the_port(module, name, kind):
    port = getattr(importlib.import_module(f"repro_torch.{module}"), name)
    if kind == "constant":
        assert not callable(port)
    else:
        assert _kind(port) == kind
    assert "repro.launch.dryrun" not in sys.modules


def test_source_read_names_cover_the_tools():
    assert {n for _, n, _ in SOURCE_NAMES} == {
        "collective_bytes", "roofline_terms", "run_cell", "main",
        "parse_val"}


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
