"""The dry-run tooling on the port (``launch.specs``, ``launch.mesh``,
``launch.dryrun``, ``launch.perf``, ``param_specs``,
``moe_param_specs``), held against the reference on the CPU.

The reference's ``launch.dryrun`` and ``launch.perf`` set ``XLA_FLAGS``
to 512 host devices when imported, and its cells need the 512-device
mesh, so everything of the reference is read in one subprocess with 512
forced devices (``conftest.run_in_subprocess``): its 80 cells are built
(``build_cell``, nothing lowered or compiled) and each argument leaf's
shape, dtype, spec and ``NamedSharding.shard_shape`` printed, beside its
``param_specs``, ``moe_param_specs``, ``zero_spec``, ``apply_overrides``,
``scan_layer_count`` and ``parse_val`` on fixed inputs.  Every
comparison is exact: these are shapes, specs and integers.

The port's counts are held to hand counts: the matrix products of SMOKE
training cells, the collective rules on hand-worked cells, the roofline
on fixed inputs, and the layer extrapolation to the full count.
"""
import dataclasses
import json
import math
import subprocess
import sys

import pytest
import torch

from conftest import SRC, run_in_subprocess
from repro_torch.checkpoint.checkpointer import leaves
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed.mesh import GridMesh, PartitionSpec, shard_shape
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.meta_cost import KernelCost
from repro_torch.kernels.segment_sum import ref as ss_ref
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.launch import dryrun, mesh as port_mesh, perf, specs
from repro_torch.models import layers as L
from repro_torch.models import moe, transformer as tfm

CELLS = [(a, s, mp) for mp in (False, True) for a in ARCHS
         for s in get_arch(a).SHAPES]
LM_ARCHS = [a for a in ARCHS if get_arch(a).FAMILY == "lm"]
# Config variants of every LM arch whose placements differ.
LM_VARIANTS = [{}, {"kv_sharding": "heads"}, {"kv_sharding": "replicate"},
               {"vocab": 1000}, {"n_heads": 32, "n_kv_heads": 8}]
ZERO_CASES = [((None, "model"), (64, 32)), ((), (3, 48)), ((), (16,)),
              (("model", None), (32, 16)), ((None, None), (15, 17)),
              ((None,), (2, 8, 16)), (("data", None), (32, 32))]
OVERRIDES = [{}, {"n_layers": 3}, {"remat": False, "vocab_parallel_ce": True},
             {"moe.dispatch": "row", "moe.capacity_factor": 2.0}]
PARSE = ["true", "False", "7", "-3", "1e-3", "2.5", "row", "3x"]

REF_SCRIPT = """
import dataclasses, json, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import ARCHS, get_arch
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import (apply_overrides, build_cell,
                                scan_layer_count, zero_spec)
from repro.launch.perf import parse_val
from repro.models import transformer as tfm
from repro.models.moe import moe_param_specs

def spec(s):
    return [None if e is None else [e] if isinstance(e, str) else list(e)
            for e in s]

def cfg_dict(c):
    return {k: (v.__name__ if k == "dtype" and hasattr(v, "__name__")
                else str(jnp.dtype(v)) if k == "dtype" else v)
            for k, v in dataclasses.asdict(c).items()}

out = {"cells": {}, "param_specs": {}, "moe": {}, "zero": [],
       "overrides": {}, "layers": {}, "parse": []}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for a in ARCHS:
        for s in get_arch(a).SHAPES:
            fn, args, donate, meta = build_cell(a, s, mesh, mp)
            out["cells"][f"{a}|{s}|{int(mp)}"] = {
                "meta": meta, "donate": list(donate),
                "leaves": [[list(l.shape), str(l.dtype),
                            spec(l.sharding.spec),
                            list(l.sharding.shard_shape(l.shape))]
                           for l in jax.tree.leaves(args)]}
for a in ARCHS:
    mod = get_arch(a)
    out["layers"][a] = list(scan_layer_count(a))
    if mod.FAMILY != "lm":
        continue
    for i, ov in enumerate(VARIANTS):
        for which in ("FULL", "SMOKE"):
            c = dataclasses.replace(getattr(mod, which), **ov)
            out["param_specs"][f"{a}|{which}|{i}"] = jax.tree.map(
                spec, tfm.param_specs(c),
                is_leaf=lambda x: isinstance(x, P))
    for i, ov in enumerate(OVERRIDES):
        if any(k.startswith("moe.") for k in ov) and not mod.FULL.moe:
            continue
        out["overrides"][f"{a}|{i}"] = cfg_dict(apply_overrides(mod.FULL, ov))
    if mod.FULL.moe:
        for sh in ("expert", "ffn"):
            for ax in ("model", "tp"):
                m = dataclasses.replace(mod.FULL.moe, expert_sharding=sh)
                out["moe"][f"{a}|{sh}|{ax}"] = {
                    k: spec(v) for k, v in moe_param_specs(m, ax).items()}
for sp, shape in ZERO:
    out["zero"].append(spec(zero_spec(P(*sp), shape)))
out["parse"] = [[type(v).__name__, v] for v in map(parse_val, PARSE)]
print("JSON" + json.dumps(out))
"""


def _spec(s):
    return [None if e is None else [e] if isinstance(e, str) else list(e)
            for e in s]


@pytest.fixture(scope="module")
def ref():
    code = (f"VARIANTS = {LM_VARIANTS!r}\nOVERRIDES = {OVERRIDES!r}\n"
            f"ZERO = {ZERO_CASES!r}\nPARSE = {PARSE!r}\n" + REF_SCRIPT)
    out = run_in_subprocess(code, devices=512)
    return json.loads(out.split("JSON", 1)[1])


def _cell_id(c):
    return f"{c[0]}-{c[1]}-{'multi' if c[2] else 'single'}"


@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_cell_equals_reference(ref, cell):
    """meta, donation, and per argument leaf: shape, dtype, spec and the
    per-device shard shape (``shard_shape`` against the reference's
    ``NamedSharding.shard_shape``)."""
    arch, shape, mp = cell
    want = ref["cells"][f"{arch}|{shape}|{int(mp)}"]
    mesh = port_mesh.make_production_mesh(multi_pod=mp)
    fn, args, donate, meta = specs.build_cell(arch, shape, mesh, mp)
    assert meta == want["meta"]
    assert list(donate) == want["donate"]
    got = [[list(t.shape), str(t.dtype).replace("torch.", ""), _spec(s),
            list(shard_shape(t.shape, s, mesh))]
           for t, s in zip(leaves(tuple(args)), specs.spec_leaves(args.specs),
                           strict=True)]
    assert len(got) == len(want["leaves"])
    for g, w in zip(got, want["leaves"]):
        assert g == w
    assert all(t.device.type == "meta" for t in leaves(tuple(args)))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_reference(ref, arch):
    mod = get_arch(arch)
    for i, ov in enumerate(LM_VARIANTS):
        for which in ("FULL", "SMOKE"):
            cfg = dataclasses.replace(getattr(mod, which), **ov)
            pspecs = tfm.param_specs(cfg)
            got = [_spec(s) for s in specs.spec_leaves(pspecs)]
            want = ref["param_specs"][f"{arch}|{which}|{i}"]
            assert got == list(_flat(want))
            # each spec addresses a leaf of the port's tree
            tree = tfm.init_params(torch.Generator(), cfg, device="meta")
            assert len(leaves(tree)) == len(got)
            for t, s in zip(leaves(tree), specs.spec_leaves(pspecs)):
                assert len(s) == t.dim()
    if mod.FULL.moe:
        for sh in ("expert", "ffn"):
            for ax in ("model", "tp"):
                m = dataclasses.replace(mod.FULL.moe, expert_sharding=sh)
                got = {k: _spec(v)
                       for k, v in moe.moe_param_specs(m, ax).items()}
                assert got == ref["moe"][f"{arch}|{sh}|{ax}"]


def _flat(tree):
    """The reference's printed spec tree's specs, dict keys sorted (its
    pytree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    else:
        yield tree


def test_zero_spec_equals_reference(ref):
    got = [_spec(specs.zero_spec(PartitionSpec(*sp), shape))
           for sp, shape in ZERO_CASES]
    assert got == ref["zero"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_apply_overrides_equals_reference(ref, arch):
    full = get_arch(arch).FULL
    for i, ov in enumerate(OVERRIDES):
        key = f"{arch}|{i}"
        if key not in ref["overrides"]:
            continue
        got = dataclasses.asdict(specs.apply_overrides(full, ov))
        got["dtype"] = str(got["dtype"]).replace("torch.", "")
        assert json.loads(json.dumps(got)) == ref["overrides"][key]


def test_scan_layer_count_and_parse_val_equal_reference(ref):
    for arch in ARCHS:
        assert list(specs.scan_layer_count(arch)) == ref["layers"][arch]
    got = [[type(v).__name__, v] for v in map(perf.parse_val, PARSE)]
    assert got == ref["parse"]


def test_production_mesh_is_meta_and_constants_are_the_h100s():
    single = port_mesh.make_production_mesh()
    multi = port_mesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.axis_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    assert single.device.type == multi.device.type == "meta"
    assert (port_mesh.PEAK_FLOPS_BF16, port_mesh.HBM_BW,
            port_mesh.ICI_BW) == (989e12, 3.35e12, 4.5e11)
    with pytest.raises(ValueError, match="does not divide"):
        shard_shape((10, 4), PartitionSpec("data"), single)
    with pytest.raises(ValueError, match="twice"):
        shard_shape((32, 32), PartitionSpec("data", "data"), single)


def test_roofline_terms_by_hand():
    r = dryrun.roofline_terms(989e12 * 2e-3, 3.35e12 * 5e-3, 4.5e11 * 1e-3,
                              256)
    assert r["compute_s"] == pytest.approx(2e-3, rel=1e-15)
    assert r["memory_s"] == pytest.approx(5e-3, rel=1e-15)
    assert r["collective_s"] == pytest.approx(1e-3, rel=1e-15)
    assert r["dominant"] == "memory_s" and r["bound_s"] == r["memory_s"]
    r = dryrun.roofline_terms(1e15, 1e9, 0.0, 1)
    assert r["dominant"] == "compute_s"
    assert r["bound_s"] == 1e15 / 989e12


# ------------------------------------------------------------ the counts

ONE = GridMesh((1, 1), ("data", "model"), torch.device("meta"))
SMOKE_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab", "moe")


def _smoke_overrides(arch, **kw):
    smoke = get_arch(arch).SMOKE
    return {**{f: getattr(smoke, f) for f in SMOKE_FIELDS}, **kw}


@pytest.mark.parametrize("arch", ["deepseek_7b", "granite_moe"])
def test_smoke_train_flops_by_hand(arch):
    """A SMOKE training step without remat: the forward's matrix products
    three times (the forward, and the backward's two products a forward
    product), plus the gather and scatter kernels' own FLOPs."""
    cfg = get_arch(arch).SMOKE
    B, S = 2, 16
    rec = dryrun.count_cell(arch, ShapeCell("t", "train",
                                            dict(seq_len=S, global_batch=B)),
                            ONE, False, _smoke_overrides(arch, remat=False))
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    T = B * S
    layer = 2 * T * d * (2 * hq + 2 * hkv) * dh + 4 * hq * dh * B * S * S
    kernels = 0
    if cfg.moe:
        m = cfg.moe
        C = math.ceil(m.capacity_factor * m.top_k * T / m.num_experts)
        layer += 2 * T * d * m.num_experts + 6 * m.num_experts * C * d * m.d_ff
        # forward: two gathers (2·rows·d each) and the combine's sum
        # (rows·d); backward: a segment sum a gather, a gather the sum
        kernels = cfg.n_layers * 9 * T * m.top_k * d
    else:
        layer += 6 * T * d * cfg.d_ff
    want = 3 * (cfg.n_layers * layer + 2 * T * d * cfg.vocab) + kernels
    assert rec["cost_analysis"]["flops"] == want


@pytest.mark.parametrize("arch,shape,overrides", [
    ("granite_moe", "train_4k", {"n_layers": 3}),
    ("deepseek_7b", "decode_32k", {}),
    ("pna", "ogb_products", {}),
    ("meshgraphnet", "molecule", {}),
    ("schnet", "minibatch_lg", {}),
])
def test_extrapolation_equals_full_count(arch, shape, overrides):
    """For each family with stacked layers, the count extrapolated from
    L = 1 and 2 equals the count of a run at the full depth, exactly."""
    mesh = port_mesh.make_production_mesh()
    rec = dryrun.count_cell(arch, shape, mesh, False, overrides)
    assert rec["cost_extrapolation"]["layers"] > 2
    _, full, arg_bytes = dryrun._measure(arch, shape, mesh, False, overrides)
    chips = 256
    assert rec["cost_analysis"] == {
        "flops": full["flops"] / chips,
        "bytes_accessed": full["bytes_accessed"] / chips}
    assert rec["collectives"]["counts"] == full["counts"]
    for op in dryrun._COLLECTIVES:
        assert rec["collectives"][op] == float(full["collectives"][op])
    assert rec["memory_analysis"]["argument_size_in_bytes"] == arg_bytes
    assert (rec["memory_analysis"]["output_size_in_bytes"]
            == full["output_size_in_bytes"])


MESH_2x4 = GridMesh((2, 4), ("data", "model"), torch.device("meta"))


def _collectives(arch, cell, overrides):
    _, args, _, _ = specs.build_cell(arch, cell, MESH_2x4, False,
                                     overrides=overrides)
    return dryrun.collective_bytes(args)


def test_collective_rules_dense_lm_by_hand():
    """deepseek SMOKE widths, train, batch 4 x 8 tokens on 2 data x 4
    model devices, bfloat16 weights, float32 norms and moments.

    Per-device gradient bytes (rule 1, over data, n = 2: 2·1/2 = 1x):
    embed (160,64) over model 40x64x2 = 5120; ln1, ln2 (2,64) f32 512
    each; wq, wk, wv (2,64,4,16) d_head over model 2x64x4x4x2 = 4096
    each; wo (2,4,16,64) 4096; w_gate, w_up (2,64,172) 2x64x43x2 =
    11008 each; w_down 11008; final_norm 256; lm_head (64,160) 5120:
    60,928 bytes in 12 all-reduces.  Rule 3 (n = 4: 2·3/4 = 1.5x): wo
    and w_down each a (2 sequences, 8, 64) bfloat16 activation = 2048
    bytes, 2 layers, forward and backward: 8 x 1.5 x 2048 = 24,576.
    Rule 2 (zero_spec adds data to each moment's first dimension of 16
    or more that is a multiple of 16; n = 2: 1/2x of the float32 shard
    under the parameter's spec): 10240/2 + 512/2 x 2 + 8192/2 x 4 +
    22016/2 x 3 + 256/2 + 10240/2 = 60,288 a moment, 120,576 for two,
    in 24 all-gathers."""
    ov = _smoke_overrides("deepseek_7b")
    c = _collectives("deepseek_7b", ShapeCell(
        "t", "train", dict(seq_len=8, global_batch=4)), ov)
    assert c["all-reduce"] == 60928 + 24576
    assert c["all-gather"] == 120576
    assert c["counts"] == {"all-gather": 24, "all-reduce": 20,
                           "reduce-scatter": 0, "all-to-all": 0,
                           "collective-permute": 0}
    assert c["total"] == 60928 + 24576 + 120576


def test_collective_rules_expert_moe_by_hand():
    """phi3.5 SMOKE widths (4 experts, top 2, "expert" sharding), prefill
    of 4 x 8 tokens on 2 x 4: T = 32 tokens, C = ceil(1.25·2·32/4) = 20,
    the (4, 20, 64) bfloat16 buffer 10,240 bytes over 2 data shards =
    5,120 a device; rule 4 (n = 4: 3/4x) a dispatch and a combine a layer,
    2 layers: 4 x 3,840 = 15,360; rule 3, wo only: 2 x 1.5 x 2,048 =
    6,144.  No gradient and no moments: a prefill."""
    c = _collectives("phi35_moe", ShapeCell(
        "p", "prefill", dict(seq_len=8, global_batch=4)),
        _smoke_overrides("phi35_moe"))
    assert c["all-to-all"] == 15360 and c["all-reduce"] == 6144
    assert c["all-gather"] == 0
    assert c["counts"]["all-to-all"] == 4 and c["counts"]["all-reduce"] == 2
    # "ffn" sharding: the experts' w_down all-reduces the buffer instead
    ov = _smoke_overrides("phi35_moe")
    ov["moe"] = dataclasses.replace(ov["moe"], expert_sharding="ffn")
    c = _collectives("phi35_moe", ShapeCell(
        "p", "prefill", dict(seq_len=8, global_batch=4)), ov)
    assert c["all-to-all"] == 0
    assert c["all-reduce"] == 6144 + 2 * 1.5 * 5120


def test_collective_rules_recsys_by_hand():
    """DCN-v2 SMOKE widths (26 tables of 500 x 16, MLP 64-32), train,
    batch 16 on 2 x 4: the batch is split over both axes.  Rule 1: each
    table (row-split over model: 125 x 16 x 4 = 8,000 bytes a device) is
    reduced over data (n = 2, 1x); the 10 replicated leaves (cross w
    3 x 429², b 3 x 429, MLP 429x64 and 64x32, final 461x1, user_proj
    461x64: 612,879 floats, 2,451,516 bytes) over all 8 (2·7/8 = 1.75x).
    Rule 2 (n = 2, 1/2x): zero_spec puts data on each table's 16
    columns (4,000 bytes gathered) and on a dimension of 64 of the three
    MLP-like leaves (429x64, 64x32, 461x64: 236,032 bytes, 118,016
    gathered), and on no cross leaf (429 is no multiple of 16): 26 x
    4,000 + 118,016 a moment, for two moments, in 2 x 29 all-gathers."""
    ov = {"mlp_dims": (64, 32), "vocab_sizes": tuple([500] * 26)}
    c = _collectives("dcn_v2", ShapeCell("t", "train", dict(batch=16)), ov)
    replicated = 4 * (3 * (429 * 429 + 429) + 429 * 64 + 64 * 32 + 461
                      + 461 * 64)
    assert replicated == 2451516
    assert c["all-reduce"] == 26 * 8000 + replicated * 1.75
    mlp_gathered = (429 * 64 + 64 * 32 + 461 * 64) * 4 // 2
    assert c["all-gather"] == 2 * (26 * 4000 + mlp_gathered)
    assert c["counts"]["all-reduce"] == 36
    assert c["counts"]["all-gather"] == 2 * (26 + 3)


def test_record_keys_and_files(tmp_path):
    """``run_cell``'s record has the reference's keys and lands where the
    reference's does; a second call reads the file (resumable)."""
    rec = dryrun.run_cell("dcn_v2", "serve_p99", False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    for k in ("meta", "cost_analysis", "collectives", "memory_analysis",
              "roofline", "chips", "mesh", "lower_compile_s"):
        assert k in rec
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "bound_s"}
    assert rec["mesh"] == [16, 16] and rec["chips"] == 256
    assert "error" in rec["memory_analysis"]["temp_size_in_bytes"]
    path = tmp_path / "single" / "dcn_v2__serve_p99.json"
    assert json.loads(path.read_text())["status"] == "ok"
    path.write_text(json.dumps({"status": "ok", "marker": 1}))
    assert dryrun.run_cell("dcn_v2", "serve_p99", False,
                           str(tmp_path))["marker"] == 1


def test_dryrun_and_perf_cli(tmp_path):
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"}
    runs = []
    for jobs in ("1", "2"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "dcn_v2", "--mesh", "both", "--jobs", jobs, "--out",
             str(tmp_path / jobs)],
            env=env, capture_output=True, text=True, timeout=300, check=True)
        runs.append(out.stdout)
    lines = runs[0].strip().splitlines()
    assert lines[-1] == "8/8 cells OK"
    assert lines[0].startswith("[single] dcn_v2") and "dom=" in lines[0]
    assert runs[1] == runs[0]                  # worker processes: the same
    for path in (tmp_path / "1").glob("*/*.json"):
        a = json.loads(path.read_text())
        b = json.loads((tmp_path / "2" / path.parent.name
                        / path.name).read_text())
        a.pop("lower_compile_s"), b.pop("lower_compile_s")
        assert a == b
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--arch", "dcn_v2",
         "--shape", "serve_bulk", "--tag", "t", "--set", "retrieval_dim=32",
         "--baseline-dir", str(tmp_path / "1"), "--out",
         str(tmp_path / "p")],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.startswith("dcn_v2/serve_bulk [t] compute=")
    assert "vs baseline bound=" in out.stdout
    rec = json.loads((tmp_path / "p" / "single"
                      / "dcn_v2__serve_bulk__t.json").read_text())
    assert rec["overrides"] == {"retrieval_dim": 32}


# ----------------------------------------------- the kernels on ``meta``

@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_meta_shape_rule(weighted):
    B, H, R, D = 5, 3, 11, 6
    ids = torch.randint(0, R, (B, H), dtype=torch.int32)
    table = torch.randn(R, D)
    w = torch.rand(B, H) if weighted else None
    want = eb_ref.embedding_bag_ref(ids, table, w)
    with KernelCost() as cost:
        got = embedding_bag(ids.to("meta"), table.to("meta"),
                            None if w is None else w.to("meta"))
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert cost.flops == 2 * B * H * D
    assert cost.bytes == 4 * (B * H * D + B * H * (2 if weighted else 1)
                              + B * D)
    assert cost.calls == {"embedding_bag": 1}
    with KernelCost() as cost:                 # a CPU call records nothing
        cpu = embedding_bag(ids, table, w)
    assert torch.equal(cpu, want)
    assert (cost.flops, cost.bytes, cost.calls) == (0, 0, {})


def test_segment_sum_meta_shape_rule():
    E, D, S = 9, 4, 5
    data = torch.randn(E, D)
    ids = torch.randint(0, S, (E,), dtype=torch.int32)
    want = ss_ref.segment_sum_ref(data, ids, S)
    with KernelCost() as cost:
        got = segment_sum(data.to("meta"), ids.to("meta"), S)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert (cost.flops, cost.bytes) == (E * D, 4 * (E * D + E + S * D))
    with KernelCost() as cost:
        assert torch.equal(segment_sum(data, ids, S), want)
    assert cost.calls == {}


def test_gather_rows_backward_on_meta_takes_the_shape_rules():
    """The autograd Functions' backward reaches the same ``meta`` branch:
    a gather's gradient is a segment sum."""
    table = torch.empty((7, 4), device="meta", requires_grad=True)
    ids = torch.empty((3, 2), dtype=torch.int64, device="meta")
    with KernelCost() as cost:
        rows = L.gather_rows(table, ids)
        (g,) = torch.autograd.grad(rows.sum(), [table])
    assert rows.shape == (3, 2, 4) and g.shape == (7, 4)
    assert cost.calls == {"embedding_bag": 1, "segment_sum": 1}


# ------------------------------------------------------- DCN-v2's draw

def test_dcn_init_draws_on_the_generators_device(monkeypatch):
    """``dcn.init_params`` on another device than the generator's draws
    and scales every leaf on the generator's device, then moves the tree:
    the leaves equal a draw on the generator's device, moved (``cpu:0``
    is another device than the generator's ``cpu`` to the comparison; a
    spy sees where the draw ran).  On ``meta`` it draws nothing."""
    from repro_torch.core.rng import seeded_generator
    from repro_torch.models.recsys import dcn
    cfg = get_arch("dcn_v2").SMOKE
    want = dcn.init_params(seeded_generator(3), cfg)
    real, drew_on = dcn._draw, []

    def spy(generator, cfg, dtype, device):
        drew_on.append(device)
        return real(generator, cfg, dtype, device)
    monkeypatch.setattr(dcn, "_draw", spy)
    g = seeded_generator(3)
    got = dcn.init_params(g, cfg, device="cpu:0")
    assert drew_on == [g.device]
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    state = g.get_state()
    shaped = dcn.init_params(g, cfg, device="meta")
    assert torch.equal(g.get_state(), state)
    assert [(a.shape, a.dtype) for a in leaves(shaped)] == \
        [(a.shape, a.dtype) for a in leaves(want)]
    assert all(a.device.type == "meta" for a in leaves(shaped))
