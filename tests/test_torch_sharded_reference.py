"""The sharded backend against the reference's own sharded engine, and
its overlapped walks → embeddings pipeline.

The reference's sharded engine runs once for the module (``ref_sharded``:
``shard_map`` over four forced host devices, in one subprocess); at N = 2
and 4 the port's emission logs, per-shard stats, stream stats, service
and ``train_embeddings`` ring must equal its.  Everything compared is an
integer, so every check is exact, but the trained tables (``TABLE_TOL``,
the embedding tests').  The overlapped ``train_embeddings`` on the sharded
backend is held to its serial and resumed runs and to the single backend
bit for bit.

Inputs: the WG stand-in at scale 9, built by each package from the same
seed; 160 starts drawn with numpy; 2 or 4 shards of 16 lanes.
"""
import dataclasses
import glob
import shutil
import threading

import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch import walker
from repro_torch.core.distributed import DistConfig, _run_distributed
from repro_torch.distributed import Mesh
from repro_torch.graph import partition_graph
from repro_torch.distributed.row_blocks import RowBlocks
from repro_torch.serve import HopsController
from test_torch_sharded import (H, NUM_STARTS, PROGRAMS, TABLE_TOL, W_LOC,
                                graphs, program, sharded, starts_of)

# train_embeddings against the reference: 2 rounds of 16 walks, 6 steps.
TRAIN = dict(seed=3, rounds=2, walks_per_round=16, steps_per_round=6,
             batch_size=32, dim=8, window=3, num_negatives=4)
# AdamW as train_embeddings builds it at TRAIN, with a clipping bound
# below every step's norm (0.076-0.107 there): each step clips.
CLIP = dict(lr=1e-2, warmup_steps=1, total_steps=12, grad_clip=0.02)
# The clipped run's moments against the reference's, whose clipping scale
# and update XLA computes in its own order: measured 1.0e-10 absolute at
# most in mu (its entries up to 8.1e-4), 3.4e-13 in nu (up to 1.7e-6).
MOMENT_TOL = dict(rtol=1e-4, atol=1e-9)


# ------------------------------------- against the reference's sharded engine


REF_SHARDED = r"""
import dataclasses, sys
import numpy as np
from repro import walker
from repro.core.distributed import DistConfig, _run_distributed
from repro.graph import make_dataset, partition_graph
from repro.core import rng as ref_rng
from repro.models import embeddings as ref_emb
from repro.optim import adamw as ref_adamw
from repro.serve import HopsController

H, W_LOC = {H}, {W_LOC}
PROGRAMS = {PROGRAMS}
TRAIN = {TRAIN}
CLIP = {CLIP}
out = {{}}


def program(name, max_hops=H):
    fn, args, _ = PROGRAMS[name]
    kw = dict(weighted=True) if name == "node2vec_w" else {{}}
    return getattr(walker.WalkProgram, fn)(*args, max_hops=max_hops, **kw)


starts = np.random.default_rng(0).integers(0, 512, {NUM_STARTS}).astype(
    np.int32)
for name, (_, _, kw) in PROGRAMS.items():
    g = make_dataset("WG", scale_override=9, **kw)
    for n, tag in ((4, "4"), (2, "")):      # N shards on devices[:N]
        pg = partition_graph(g, n)
        logs, stats = _run_distributed(
            pg, starts, program(name).spec,
            DistConfig(slots_per_device=W_LOC, max_hops=H,
                       log_capacity=1 << 12),
            seed=4)
        for f in logs._fields:
            out[f"{{name}}.log{{tag}}.{{f}}"] = np.asarray(getattr(logs, f))
        for f in stats._fields:
            out[f"{{name}}.stats{{tag}}.{{f}}"] = np.asarray(
                getattr(stats, f))
    stream = walker.compile(
        program(name), backend="sharded",
        execution=walker.ExecutionConfig(slots_per_device=W_LOC)).stream(
            pg, capacity=len(starts), seed=4)
    stream.inject(starts[:70])
    stream.advance(3)
    stream.inject(starts[70:])
    stream.drain(chunk=7)
    out[f"{{name}}.stream.stats"] = np.asarray(stream.walk_stats())

pg = partition_graph(make_dataset("WG", scale_override=9), 2)
svc = walker.compile(walker.WalkProgram.urw(12), backend="sharded",
                     execution=walker.ExecutionConfig(
                         slots_per_device=32)).serve(
    pg, seed=0, chunk=2, adapt=True,
    controller=HopsController(min_chunk=1, max_chunk=32, patience=2))
rng = np.random.default_rng(0)
for _ in range(12):
    svc.submit(rng.integers(0, 512, size=48).astype(np.int32))
    svc.step()
for r in svc.drain():
    for f in ("qids", "epochs", "paths", "lengths", "submitted_at",
              "admitted_at", "completed_at"):
        out[f"svc.{{r.request_id}}.{{f}}"] = np.asarray(getattr(r, f))
out["svc.adapt_num"] = np.asarray(
    [dataclasses.astuple(e)[:5] for e in svc.adaptation], np.float64)
out["svc.adapt_reason"] = np.asarray([e.reason for e in svc.adaptation])
out["svc.chunk"] = np.asarray(svc.chunk)
out["svc.stats"] = np.asarray(svc.walk_stats())

# train_embeddings on a 2-device mesh: the ring's rows and both tables
# (with their moments) sharded over the devices.
te = walker.compile(walker.WalkProgram.urw(H), backend="sharded",
                    execution=walker.ExecutionConfig(
                        num_devices=2)).train_embeddings(
    make_dataset("WG", scale_override=9), **TRAIN, use_kernel=False)
init = ref_emb.init_params(ref_rng.stream_key(TRAIN["seed"]), te["config"])
for k in ("in_embed", "out_embed"):
    out[f"te.init.{{k}}"] = np.asarray(init[k])
    out[f"te.params.{{k}}"] = np.asarray(te["params"][k])
for f in ("paths", "lengths", "tail"):
    out[f"te.ring.{{f}}"] = np.asarray(getattr(te["ring"], f))
out["te.step"] = np.asarray(te["step"])
# The same run with every step clipped: tables and moments.
te = walker.compile(walker.WalkProgram.urw(H), backend="sharded",
                    execution=walker.ExecutionConfig(
                        num_devices=2)).train_embeddings(
    make_dataset("WG", scale_override=9), **TRAIN, use_kernel=False,
    opt_cfg=ref_adamw.AdamWConfig(**CLIP))
for k in ("in_embed", "out_embed"):
    out[f"te_clip.params.{{k}}"] = np.asarray(te["params"][k])
    out[f"te_clip.mu.{{k}}"] = np.asarray(te["opt_state"].mu[k])
    out[f"te_clip.nu.{{k}}"] = np.asarray(te["opt_state"].nu[k])
np.savez(sys.argv[1] if len(sys.argv) > 1 else "{PATH}", **out)
print("REF_SHARDED_OK")
"""


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's sharded engine on four forced host devices (N
    shards on the first N): closed logs and stats at N = 2 and 4,
    mid-flight streams, an adaptive service and ``train_embeddings`` on 2
    devices, with and without clipping (one subprocess for the whole
    module)."""
    path = tmp_path_factory.mktemp("ref_sharded") / "ref.npz"
    code = REF_SHARDED.format(H=H, W_LOC=W_LOC, NUM_STARTS=NUM_STARTS,
                              PROGRAMS=repr(PROGRAMS), TRAIN=repr(TRAIN),
                              CLIP=repr(CLIP), PATH=str(path))
    out = run_in_subprocess(code, devices=4, timeout=900)
    assert "REF_SHARDED_OK" in out
    return dict(np.load(path))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_logs_and_stats_equal_reference_sharded(ref_sharded, name):
    """At N = 2 the emission logs (every entry, -1 fill included, each
    shard's cursor) and the per-shard WalkStats equal the reference's
    sharded engine's; so do the stream's folded stats."""
    _, g = graphs(name)
    logs, stats = _run_distributed(
        partition_graph(g, 2), starts_of(), program(walker, name).spec,
        DistConfig(slots_per_device=W_LOC, max_hops=H, log_capacity=1 << 12),
        seed=4)
    for f in logs._fields:
        np.testing.assert_array_equal(getattr(logs, f).numpy(),
                                      ref_sharded[f"{name}.log.{f}"], f)
    for f in stats._fields:
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      ref_sharded[f"{name}.stats.{f}"], f)
    stream = sharded(name).stream(partition_graph(g, 2),
                                  capacity=NUM_STARTS, seed=4)
    starts = starts_of()
    stream.inject(starts[:70])
    stream.advance(3)
    stream.inject(starts[70:])
    stream.drain(chunk=7)
    np.testing.assert_array_equal(np.asarray(stream.walk_stats()),
                                  ref_sharded[f"{name}.stream.stats"])


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_groups_equal_reference_sharded(ref_sharded, name):
    """N = 2 shards in 2 groups (one shard a group, both on the CPU, the
    reference's one shard a device) give the reference's emission logs,
    per-shard stats and stream stats."""
    _, g = graphs(name)
    mesh = Mesh(2, [g.device] * 2)
    logs, stats = _run_distributed(
        partition_graph(g, 2, mesh), starts_of(), program(walker, name).spec,
        DistConfig(slots_per_device=W_LOC, max_hops=H, log_capacity=1 << 12),
        mesh=mesh, seed=4)
    for f in logs._fields:
        np.testing.assert_array_equal(getattr(logs, f).numpy(),
                                      ref_sharded[f"{name}.log.{f}"], f)
    for f in stats._fields:
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      ref_sharded[f"{name}.stats.{f}"], f)
    stream = walker.compile(
        program(walker, name), backend="sharded", mesh=mesh,
        execution=walker.ExecutionConfig(slots_per_device=W_LOC)).stream(
            g, capacity=NUM_STARTS, seed=4)
    starts = starts_of()
    stream.inject(starts[:70])
    stream.advance(3)
    stream.inject(starts[70:])
    stream.drain(chunk=7)
    np.testing.assert_array_equal(np.asarray(stream.walk_stats()),
                                  ref_sharded[f"{name}.stream.stats"])


@pytest.mark.slow
@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_groups_of_four_equal_reference_sharded(ref_sharded, name, groups):
    """N = 4 shards in 2 and 4 groups (all on the CPU; the reference's one
    shard a device on 4 devices) give the reference's emission logs and
    per-shard stats."""
    _, g = graphs(name)
    mesh = Mesh(4, [g.device] * groups)
    logs, stats = _run_distributed(
        partition_graph(g, 4, mesh), starts_of(), program(walker, name).spec,
        DistConfig(slots_per_device=W_LOC, max_hops=H, log_capacity=1 << 12),
        mesh=mesh, seed=4)
    for f in logs._fields:
        np.testing.assert_array_equal(getattr(logs, f).numpy(),
                                      ref_sharded[f"{name}.log4.{f}"], f)
    for f in stats._fields:
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      ref_sharded[f"{name}.stats4.{f}"], f)


@pytest.mark.slow
def test_train_embeddings_in_groups_equal_reference_sharded(ref_sharded,
                                                            monkeypatch):
    """``train_embeddings`` over 2 groups (both on the CPU) from the
    reference's initial tables: the ring equals the reference's 2-device
    run bit for bit, and the tables, in row blocks over the 2 groups as
    the reference's are vocab-sharded over its 2 devices, are within
    TABLE_TOL of its tables."""
    from repro_torch.models import embeddings as emb
    _, g = graphs("urw")
    init = {k: ref_sharded[f"te.init.{k}"] for k in ("in_embed", "out_embed")}
    monkeypatch.setattr(emb, "init_params", lambda gen, cfg, device=None:
                        emb.params_from_reference(init, device))
    got = walker.compile(walker.WalkProgram.urw(H), backend="sharded",
                         mesh=Mesh(2, [g.device] * 2)).train_embeddings(
        g, **TRAIN)
    for f in ("paths", "lengths", "tail"):
        np.testing.assert_array_equal(getattr(got["ring"], f).numpy(),
                                      ref_sharded[f"te.ring.{f}"], f)
    for k in ("in_embed", "out_embed"):
        assert isinstance(got["params"][k], RowBlocks), k
        np.testing.assert_allclose(got["params"][k].whole("cpu").numpy(),
                                   ref_sharded[f"te.params.{k}"],
                                   **TABLE_TOL)
    assert got["step"] == int(ref_sharded["te.step"]) == 12


@pytest.mark.slow
def test_clipped_train_embeddings_in_groups_equal_reference_sharded(
        ref_sharded, monkeypatch):
    """As above with a ``grad_clip`` below every step's norm: the 2 groups'
    tables (norm by shard block) within TABLE_TOL of the reference's
    vocab-sharded tables, and their moments within MOMENT_TOL; every
    step clipped."""
    from repro_torch.models import embeddings as emb
    from repro_torch.optim import adamw
    _, g = graphs("urw")
    init = {k: ref_sharded[f"te.init.{k}"] for k in ("in_embed", "out_embed")}
    monkeypatch.setattr(emb, "init_params", lambda gen, cfg, device=None:
                        emb.params_from_reference(init, device))
    got = walker.compile(walker.WalkProgram.urw(H), backend="sharded",
                         mesh=Mesh(2, [g.device] * 2)).train_embeddings(
        g, **TRAIN, opt_cfg=adamw.AdamWConfig(**CLIP), log_every=1)
    assert all(h["grad_norm"] > CLIP["grad_clip"] for h in got["history"])
    for k in ("in_embed", "out_embed"):
        for t, x, tol in (
                ("params", got["params"][k], TABLE_TOL),
                ("mu", got["opt_state"].mu[k], MOMENT_TOL),
                ("nu", got["opt_state"].nu[k], MOMENT_TOL)):
            assert isinstance(x, RowBlocks), (t, k)
            np.testing.assert_allclose(x.whole("cpu").numpy(),
                                       ref_sharded[f"te_clip.{t}.{k}"],
                                       **tol, err_msg=f"{t}.{k}")


@pytest.mark.slow
def test_service_equals_reference_sharded(ref_sharded):
    """An adaptive service over the sharded stream: every request's walks
    and clocks, the adaptation trace, the final chunk and the stats equal
    the reference's sharded service."""
    _, g = graphs("urw")
    svc = walker.compile(walker.WalkProgram.urw(12), backend="sharded",
                         execution=walker.ExecutionConfig(
                             slots_per_device=32)).serve(
        partition_graph(g, 2), seed=0, chunk=2, adapt=True,
        controller=HopsController(min_chunk=1, max_chunk=32, patience=2))
    rng = np.random.default_rng(0)
    for _ in range(12):
        svc.submit(rng.integers(0, 512, size=48).astype(np.int32))
        svc.step()
    reqs = svc.drain()
    assert len(reqs) == 12
    for r in reqs:
        for f in ("qids", "epochs", "paths", "lengths", "submitted_at",
                  "admitted_at", "completed_at"):
            np.testing.assert_array_equal(
                np.asarray(getattr(r, f)),
                ref_sharded[f"svc.{r.request_id}.{f}"], f)
    assert svc.adaptation, "the overloaded service did not adapt"
    np.testing.assert_array_equal(
        np.asarray([dataclasses.astuple(e)[:5] for e in svc.adaptation],
                   np.float64), ref_sharded["svc.adapt_num"])
    assert ([e.reason for e in svc.adaptation]
            == list(ref_sharded["svc.adapt_reason"]))
    assert svc.chunk == int(ref_sharded["svc.chunk"])
    np.testing.assert_array_equal(np.asarray(svc.walk_stats()),
                                  ref_sharded["svc.stats"])




# ------------------------------------------------ the overlapped pipeline


def _whole(x):
    return x.whole("cpu") if isinstance(x, RowBlocks) else x


def _same_training(a, b) -> None:
    assert a["step"] == b["step"]
    for k in ("in_embed", "out_embed"):
        for x, y in ((a["params"][k], b["params"][k]),
                     (a["opt_state"].mu[k], b["opt_state"].mu[k]),
                     (a["opt_state"].nu[k], b["opt_state"].nu[k])):
            assert torch.equal(_whole(x), _whole(y))
    for x, y in zip(a["ring"], b["ring"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("groups", [1, 2])
def test_overlapped_sharded_training_equals_serial_resumed_and_single(
        groups, tmp_path):
    """The sharded producer on its own thread (inject, drain, harvest and
    release there): the overlapped run equals the serial one, one resumed
    from a checkpoint inside round 0 (round 1 in flight) and the single
    backend's, in tables, moments and ring; in 1 and 2 groups."""
    _, g = graphs("urw")
    w = walker.compile(walker.WalkProgram.urw(H), backend="sharded",
                       mesh=Mesh(2, [g.device] * groups))
    before = threading.active_count()
    over = w.train_embeddings(g, **TRAIN)
    ser = w.train_embeddings(g, **TRAIN, overlap=False)
    ckpt = str(tmp_path / "ckpt")
    w.train_embeddings(g, **TRAIN, ckpt_dir=ckpt, ckpt_every=3)
    for p in glob.glob(ckpt + "/step_*"):
        if int(p.rsplit("_", 1)[1]) > 3:
            shutil.rmtree(p)
    res = w.train_embeddings(g, **TRAIN, ckpt_dir=ckpt, ckpt_every=3)
    single = walker.compile(walker.WalkProgram.urw(H)).train_embeddings(
        g, **TRAIN)
    assert threading.active_count() == before
    assert over["step"] == 12
    for out in (ser, res, single):
        _same_training(out, over)
