"""The sharded backend: ``repro_torch.walker.compile(program,
backend="sharded")`` against the reference.

N shards stacked on one device must give the walks of the reference's
single-device engine, and at N = 2 the very stats and emission logs of the
reference's sharded engine (``shard_map`` over two forced host devices, run
in one subprocess: ``tests/test_torch_sharded_reference.py``).  Everything
compared is an integer, so every check is exact, but the trained tables
(``TABLE_TOL``, the embedding tests').

Inputs: the WG stand-in at scale 9, built by each package from the same
seed; 160 starts drawn with numpy; 2 or 8 shards of 16 lanes.
"""
import os
import pathlib
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import walker as ref_walker
from repro.core import router as ref_router
from repro.core.distributed import DistLogs as RefDistLogs
from repro.core.distributed import assemble_paths as ref_assemble_paths
from repro.core.tasks import N2VSlots as RefN2VSlots
from repro.core.tasks import WalkerSlots as RefWalkerSlots
from repro.core.walk_engine import EngineConfig as RefConfig
from repro.core.walk_engine import _run_walks as ref_run_walks
from repro.graph import make_dataset as ref_make_dataset
from repro.graph import partition_graph as ref_partition_graph
from repro.tune import graph_signature as ref_graph_signature
from repro_torch import walker
from repro_torch.core import router
from repro_torch.core.distributed import (DistConfig, DistLogs,
                                          _run_distributed, assemble_paths,
                                          run_distributed)
from repro_torch.core.tasks import N2VSlots, WalkerSlots
from repro_torch.distributed import (Mesh, all_gather, all_to_all, pmax,
                                  psum)
from repro_torch.graph import make_dataset, partition_graph
from repro_torch.tune import graph_signature
from test_torch_stream import soak

REPO = pathlib.Path(__file__).resolve().parents[1]
H = 10                  # hop budget
NUM_STARTS = 160
W_LOC = 16              # lanes a shard
TABLE_TOL = dict(rtol=1e-5, atol=1e-6)
# name -> (WalkProgram builder, its arguments, make_dataset keywords)
PROGRAMS = {
    "urw": ("urw", (), {}),
    "ppr": ("ppr", (0.15,), {}),
    "deepwalk": ("deepwalk", (), dict(weighted=True, with_alias=True)),
    "node2vec": ("node2vec", (2.0, 0.5), {}),
    "node2vec_w": ("node2vec", (2.0, 0.5), dict(weighted=True)),
    "metapath": ("metapath", ([0, 1, 2],), dict(num_edge_types=3)),
}


def program(pkg, name, max_hops=H):
    fn, args, _ = PROGRAMS[name]
    kw = dict(weighted=True) if name == "node2vec_w" else {}
    return getattr(pkg.WalkProgram, fn)(*args, max_hops=max_hops, **kw)


_GRAPHS = {}


def graphs(name):
    """(reference graph, port graph) for a program, built once."""
    kw = PROGRAMS[name][2]
    key = tuple(sorted(kw.items()))
    if key not in _GRAPHS:
        _GRAPHS[key] = (ref_make_dataset("WG", scale_override=9, **kw),
                        make_dataset("WG", scale_override=9, device="cpu",
                                     **kw))
    return _GRAPHS[key]


def starts_of(n=NUM_STARTS, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def sharded(name, n_shards=2, **kw):
    kw = dict(dict(num_devices=n_shards, slots_per_device=W_LOC,
                   log_capacity=1 << 12), **kw)
    return walker.compile(program(walker, name), backend="sharded",
                          execution=walker.ExecutionConfig(**kw))


def ref_single(name, starts, seed=4):
    rg, _ = graphs(name)
    res = ref_run_walks(rg, starts, program(ref_walker, name).spec,
                        RefConfig(num_slots=64, max_hops=H), seed=seed)
    return res.as_numpy()


# ----------------------------------------------------------- partitioning


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["weighted", "typed"])
def test_partition_equals_reference(kind, n_shards):
    """Every array of the partition equals the reference's, dtype too: a
    weighted graph with alias tables, and a typed one."""
    kw = (dict(weighted=True, with_alias=True) if kind == "weighted"
          else dict(num_edge_types=3))
    rg = ref_make_dataset("WG", scale_override=9, **kw)
    g = make_dataset("WG", scale_override=9, device="cpu", **kw)
    want, got = ref_partition_graph(rg, n_shards), partition_graph(g, n_shards)
    for f in ("row_ptr", "col", "weights", "alias_prob", "alias_idx",
              "type_offsets"):
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.numpy().dtype == np.asarray(a).dtype, f
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), f)
    for f in ("num_vertices", "num_devices", "vertices_per_device",
              "max_degree"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.device == g.device
    # The tuner fingerprints a partition as the reference does.
    assert graph_signature(got).token() == ref_graph_signature(want).token()


# ------------------------------------------------------------------ router


def _random_pool(rng, S, word):
    act = rng.random(S) < 0.8
    cols = dict(
        v_curr=rng.integers(0, 100, S), v_prev=rng.integers(-1, 100, S),
        query_id=np.arange(S), hop=rng.integers(0, 9, S), active=act,
        epoch=rng.integers(0, 3, S))
    if word == "n2v":
        cols["phase"] = rng.integers(0, 2, S)
        cols["cand"] = rng.integers(-1, 100, (S, 5))
        fields = N2VSlots._fields
        ref_cls, cls = RefN2VSlots, N2VSlots
    else:
        fields = WalkerSlots._fields
        ref_cls, cls = RefWalkerSlots, WalkerSlots
    cols = {f: (cols[f] if f == "active" else cols[f].astype(np.int32))
            for f in fields}
    return (ref_cls(**{f: jnp.asarray(v) for f, v in cols.items()}),
            cls(**{f: torch.from_numpy(v) for f, v in cols.items()}))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("word", ["walker", "n2v"])
def test_pack_buckets_equals_reference(seed, word):
    """Same random pool, destinations and priorities (many ties): the
    buckets, the retention, waits and drops equal the reference's, field
    for field — lane order included, which decides what is retained."""
    rng = np.random.default_rng(seed)
    S, N, K, R = 96, 4, 8, 20          # R small enough to drop
    ref_slots, slots = _random_pool(rng, S, word)
    dest = rng.integers(0, N, S).astype(np.int32)
    prio = rng.integers(-3, 3, S).astype(np.int32)
    want = ref_router.pack_buckets(ref_slots, jnp.asarray(dest),
                                   jnp.asarray(prio), N, K, R)
    got = router.pack_buckets(slots, torch.from_numpy(dest),
                              torch.from_numpy(prio), N, K, R)
    for part in ("send", "retention"):
        for f, a, b in zip(slots._fields, getattr(got, part),
                           getattr(want, part)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          f"{part}.{f}")
    assert int(got.waits) == int(want.waits)
    assert int(got.drops) == int(want.drops) > 0
    # Stacked shards route as each shard alone.
    stacked = router.pack_buckets(
        type(slots)(*(torch.stack([f, f.flip(0)]) for f in slots)),
        torch.stack([torch.from_numpy(dest), torch.from_numpy(dest).flip(0)]),
        torch.from_numpy(prio), N, K, R)
    for f, a in zip(slots._fields, stacked.send):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(
            getattr(want.send, f)), f)


def test_router_pack_buckets_lossless():
    """Below capacity every live task lands in its destination's bucket or
    in retention, and nothing is lost (the reference's router test)."""
    S, N, K, R = 64, 4, 8, 32
    rng = np.random.default_rng(0)
    slots = WalkerSlots(
        v_curr=torch.from_numpy(rng.integers(0, 100, S).astype(np.int32)),
        v_prev=torch.full((S,), -1, dtype=torch.int32),
        query_id=torch.arange(S, dtype=torch.int32),
        hop=torch.zeros(S, dtype=torch.int32),
        active=torch.from_numpy(rng.random(S) < 0.8),
        epoch=torch.zeros(S, dtype=torch.int32))
    dest = torch.from_numpy(rng.integers(0, N, S).astype(np.int32))
    rr = router.pack_buckets(slots, dest, torch.ones(S, dtype=torch.int32),
                             N, K, R)
    sent, ret = rr.send.query_id.numpy(), rr.retention.query_id.numpy()
    live = set(slots.query_id[slots.active].tolist())
    assert set(sent[sent >= 0]) | set(ret[ret >= 0]) == live
    assert int(rr.drops) == 0
    for b in range(N):
        for q in sent[b * K:(b + 1) * K]:
            if q >= 0:
                assert int(dest[q]) == b


def test_mesh_collectives():
    """psum broadcasts the total; the tiled all-to-all hands shard d the
    d-th bucket of every shard, in shard order."""
    N, K = 3, 2
    x = torch.arange(N * N * K * 2).reshape(N, N * K, 2)
    y = all_to_all(x)
    for d in range(N):
        want = torch.cat([x[s, d * K:(d + 1) * K] for s in range(N)])
        assert torch.equal(y[d], want)
    c = torch.tensor([3, 4, 5])
    assert psum(c).tolist() == [12, 12, 12]
    # The same collectives over shard groups (here 3 groups of 1 and 1 of
    # 3, all on the CPU) give each group its rows of the stacked result.
    for n in (1, 3):
        parts = list(x.split(n))
        for got, want in zip(all_to_all(parts), y.split(n)):
            assert torch.equal(got, want)
        for got in psum(list(c.split(n))):
            assert got.tolist() == [12] * n
        for got in pmax(list(c.split(n))):
            assert got.tolist() == [5] * n
        for got in all_gather(parts):
            assert torch.equal(got, x)


# ------------------------------------------------------------ closed batch


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_closed_batch_equals_single_device_reference(name, n_shards):
    """The §V-A check: routing tasks across N shards leaves every walk of
    the reference's single-device engine as it was, with no drop."""
    _, g = graphs(name)
    starts = starts_of()
    res = sharded(name, n_shards).run(g, starts, seed=4)
    rp, rl = ref_single(name, starts)
    np.testing.assert_array_equal(res.paths.numpy(), rp)
    np.testing.assert_array_equal(res.lengths.numpy(), rl)
    assert int(res.stats.drops) == 0
    assert int(res.stats.steps) == int((rl - 1).sum())
    assert res.paths.device == g.device


def test_assemble_paths_equals_reference():
    """The device scatter of the emission logs gives the reference's host
    scatter of the same logs."""
    _, g = graphs("urw")
    starts = starts_of()
    logs, _ = _run_distributed(partition_graph(g, 4), starts,
                               program(walker, "urw").spec,
                               DistConfig(slots_per_device=W_LOC, max_hops=H,
                                          log_capacity=1 << 12), seed=4)
    want = ref_assemble_paths(
        RefDistLogs(*(jnp.asarray(x.numpy()) for x in logs)), starts, H)
    got = assemble_paths(logs, starts, H)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_deprecated_run_distributed_warns_and_runs():
    _, g = graphs("urw")
    pg = partition_graph(g, 2)
    cfg = DistConfig(slots_per_device=W_LOC, max_hops=H)
    spec = program(walker, "urw").spec
    with pytest.warns(DeprecationWarning, match="run_distributed"):
        logs, stats = run_distributed(pg, starts_of(), spec, cfg, seed=4)
    want, want_stats = _run_distributed(pg, starts_of(), spec, cfg, seed=4)
    assert isinstance(logs, DistLogs)
    for a, b in zip(logs + tuple(stats), want + tuple(want_stats)):
        assert torch.equal(a, b)


def test_sharded_errors_and_warnings():
    rg, g = graphs("urw")
    starts = starts_of(16)
    pg = partition_graph(g, 2)
    with pytest.raises(ValueError, match="type_offsets"):
        walker.compile(program(walker, "metapath"), backend="sharded").run(
            pg, starts)
    with pytest.raises(ValueError, match="alias tables"):
        walker.compile(program(walker, "deepwalk"), backend="sharded").run(
            pg, starts)
    with pytest.raises(ValueError, match="shards"):
        walker.compile(program(walker, "urw"), backend="sharded",
                       mesh=Mesh(3, g.device)).run(pg, starts)
    with pytest.raises(ValueError, match="slots_per_device"):
        walker.ExecutionConfig(slots_per_device=0)
    with pytest.raises(ValueError, match="log_capacity"):
        walker.ExecutionConfig(log_capacity=0)
    with pytest.raises(ValueError, match="retention_factor"):
        DistConfig(retention_factor=0)
    with pytest.warns(RuntimeWarning, match="step_impl='fused'"):
        walker.ExecutionConfig(step_impl="fused").dist_config(
            program(walker, "urw"), 2)
    # A small emission log drops records, and says so.
    tiny = sharded("urw", log_capacity=8)
    with pytest.warns(RuntimeWarning, match="emission log"):
        res = tiny.run(pg, starts, seed=4)
    assert int(res.stats.drops) > 0
    with pytest.warns(RuntimeWarning, match="max_supersteps"):
        sharded("urw", max_supersteps=3).run(pg, starts, seed=4)
    # The mesh's count partitions a CSRGraph; a partition keeps its own.
    w = walker.compile(program(walker, "urw"), backend="sharded",
                       mesh=Mesh(4, g.device),
                       execution=walker.ExecutionConfig(slots_per_device=8))
    assert w.stream(g, capacity=8).graph.num_devices == 4


def test_auto_knobs_resolve_on_a_partition():
    """``num_slots="auto"`` resolves against the partitioned graph and
    gives the default's walks (the reference's
    ``test_auto_resolution_sharded_backend``)."""
    _, g = graphs("urw")
    pg = partition_graph(g, 2)
    starts = np.arange(32, dtype=np.int32) % g.num_vertices
    prog = walker.WalkProgram.urw(6)
    auto = walker.compile(prog, backend="sharded",
                          execution=walker.ExecutionConfig(num_slots="auto"))
    out_auto = auto.run(pg, starts, seed=1)
    out_def = walker.compile(prog, backend="sharded").run(pg, starts, seed=1)
    assert torch.equal(out_auto.paths, out_def.paths)
    assert len(auto._resolved) == 1
    # weighted Node2Vec's adaptive_chunks="auto" resolves there too.
    _, gw = graphs("node2vec_w")
    prog = program(walker, "node2vec_w")
    w = walker.compile(prog, backend="sharded",
                       execution=walker.ExecutionConfig(slots_per_device=16))
    res = w.run(partition_graph(gw, 2), starts, seed=1)
    (p2, _), = w._resolved.values()
    assert p2.spec.adaptive_chunks in (True, False)
    rp, _ = ref_single("node2vec_w", starts, seed=1)
    np.testing.assert_array_equal(res.paths.numpy(), rp)


# ------------------------------------------------------------------ stream


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_stream_midflight_equals_closed_batch(name):
    """Arrivals injected while others are in flight walk as the closed
    batch (the reference's sharded parity test)."""
    _, g = graphs(name)
    starts = starts_of()
    rp, rl = ref_single(name, starts)
    stream = sharded(name).stream(partition_graph(g, 2),
                                  capacity=NUM_STARTS, seed=4)
    stream.inject(starts[:70])
    stream.advance(3)
    stream.inject(starts[70:])
    stream.drain(chunk=7)
    sp, sl = stream.harvest()
    np.testing.assert_array_equal(sp, rp)
    np.testing.assert_array_equal(sl, rl)
    assert stream.walk_stats().drops == 0
    assert stream.num_slots == 2 * W_LOC


@pytest.mark.parametrize("name", ["urw", "node2vec"])
def test_soak_sharded_ring(name):
    """More than 3× capacity queries through a 32-slot ring on 2 shards of
    8 lanes: every (epoch, qid) equals the row of the closed batch under
    ``stream_key(seed, epoch)``, which equals the reference's."""
    _, g = graphs(name)
    pg = partition_graph(g, 2)
    stream = walker.compile(program(walker, name, 8), backend="sharded",
                            execution=walker.ExecutionConfig(
                                slots_per_device=8)).stream(
        pg, capacity=32, seed=11)
    got = soak(stream, g.num_vertices, 100, np.random.default_rng(0))
    assert stream.walk_stats().drops == 0
    by_epoch = {}
    for (e, q), rec in got.items():
        by_epoch.setdefault(e, {})[q] = rec
    assert len(by_epoch) >= 3
    rg, _ = graphs(name)
    from repro.core import rng as ref_rng
    for e, rows in by_epoch.items():
        qs = sorted(rows)
        batch = np.zeros((32,), np.int32)
        for q in qs:
            batch[q] = rows[q][0]
        want = ref_run_walks(rg, batch, program(ref_walker, name, 8).spec,
                             RefConfig(num_slots=16, max_hops=8),
                             seed=ref_rng.stream_key(11, e))
        wp, wl = want.as_numpy()
        for q in qs:
            np.testing.assert_array_equal(rows[q][1], wp[q])
            assert rows[q][2] == wl[q]


def test_stream_reset_and_validation():
    _, g = graphs("urw")
    stream = sharded("urw").stream(partition_graph(g, 2), capacity=16,
                                   seed=0)
    with pytest.raises(ValueError, match="capacity"):
        sharded("urw").stream(g, capacity=0)
    qids, _ = stream.inject(starts_of(10))
    with pytest.raises(RuntimeError, match="live"):
        stream.reset()
    stream.drain()
    first = stream.harvest_ids(qids)
    stream.release(qids)
    stream.reset(seed=0)
    assert stream.walk_stats().supersteps == 0 and stream.num_free == 16
    stream.inject(starts_of(10))
    stream.drain()
    again = stream.harvest_ids(qids)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert stream.host_read_s > 0


# ----------------------------------------------------------------- service


def test_service_requests_equal_closed_batches():
    """A WalkService over the sharded stream returns each request's walks
    equal to its closed batch under stream_key(seed, epoch)."""
    _, g = graphs("deepwalk")
    pg = partition_graph(g, 2)
    svc = sharded("deepwalk").serve(pg, capacity=48, chunk=4, seed=5)
    rng = np.random.default_rng(1)
    sent = []
    for i in range(8):
        sent.append(rng.integers(0, 512, 12).astype(np.int32))
        svc.submit(sent[-1])
        if i % 2:
            svc.step()
    reqs = svc.drain()
    assert [r.request_id for r in reqs] == list(range(8))
    by_epoch = {}    # epoch -> {qid: (start, path, length)}
    for r in reqs:
        for s, q, e, p, n in zip(sent[r.request_id], r.qids, r.epochs,
                                 r.paths, r.lengths):
            by_epoch.setdefault(int(e), {})[int(q)] = (s, p, n)
    assert len(by_epoch) >= 2          # the 48-slot ring wrapped
    closed = walker.compile(program(walker, "deepwalk"))
    from repro_torch.core.rng import stream_key
    for e, rows in by_epoch.items():
        batch = np.zeros((48,), np.int32)
        for q, (s, _, _) in rows.items():
            batch[q] = s
        res = closed.run(g, batch, seed=stream_key(5, e))
        for q, (_, p, n) in rows.items():
            np.testing.assert_array_equal(p, res.paths[q].numpy())
            assert n == int(res.lengths[q])
    assert svc.walk_stats().drops == 0


# ------------------------------------------------------ walks → embeddings


def test_train_embeddings_sharded_equals_single(monkeypatch):
    """The sharded producer's ring equals the single backend's bit for bit
    and its tables equal the single backend's; both are within TABLE_TOL
    of the reference's single backend started from the same tables."""
    from repro.core import rng as ref_rng
    from repro.models import embeddings as ref_emb
    from repro_torch.models import embeddings as emb
    rg, g = graphs("urw")
    kw = dict(seed=3, rounds=2, walks_per_round=16, steps_per_round=6,
              batch_size=32, dim=8, window=3, num_negatives=4)
    want = ref_walker.compile(ref_walker.WalkProgram.urw(H)).train_embeddings(
        rg, **kw, use_kernel=False)
    ref_init = ref_emb.init_params(ref_rng.stream_key(kw["seed"]),
                                   want["config"])
    monkeypatch.setattr(emb, "init_params", lambda gen, cfg, device=None:
                        emb.params_from_reference(ref_init, device))
    single = walker.compile(walker.WalkProgram.urw(H)).train_embeddings(
        g, **kw)
    shard = walker.compile(walker.WalkProgram.urw(H), backend="sharded",
                           execution=walker.ExecutionConfig(
                               num_devices=2)).train_embeddings(g, **kw)
    for a, b, c in zip(shard["ring"], single["ring"], want["ring"]):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    for k in ("in_embed", "out_embed"):
        assert torch.equal(shard["params"][k], single["params"][k])
        np.testing.assert_allclose(shard["params"][k].numpy(),
                                   np.asarray(want["params"][k]),
                                   **TABLE_TOL)
    assert shard["step"] == single["step"] == 12


# ------------------------------------------------------------------- CLIs


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", module, "--device", "cpu", "--scale", "9",
         "--backend", "sharded", *args],
        env=env, capture_output=True, text=True, timeout=300,
        check=True).stdout


def test_walk_cli_sharded():
    out = _cli("repro_torch.launch.walk", "--devices", "4", "--queries",
               "200", "--slots", "64", "--max-hops", "12", "--algo",
               "node2vec")
    assert "route_waits=" in out and "drops=0" in out and "shards=4" in out


def test_walk_serve_cli_sharded():
    out = _cli("repro_torch.launch.walk_serve", "--devices", "2", "--slots",
               "64", "--max-hops", "12", "--requests", "24",
               "--request-size", "8", "--capacity", "512")
    assert "backend=sharded" in out and "drops=0" in out


def test_no_warning_on_the_supported_path():
    _, g = graphs("urw")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sharded("urw").run(partition_graph(g, 2), starts_of(32), seed=0)
