"""The sharded backend with its shards in groups over several devices.

A mesh of N shards over G devices holds G groups of N/G consecutive
shards, group g on ``devices[g]``.  Here every group is on ``cpu`` (a mesh
may name one device G times), so these tests run the grouped code: its
per-group views and pools, the collectives that copy blocks between the
groups, and ``train_embeddings`` fed by a grouped stream, its tables in
row blocks over the groups (``tests/test_torch_split_tables.py`` holds
them at 1, 2 and 4 groups).
Every result must equal the one-group run bit for bit: emission logs,
cursors, every `WalkStats` field, streams, a service point and trained
tables.  The reference's own sharded runs (N = 2 and 4 on as many
devices, ``train_embeddings`` on 2) are held against the groups in
``tests/test_torch_sharded_reference.py`` (its ``ref_sharded`` fixture).

Inputs: the WG stand-in at scale 9; 96 starts drawn with numpy; 4 shards
of 16 lanes; 8 hops.
"""
import numpy as np
import pytest
import torch

from repro_torch import walker
from repro_torch.core import rng as task_rng
from repro_torch.core.distributed import (DistConfig, _run_distributed,
                                          init_dist_stream_state,
                                          inject_stream_queries)
from repro_torch.distributed import Mesh
from repro_torch.graph import partition_graph
from repro_torch.distributed.row_blocks import RowBlocks
from test_torch_sharded import PROGRAMS, W_LOC, graphs, program, starts_of

H = 8
N = 4
NUM_STARTS = 96
CPU = torch.device("cpu")


def mesh(groups, n=N):
    return Mesh(n, [CPU] * groups)


_ONE_GROUP = {}


def closed(name, groups):
    """Logs and per-shard stats of one closed run of ``name`` at N = 4 in
    ``groups`` groups (the one-group run kept for the others)."""
    if groups == 1 and name in _ONE_GROUP:
        return _ONE_GROUP[name]
    _, g = graphs(name)
    pg = partition_graph(g, N, mesh(groups))
    out = _run_distributed(
        pg, starts_of(NUM_STARTS), program(walker, name, H).spec,
        DistConfig(slots_per_device=W_LOC, max_hops=H, log_capacity=1 << 11),
        mesh=mesh(groups), seed=4)
    if groups == 1:
        _ONE_GROUP[name] = out
    return out


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_groups_equal_one_group(name, groups):
    """Every program's emission logs (each entry, -1 fill included), each
    shard's cursor and every per-shard `WalkStats` field at N = 4 in 2 and
    4 groups equal the one-group run's, with no drop."""
    logs, stats = closed(name, groups)
    want_logs, want_stats = closed(name, 1)
    for f, a, b in zip(logs._fields, logs, want_logs):
        assert torch.equal(a, b), f
    for f, a, b in zip(stats._fields, stats, want_stats):
        assert torch.equal(a, b), f
    assert int(stats.drops.sum()) == 0
    assert int(stats.steps.sum()) > 0


def test_placement_on_the_mesh_devices():
    """The partition's arrays, the closed runner's results and the stream
    windows of a 2-group mesh lie on the mesh's devices; the partition's
    numbers do not depend on the grouping; a grouped partition has no one
    device."""
    _, g = graphs("metapath")
    one, two = partition_graph(g, N), partition_graph(g, N, mesh(2))
    assert two.devices == (CPU, CPU)
    assert [grp.first_shard for grp in two.groups] == [0, 2]
    for f in ("row_ptr", "col", "type_offsets"):
        for grp, dev in zip(two.groups, two.devices):
            assert getattr(grp, f).device == dev
            assert getattr(grp, f).shape[0] == 2
        assert torch.equal(torch.cat([getattr(grp, f) for grp in two.groups]),
                           getattr(one, f)), f
    with pytest.raises(ValueError, match="per group"):
        two.row_ptr
    with pytest.raises(ValueError, match="2 devices"):
        two.device
    spec = program(walker, "metapath", H).spec
    cfg = DistConfig(slots_per_device=W_LOC, max_hops=H)
    states = init_dist_stream_state(two, spec, cfg, capacity=32)
    assert len(states) == 2
    for st, dev in zip(states, two.devices):
        for x in (st.ring_qid, st.paths, st.done, st.slots.v_curr,
                  st.stats.steps):
            assert x.device == dev and x.shape[0] == 2


def test_mesh_errors():
    """A mesh naming a device that does not exist raises where it places
    tensors; so does a partition given another mesh's shards, and G that
    does not divide N raises at once."""
    _, g = graphs("urw")
    with pytest.raises(ValueError, match="cuda:7"):
        partition_graph(g, N, Mesh(N, [CPU, torch.device("cuda:7")]))
    with pytest.raises(ValueError, match="cuda:7"):
        walker.compile(program(walker, "urw", H), backend="sharded",
                       mesh=Mesh(N, ["cuda:7"] * 2)).run(g, starts_of(8))
    with pytest.raises(ValueError, match="divide"):
        Mesh(N, [CPU] * 3)
    with pytest.raises(ValueError, match="shards"):
        partition_graph(g, 2, mesh(2))
    # A partition placed on one group does not run under a 2-group mesh.
    with pytest.raises(ValueError, match="places its groups"):
        walker.compile(program(walker, "urw", H), backend="sharded",
                       mesh=mesh(2)).run(partition_graph(g, N), starts_of(8))


@pytest.mark.parametrize("groups", [1, 2])
def test_inject_checks_slot_ids(groups):
    """An arrival's slot id must lie in the ring (its epoch may pass the
    ring's size: a slot recycled that often is still a valid slot)."""
    _, g = graphs("urw")
    pg = partition_graph(g, N, mesh(groups))
    states = init_dist_stream_state(pg, program(walker, "urw", H).spec,
                                    DistConfig(slots_per_device=W_LOC,
                                               max_hops=H), capacity=8)
    block = np.zeros((3, N, 1), np.int64)
    block[1, 0, 0], block[2, 0, 0] = 3, 40      # slot 3 at epoch 40
    inject_stream_queries(states, *block, [1, 0, 0, 0])
    assert sum(int(st.tail.sum()) for st in states) == 1
    block[1, 0, 0] = 8
    with pytest.raises(ValueError, match="slot ids"):
        inject_stream_queries(states, *block, [1, 0, 0, 0])


def test_compile_mesh_and_default():
    """``compile(mesh=)`` partitions a CSRGraph over the mesh's groups and
    gives the one-group walks; with no mesh, a CPU graph takes one group
    (the default mesh rule)."""
    _, g = graphs("node2vec")
    starts = starts_of(NUM_STARTS)
    runs = {}
    for groups in (1, 2):
        w = walker.compile(program(walker, "node2vec", H), backend="sharded",
                           mesh=mesh(groups),
                           execution=walker.ExecutionConfig(
                               slots_per_device=W_LOC))
        runs[groups] = w.run(g, starts, seed=4)
    for a, b in zip(runs[2][:2], runs[1][:2]):
        assert torch.equal(a, b)
    assert [int(x) for x in runs[2].stats] == [int(x) for x in runs[1].stats]
    default = walker.compile(program(walker, "urw", H), backend="sharded",
                             execution=walker.ExecutionConfig(num_devices=4))
    assert default.stream(g, capacity=8).graph.devices == (CPU,)


@pytest.mark.parametrize("name", ["urw", "node2vec_w"])
def test_stream_midflight_in_groups(name):
    """A stream fed mid-flight in 2 groups walks as the closed batch, with
    the one-group stream's stats."""
    _, g = graphs(name)
    starts = starts_of(NUM_STARTS)
    closed_run = walker.compile(program(walker, name, H)).run(g, starts,
                                                              seed=4)
    stats = []
    for groups in (1, 2):
        stream = walker.compile(
            program(walker, name, H), backend="sharded", mesh=mesh(groups),
            execution=walker.ExecutionConfig(slots_per_device=W_LOC)).stream(
                g, capacity=NUM_STARTS, seed=4)
        stream.inject(starts[:40])
        stream.advance(3)
        stream.inject(starts[40:])
        stream.drain(chunk=5)
        sp, sl = stream.harvest()
        np.testing.assert_array_equal(sp, closed_run.paths.numpy())
        np.testing.assert_array_equal(sl, closed_run.lengths.numpy())
        stats.append(stream.walk_stats())
    assert stats[0] == stats[1] and stats[1].drops == 0


def test_service_point_in_groups():
    """A service over a 2-group stream returns each request's walks equal
    to its closed batch under ``stream_key(seed, epoch)`` and the
    one-group service's stats."""
    _, g = graphs("deepwalk")
    rng = np.random.default_rng(2)
    sent = [rng.integers(0, 512, 10).astype(np.int32) for _ in range(6)]
    out = {}
    for groups in (1, 2):
        svc = walker.compile(
            program(walker, "deepwalk", H), backend="sharded",
            mesh=mesh(groups),
            execution=walker.ExecutionConfig(slots_per_device=W_LOC)).serve(
                g, capacity=32, chunk=3, seed=5)
        for i, s in enumerate(sent):
            svc.submit(s)
            if i % 2:
                svc.step()
        out[groups] = (svc.drain(), svc.walk_stats())
    reqs, stats = out[2]
    assert stats == out[1][1] and stats.drops == 0
    closed_w = walker.compile(program(walker, "deepwalk", H))
    for r in reqs:
        for s, q, e, p, n in zip(sent[r.request_id], r.qids, r.epochs,
                                 r.paths, r.lengths):
            batch = np.zeros((32,), np.int32)
            batch[q] = s
            res = closed_w.run(g, batch, seed=task_rng.stream_key(5, int(e)))
            np.testing.assert_array_equal(p, res.paths[q].numpy())
            assert n == int(res.lengths[q])


def test_train_embeddings_in_groups():
    """``train_embeddings`` over a 2-group mesh keeps the ring whole on the
    first group's device and both tables and their moments in row blocks,
    each group's slab (half the rows) on its own device; every slab is
    bit-equal to the matching rows of the one-group run's."""
    _, g = graphs("urw")
    kw = dict(seed=3, rounds=2, walks_per_round=16, steps_per_round=4,
              batch_size=32, dim=8, window=3, num_negatives=4)
    out = {}
    for groups in (1, 2):
        out[groups] = walker.compile(
            program(walker, "urw", H), backend="sharded", mesh=mesh(groups),
            execution=walker.ExecutionConfig(
                slots_per_device=W_LOC)).train_embeddings(g, **kw)
    one, two = out[1], out[2]
    for f in ("paths", "lengths", "tail"):
        got = getattr(two["ring"], f)
        assert got.device == CPU and torch.equal(got, getattr(one["ring"], f))
    rows = g.num_vertices // 2
    for k in ("in_embed", "out_embed"):
        for tree_two, tree_one in ((two["params"], one["params"]),
                                   (two["opt_state"].mu, one["opt_state"].mu),
                                   (two["opt_state"].nu,
                                    one["opt_state"].nu)):
            assert isinstance(tree_two[k], RowBlocks), k
            assert len(tree_two[k].slabs) == 2, k
            for i, (slab, dev) in enumerate(zip(tree_two[k].slabs,
                                                mesh(2).devices)):
                assert slab.device == dev and slab.shape[0] == rows
                assert torch.equal(
                    slab, tree_one[k][i * rows:(i + 1) * rows].to(dev)), k
    assert two["step"] == one["step"] == 8
