"""The SGNS tables and their AdamW moments in row blocks over the shard
groups' devices, as the reference's vocab-sharded ``train_embeddings``
lays them out (``NamedSharding(mesh, P(ax, None))``).

With N shards dividing |V|, shard i owns rows ``[i·|V|/N, (i+1)·|V|/N)``
and group g's device one slab of its shards' rows
(``distributed.row_blocks.RowBlocks``).  The split gather must give the rows
of ``gather_rows`` on the joined table, and every slab's gradient the
matching rows of the whole table's gradient, bit for bit; training in 1,
2 and 4 groups must give the same ring, tables, moments and step bit for
bit, clipping or not, and the single backend's when no step clips.
Every group lies on ``cpu`` here, as in ``tests/test_torch_multicard.py``
(a mesh may name one device G times), so the grouped code runs with each
slab a tensor of its own.

Inputs: the WG stand-in at scale 9 (|V| = 512), built once; ids and
upstream gradients drawn with numpy; 4 shards; dim 8.  JAX is imported
only by the test that uses it, so the card's case collects without it.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch import walker
from repro_torch.distributed import Mesh
from repro_torch.graph import make_dataset
from repro_torch.models import embeddings as emb
from repro_torch.models import layers
from repro_torch.distributed.row_blocks import RowBlocks
from repro_torch.optim import adamw

CPU = torch.device("cpu")
N = 4
H = 8
KW = dict(seed=3, rounds=2, walks_per_round=16, steps_per_round=4,
          batch_size=32, dim=8, window=3, num_negatives=4, log_every=1)
# A clipping bound below every step's norm (0.078-0.098 at KW): each
# step clips.
CLIP = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=8,
                         grad_clip=0.02)
# Clipped runs against the single backend, whose norm is one torch.sum
# over each table: the clipping scale differs by a few ulps, which Adam's
# m / sqrt(v) all but cancels in the tables (measured 1.5e-8 at most) and
# carries into the moments relative to their size (2.5e-5 of an entry,
# 3e-11 absolute at most).
CLIPPED_TABLES = dict(rtol=1e-6, atol=1e-7)
CLIPPED_MOMENTS = dict(rtol=1e-4, atol=1e-10)

_GRAPH = []


def graph():
    if not _GRAPH:
        _GRAPH.append(make_dataset("WG", scale_override=9, device="cpu"))
    return _GRAPH[0]


def sharded(groups, n=N):
    return walker.compile(walker.WalkProgram.urw(H), backend="sharded",
                          mesh=Mesh(n, [CPU] * groups),
                          execution=walker.ExecutionConfig(
                              slots_per_device=16))


_RUNS = {}


def train(groups, opt_cfg=None):
    """``train_embeddings`` at KW in ``groups`` groups (``"single"``: the
    single backend), kept for the other tests."""
    key = (groups, opt_cfg)
    if key not in _RUNS:
        w = (walker.compile(walker.WalkProgram.urw(H)) if groups == "single"
             else sharded(groups))
        _RUNS[key] = w.train_embeddings(graph(), **KW, opt_cfg=opt_cfg)
    return _RUNS[key]


def whole(x):
    return x.whole(CPU) if isinstance(x, RowBlocks) else x


def trees(out):
    """(name, tensor or row blocks) of both tables and both moments."""
    return [(f"{t}.{k}", tree[k]) for k in ("in_embed", "out_embed")
            for t, tree in (("params", out["params"]),
                            ("mu", out["opt_state"].mu),
                            ("nu", out["opt_state"].nu))]


def assert_same_training(a, b) -> None:
    assert a["step"] == b["step"]
    assert torch.equal(a["opt_state"].step, b["opt_state"].step)
    for x, y in zip(a["ring"], b["ring"]):
        assert torch.equal(x, y)
    for (name, x), (_, y) in zip(trees(a), trees(b)):
        assert torch.equal(whole(x).cpu(), whole(y).cpu()), name


# ------------------------------------------------------- the split gather


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_split_gather_equals_whole_table(groups, monkeypatch):
    """The split gather's rows equal ``gather_rows`` on the joined table and
    the reference's ``jnp.take`` bit for bit, and every slab's gradient
    the matching rows of the whole table's; hub ids repeat across
    owners, one slab no id reaches launches nothing, an id out of range
    is clamped forward and dropped backward as on the whole table."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    rows, dim = 512, 8
    table = torch.from_numpy(rng.normal(size=(rows, dim)).astype(np.float32))
    # Hubs at the start of slab 0 and of slab 1 (of 2 or 4); no id in the
    # last quarter of the rows, so at G = 4 slab 3 is not reached.
    hubs = np.array([0, 3, 256, 300], np.int32)
    ids = np.concatenate([rng.choice(hubs, 40),
                          rng.integers(0, 3 * rows // 4, 40)]).astype(
        np.int32)
    rng.shuffle(ids)
    ids = ids.reshape(8, 10)
    up = torch.from_numpy(rng.normal(size=(8, 10, dim)).astype(np.float32))

    whole_t = table.clone().requires_grad_(True)
    want = layers.gather_rows(whole_t, torch.from_numpy(ids))
    (want_grad,) = torch.autograd.grad(want, whole_t, up)

    calls = {"embedding_bag": [], "segment_sum": []}
    real_bag, real_sum = layers.embedding_bag, layers.segment_sum

    def bag(i, t):
        calls["embedding_bag"].append(t.shape[0])
        return real_bag(i, t)

    def seg(d, i, s):
        calls["segment_sum"].append(s)
        return real_sum(d, i, s)
    monkeypatch.setattr(layers, "embedding_bag", bag)
    monkeypatch.setattr(layers, "segment_sum", seg)
    blocks = RowBlocks.split(table, [CPU] * groups, N).map(
        lambda s: s.requires_grad_(True))
    got = layers.gather_rows(blocks, torch.from_numpy(ids))
    grads = torch.autograd.grad(got, list(blocks.slabs), up)

    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.detach().numpy(), np.asarray(jnp.take(jnp.asarray(table.numpy()),
                                                  jnp.asarray(ids), axis=0)))
    per = rows // groups
    for gi, g in enumerate(grads):
        assert g.shape == (per, dim)
        assert torch.equal(g, want_grad[gi * per:(gi + 1) * per]), gi
    reached = groups - (groups == 4)
    assert calls == {"embedding_bag": [per] * reached,
                     "segment_sum": [per] * reached}
    if groups == 4:
        assert not grads[3].any()
    # The reference's gradient of the same gather (an XLA scatter-add,
    # which adds in an order of its own).
    ref_grad = jax.grad(lambda t: jnp.sum(
        jnp.take(t, jnp.asarray(ids), axis=0) * jnp.asarray(up.numpy())))(
        jnp.asarray(table.numpy()))
    np.testing.assert_allclose(torch.cat(grads).numpy(),
                               np.asarray(ref_grad), rtol=1e-6, atol=1e-6)

    odd = torch.tensor([-3, 0, rows + 5, rows - 1], dtype=torch.int32)
    w2 = table.clone().requires_grad_(True)
    want = layers.gather_rows(w2, odd)
    (want_grad,) = torch.autograd.grad(want, w2, up[0, :4])
    b2 = RowBlocks.split(table, [CPU] * groups, N).map(
        lambda s: s.requires_grad_(True))
    got = layers.gather_rows(b2, odd)
    grads = torch.autograd.grad(got, list(b2.slabs), up[0, :4])
    assert torch.equal(got, want)
    assert torch.equal(torch.cat(grads), want_grad)


def test_row_blocks_layout():
    """``RowBlocks.split`` copies each group's contiguous shard rows into one
    slab on its device; ``owner`` names the slab of each row id (ids out
    of range the first or last); ``shard_blocks`` are the N shards in
    order; ``whole`` joins a copy; ``like`` splits a table into the
    layout; a layout that does not divide raises."""
    t = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
    b = RowBlocks.split(t, [CPU, CPU], 8)
    assert [s.shape for s in b.slabs] == [(32, 3), (32, 3)]
    assert b.shape == (64, 3) and b.devices == (CPU, CPU)
    assert all(s.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
               for s in b.slabs)
    ids = torch.tensor([-3, 0, 31, 32, 63, 64, 90], dtype=torch.int32)
    assert b.owner(ids).tolist() == [0, 0, 0, 1, 1, 1, 1]
    assert RowBlocks.split(t, [CPU] * 4, 8).owner(ids).tolist() == \
        [0, 0, 1, 2, 3, 3, 3]
    assert torch.equal(torch.cat(b.shard_blocks()), t)
    assert [blk.shape[0] for blk in b.shard_blocks()] == [8] * 8
    assert torch.equal(b.whole(), t)
    assert torch.equal(b.like(t * 2).whole(), t * 2)
    with pytest.raises(ValueError):
        RowBlocks.split(t, [CPU] * 3, 6)
    with pytest.raises(ValueError):
        RowBlocks.split(t[:60], [CPU] * 2, 8)


def test_adamw_on_row_blocks():
    """``apply_updates`` on row blocks: tables and moments equal the whole
    tree's update bit for bit when the step does not clip; the norm is the
    sum over leaves of the N shard blocks' squared sums in shard order,
    the same bits in 1, 2 and 4 groups."""
    rng = np.random.default_rng(3)
    shapes = {"in_embed": (64, 4), "out_embed": (64, 4)}
    p0 = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for k, s in shapes.items()}
    g0 = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 1e-3)
          for k, s in shapes.items()}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    want_p = {k: v.clone() for k, v in p0.items()}
    want_s = adamw.init_state(want_p)
    for _ in range(3):
        want_p, want_s, want_stats = adamw.apply_updates(want_p, g0, want_s,
                                                         cfg)
    total = 0
    for k in sorted(shapes):
        leaf = None
        for blk in g0[k].chunk(N):
            part = torch.sum(torch.square(blk))
            leaf = part if leaf is None else leaf + part
        total = total + leaf
    norm = torch.sqrt(total)
    norms = []
    for G in (1, 2, 4):
        p = {k: RowBlocks.split(v, [CPU] * G, N) for k, v in p0.items()}
        g = {k: RowBlocks.split(v, [CPU] * G, N) for k, v in g0.items()}
        s = adamw.init_state(p)
        assert all(isinstance(s.mu[k], RowBlocks) for k in shapes)
        for _ in range(3):
            p, s, stats = adamw.apply_updates(p, g, s, cfg)
        norms.append(stats["grad_norm"])
        assert int(s.step) == 3
        for k in shapes:
            assert torch.equal(p[k].whole(), want_p[k]), k
            assert torch.equal(s.mu[k].whole(), want_s.mu[k]), k
            assert torch.equal(s.nu[k].whole(), want_s.nu[k]), k
    assert torch.equal(norms[0], norms[1]) and torch.equal(norms[0], norms[2])
    assert torch.equal(norms[0], norm)
    assert float(norms[0]) < cfg.grad_clip
    torch.testing.assert_close(norms[0], want_stats["grad_norm"], rtol=1e-6,
                               atol=0)


# ----------------------------------------------------------- training


@pytest.mark.parametrize("groups", [2, 4])
def test_split_training_equals_one_group_and_single(groups, monkeypatch):
    """``train_embeddings`` in 2 and 4 groups: each group holds only its
    slab of both tables and both moments (|V|/G rows), nothing joins the
    slabs while it trains, and ring, tables, moments and step equal one
    group's and the single backend's bit for bit; no step clipped."""
    one, single = train(1), train("single")
    # The one-group run returns plain tensors; its slab is the table.
    for name, x in trees(one):
        assert isinstance(x, torch.Tensor) and x.shape == (512, 8), name

    def joined(self, device=None):
        raise AssertionError("a step joined the slabs")
    monkeypatch.setattr(RowBlocks, "whole", joined)
    out = train(groups)
    monkeypatch.undo()
    for name, x in trees(out):
        assert isinstance(x, RowBlocks), name
        assert x.devices == (CPU,) * groups and x.shards == N
        assert [tuple(s.shape) for s in x.slabs] == [(512 // groups, 8)] \
            * groups
    assert out["opt_state"].step.device == out["ring"].paths.device == CPU
    assert_same_training(out, one)
    assert_same_training(one, single)
    for run in (one, out):
        norms = [h["grad_norm"] for h in run["history"]]
        assert len(norms) == 8 and max(norms) < 1.0
    assert [h["grad_norm"] for h in out["history"]] == \
        [h["grad_norm"] for h in one["history"]]


def test_clipped_training_equal_across_groups():
    """With a ``grad_clip`` below every step's norm, runs in 1, 2 and 4
    groups are bit-equal to each other, and within CLIPPED_TABLES and
    CLIPPED_MOMENTS of the single backend (whose norm sums each whole
    table at once); every step clipped."""
    runs = {G: train(G, CLIP) for G in (1, 2, 4)}
    for G in (2, 4):
        assert_same_training(runs[G], runs[1])
    for G, run in runs.items():
        assert all(h["grad_norm"] > CLIP.grad_clip for h in run["history"])
    single = train("single", CLIP)
    for x, y in zip(single["ring"], runs[1]["ring"]):
        assert torch.equal(x, y)
    for (name, x), (_, y) in zip(trees(runs[1]), trees(single)):
        tol = CLIPPED_TABLES if name.startswith("params") else CLIPPED_MOMENTS
        np.testing.assert_allclose(x.numpy(), y.numpy(), **tol,
                                   err_msg=name)


def test_checkpoint_resumes_across_groups(tmp_path):
    """A checkpoint written at 2 groups (one leaf a table, joined on the
    host) resumes at 1 and at 4 groups bit-equal to the run that was not
    stopped; the resumed run's slabs lie in its own layout."""
    ckpt = tmp_path / "g2"
    sharded(2).train_embeddings(graph(), **KW, ckpt_dir=str(ckpt),
                                ckpt_every=3)
    for p in ckpt.glob("step_*"):
        if int(p.name.split("_")[1]) > 3:
            shutil.rmtree(p)
    for G in (1, 4):
        d = tmp_path / f"resume{G}"
        shutil.copytree(ckpt, d)
        res = sharded(G).train_embeddings(graph(), **KW, ckpt_dir=str(d),
                                          ckpt_every=3)
        assert_same_training(res, train(1))
        want = (torch.Tensor,) if G == 1 else (RowBlocks,)
        assert all(isinstance(x, want) for _, x in trees(res))


def test_tables_whole_when_shards_do_not_divide():
    """N = 3 shards in 3 groups do not divide |V| = 512: the tables and
    moments stay whole tensors on the first group's device, as the
    reference leaves them, and equal the one-group run's."""
    out = sharded(3, n=3).train_embeddings(graph(), **KW)
    for name, x in trees(out):
        assert isinstance(x, torch.Tensor) and x.shape == (512, 8), name
        assert x.device == CPU
    assert_same_training(out, sharded(1, n=3).train_embeddings(graph(), **KW))


def test_reference_tables_and_moments_place_on_slabs():
    """``params_from_reference`` and ``opt_state_from_reference`` given a
    mesh put each table and moment in its row blocks, the step on the
    first group's device; ``init_params`` on a mesh splits the tables it
    draws on the generator's device, the same numbers as unsplit."""
    rng = np.random.default_rng(0)
    ref = {k: rng.normal(size=(64, 4)).astype(np.float32)
           for k in ("in_embed", "out_embed")}
    mesh = Mesh(N, [CPU] * 2)
    p = emb.params_from_reference(ref, mesh)
    for k, v in ref.items():
        assert isinstance(p[k], RowBlocks) and len(p[k].slabs) == 2
        np.testing.assert_array_equal(p[k].whole().numpy(), v)
    state = adamw.AdamWState(step=np.int32(5), mu=ref, nu=ref)
    s = emb.opt_state_from_reference(state, mesh)
    assert int(s.step) == 5 and s.step.device == CPU
    for k, v in ref.items():
        assert isinstance(s.mu[k], RowBlocks)
        np.testing.assert_array_equal(s.nu[k].whole().numpy(), v)
    cfg = emb.SkipGramConfig(num_vertices=64, dim=4)
    from repro_torch.core.rng import seeded_generator
    split = emb.init_params(seeded_generator(1), cfg, device=mesh)
    plain = emb.init_params(seeded_generator(1), cfg)
    for k in plain:
        assert torch.equal(split[k].whole(), plain[k])


def test_room_script_on_the_cpu(capsys):
    """``tools/split_tables_room.py --cpu`` at scale 10: one slab a group
    of every table and moment, finite, each step's loss printed."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "split_tables_room.py"
    spec = importlib.util.spec_from_file_location("split_tables_room", path)
    room = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(room)
    assert room.main(["--cpu", "--scale", "10", "--dim", "8", "--steps",
                      "1", "--hops", "4"]) == 0
    out = capsys.readouterr().out
    assert "devices=['cpu', 'cpu', 'cpu', 'cpu'], shards=4" in out
    assert "step 2: loss" in out and "every slab on its own card" in out


# ------------------------------------------------------------- on a card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [2, 4])
def test_split_on_the_card(card, groups):
    """On the card, in 2 and 4 groups on cuda:0 (and one group a card where
    the machine has as many): the split gather's rows and slab gradients
    equal the whole table's on the card bit for bit, with one
    embedding-bag and one segment-sum launch a group; a small training
    run equals one group's on the card in tables, moments and ring."""
    from repro_torch.kernels.embedding_bag import LAUNCHES as EB
    from repro_torch.kernels.segment_sum import LAUNCHES as SS
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(1024, 32)).astype(
        np.float32)).to(card)
    ids = torch.from_numpy(rng.integers(0, 1024, (64, 6)).astype(
        np.int32)).to(card)
    up = torch.from_numpy(rng.normal(size=(64, 6, 32)).astype(
        np.float32)).to(card)
    w = table.clone().requires_grad_(True)
    want = layers.gather_rows(w, ids)
    (want_grad,) = torch.autograd.grad(want, w, up)
    layouts = [[card] * groups]
    if torch.cuda.device_count() >= groups:
        layouts.append([torch.device("cuda", i) for i in range(groups)])
    for devs in layouts:
        blocks = RowBlocks.split(table, devs, 4).map(
            lambda s: s.requires_grad_(True))
        before = EB["embedding_bag"], SS["segment_sum"]
        got = layers.gather_rows(blocks, ids)
        grads = torch.autograd.grad(got, list(blocks.slabs), up)
        assert (EB["embedding_bag"] - before[0],
                SS["segment_sum"] - before[1]) == (groups, groups)
        assert torch.equal(got, want)
        for g, d in zip(grads, devs):
            assert g.device == d
        assert torch.equal(torch.cat([g.to(card) for g in grads]), want_grad)
    g = make_dataset("WG", scale_override=9)
    kw = dict(KW, log_every=0)
    out = {G: walker.compile(walker.WalkProgram.urw(H), backend="sharded",
                             mesh=Mesh(N, [card] * G),
                             execution=walker.ExecutionConfig(
                                 slots_per_device=16)).train_embeddings(
        g, **kw) for G in (1, groups)}
    assert_same_training(out[groups], out[1])
