"""On-card checks of the CUDA kernels (walk-step, fused superstep, its
Node2Vec rejection and reservoir branches, the reservoir's staged
schedule traced against its declaration, and its hot-vertex cache tier
included) and the ``cuda`` and ``fused`` steps.

Marked ``gpu``: each test skips, with the reason, where CUDA is not
available (the decision is made inside the fixture, never at import).
Run them on a card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_cuda.py``.

Every comparison is exact: the kernels' outputs are int32 vertex ids and
degrees, the fused kernel's state is integers, and the walker's paths,
lengths and stats are integers.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import walk_engine
from repro_torch.core.walk_engine import EngineConfig, maybe_build_cache
from repro_torch.graph import make_dataset
from repro_torch.kernels.fused_superstep import LAUNCHES as FUSED_LAUNCHES
from repro_torch.kernels.fused_superstep import ops as fused_ops
from repro_torch.kernels.fused_superstep import ref as fused_ref
from repro_torch.kernels.walk_step import LAUNCHES, ops, ref
from repro_torch.walker import ExecutionConfig, WalkProgram, compile

PROGRAMS = {"urw": WalkProgram.urw(20), "ppr": WalkProgram.ppr(0.15, 20),
            "deepwalk": WalkProgram.deepwalk(20),
            "metapath": WalkProgram.metapath((0, 1, 2), 20),
            "node2vec": WalkProgram.node2vec(2.0, 0.5, 20),
            "node2vec_w": WalkProgram.node2vec(2.0, 0.5, 20, weighted=True)}

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_dataset("WG", weighted=True, with_alias=True,
                        scale_override=10)


@pytest.mark.parametrize("width", [1, 255, 256, 1000, 4096])
def test_kernels_bit_equal_to_plain_versions(cuda_graph, width):
    g = cuda_graph
    rng = np.random.default_rng(width)
    deg = (g.row_ptr[1:] - g.row_ptr[:-1]).cpu().numpy()
    v = rng.integers(-1, g.num_vertices + 2, width).astype(np.int32)
    v[::3] = rng.choice(np.flatnonzero(deg == 0), len(v[::3]))
    v[1::5] = int(np.argmax(deg))
    v = torch.from_numpy(v).cuda()
    u = torch.from_numpy(rng.random((2, width), dtype=np.float32)).cuda()
    uc, ua = u[0].contiguous(), u[1].contiguous()
    before = dict(LAUNCHES)
    got = ops.walk_step_uniform(v, uc, g.row_ptr, g.col)
    want = ref.walk_step_uniform_ref(v, uc, g.row_ptr, g.col)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    args = (v, uc, ua, g.row_ptr, g.col, g.alias_prob, g.alias_idx)
    got = ops.walk_step_alias(*args)
    want = ref.walk_step_alias_ref(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES["walk_step_uniform"] == before["walk_step_uniform"] + 1
    assert LAUNCHES["walk_step_alias"] == before["walk_step_alias"] + 1


@pytest.mark.parametrize("width", [1, 31, 33, 12288])
def test_walk_step_uniform_kernel_bit_equal_at_ragged_widths(cuda_graph,
                                                             width):
    """The uniform kernel (32-thread blocks, a programmatic dependent
    launch) at widths either side of a warp and across many blocks, right
    after another kernel wrote its inputs."""
    g = cuda_graph
    rng = np.random.default_rng(width + 7)
    v = torch.from_numpy(rng.integers(-1, g.num_vertices + 2, width)
                         .astype(np.int32)).cuda()
    u = torch.from_numpy(rng.random(width, dtype=np.float32)).cuda()
    v_in, u_in = v + 0, u * 1.0    # written by a kernel just before
    before = LAUNCHES["walk_step_uniform"]
    got = ops.walk_step_uniform(v_in, u_in, g.row_ptr, g.col)
    torch.cuda.synchronize()
    want = ref.walk_step_uniform_ref(v, u, g.row_ptr, g.col)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES["walk_step_uniform"] == before + 1


def test_cuda_tensor_never_falls_back_to_the_plain_version(cuda_graph):
    g = cuda_graph
    v = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="span devices"):
        ops.walk_step_uniform(v, torch.zeros(8), g.row_ptr, g.col)


@pytest.mark.parametrize("name", ["urw", "ppr", "deepwalk"])
def test_cuda_step_equals_cpu_plain_step(cuda_graph, name):
    g = cuda_graph
    g_cpu = make_dataset("WG", weighted=True, with_alias=True,
                         scale_override=10, device="cpu")
    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, 700).astype(np.int32)
    prog = getattr(WalkProgram, name)(max_hops=20)
    want = compile(prog, execution=ExecutionConfig(num_slots=256)).run(
        g_cpu, starts, seed=1)
    before = dict(LAUNCHES)
    got = compile(prog, execution=ExecutionConfig(
        num_slots=256, step_impl="cuda")).run(g, starts, seed=1)
    assert torch.equal(got.paths.cpu(), want.paths)
    assert torch.equal(got.lengths.cpu(), want.lengths)
    assert all(int(a) == int(b) for a, b in zip(got.stats, want.stats))
    kernel = "walk_step_alias" if name == "deepwalk" else "walk_step_uniform"
    assert LAUNCHES[kernel] - before[kernel] == int(got.stats.supersteps)


@pytest.fixture(scope="module")
def typed_graphs():
    """The scale-10 WG stand-in with alias tables and 3 edge types, on the
    card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(weighted=True, with_alias=True, num_edge_types=3,
              scale_override=10)
    return make_dataset("WG", **kw), make_dataset("WG", device="cpu", **kw)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(_clone(f) for f in x))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _tensors(f)]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("width,mode,delay,queued", [
    (1000, "zero_bubble", 0, 1), (4096, "zero_bubble", 0, 1),
    (1000, "static", 2, 1), (4096, "zero_bubble", 0, 17)])
def test_fused_kernel_bit_equal_to_plain_version(typed_graphs, name, width,
                                                 mode, delay, queued):
    """One k = 16 launch of the kernel leaves every state tensor equal to
    the plain version's: from a mid-drain state (queue dry, some lanes
    idle; queued = 1), or from a state one superstep into a batch of
    17 W starts, whose queue refills every lane through the launch."""
    g, _ = typed_graphs
    prog = PROGRAMS[name]
    cfg = EngineConfig(num_slots=width, max_hops=20, mode=mode,
                       injection_delay=delay, step_impl="fused")
    depth = walk_engine._stage_depth(cfg)
    n = width * queued + (width // 16 if queued == 1 else 0)
    starts = torch.from_numpy(np.random.default_rng(width).integers(
        0, g.num_vertices, n).astype(np.int32)).cuda()
    state = fused_ref.fused_superstep_ref(
        g, prog.spec, cfg, depth,
        walk_engine.init_state(cfg, depth, starts), (3, 4), 1)
    while queued == 1 and bool(state.slots.active.all()):
        state = fused_ref.fused_superstep_ref(g, prog.spec, cfg, depth, state,
                                              (3, 4), 1)
    want = fused_ref.fused_superstep_ref(g, prog.spec, cfg, depth,
                                         _clone(state), (3, 4), 16)
    before = FUSED_LAUNCHES["fused_superstep"]
    work, block = fused_ops.pack(_clone(state))
    got = fused_ops.fused_superstep(g, prog.spec, cfg, depth, work, (3, 4), 16,
                                    block)
    torch.cuda.synchronize()
    assert FUSED_LAUNCHES["fused_superstep"] == before + 1
    assert queued == 1 or int(got.queue.head) < int(got.queue.tail)
    for a, b in zip(_tensors(got), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("variant", [
    {}, {"mode": "static", "injection_delay": 2}, {"record_paths": False}])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fused_step_equals_cpu_plain_version(typed_graphs, name, variant):
    """A whole fused drain on the card equals the CPU's, all 12 stats
    included: zero-bubble, static with a delay (bulk reloads of a drained
    pool), and without path records."""
    g, g_cpu = typed_graphs
    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, 700).astype(np.int32)
    execution = ExecutionConfig(num_slots=256, step_impl="fused",
                                hops_per_launch=4, **variant)
    want = compile(PROGRAMS[name], execution=execution).run(g_cpu, starts,
                                                            seed=1)
    before = dict(LAUNCHES), FUSED_LAUNCHES["fused_superstep"]
    got = compile(PROGRAMS[name], execution=execution).run(g, starts, seed=1)
    assert torch.equal(got.paths.cpu(), want.paths)
    assert torch.equal(got.lengths.cpu(), want.lengths)
    assert all(int(a) == int(b) for a, b in zip(got.stats, want.stats))
    assert dict(LAUNCHES) == before[0]
    assert (FUSED_LAUNCHES["fused_superstep"] - before[1]
            == int(got.stats.launches) < int(got.stats.supersteps))


@pytest.mark.parametrize("name", ["node2vec", "node2vec_w"])
def test_fused_node2vec_on_the_hub_bit_equal_to_plain_version(cuda_graph,
                                                               name):
    """One k = 16 launch from a state whose lanes sit on the max-degree hub
    (after a hop from an in-neighbor, and at hop 0), on a vertex whose
    degree is not a multiple of the reservoir chunk, and elsewhere: every
    state tensor equal to the plain version's."""
    g = cuda_graph
    prog = PROGRAMS[name]
    cfg = EngineConfig(num_slots=256, max_hops=20, step_impl="fused")
    depth = walk_engine._stage_depth(cfg)
    starts = torch.from_numpy(np.random.default_rng(5).integers(
        0, g.num_vertices, 300).astype(np.int32)).cuda()
    state = walk_engine.init_state(cfg, depth, starts)
    hub_state(g, state, prog.spec.reservoir_chunk)
    want = fused_ref.fused_superstep_ref(g, prog.spec, cfg, depth,
                                         _clone(state), (3, 4), 16)
    work, block = fused_ops.pack(_clone(state))
    got = fused_ops.fused_superstep(g, prog.spec, cfg, depth, work, (3, 4), 16,
                                    block)
    torch.cuda.synchronize()
    for a, b in zip(_tensors(got), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def hub_state(g, state, chunk):
    """Place the first three live lanes of ``state`` (in place): on the
    max-degree hub after a hop from one of its in-neighbors, on the hub at
    hop 0, and on a vertex of degree above ``chunk`` and not a multiple of
    it, after a hop from an in-neighbor."""
    deg = g.row_ptr[1:] - g.row_ptr[:-1]
    hub = int(torch.argmax(deg))
    ragged = (deg > chunk) & (deg % chunk != 0)
    ragged[hub] = False
    ragged = int(torch.nonzero(ragged)[0])

    def in_neighbor(v):
        """A vertex other than v with an edge to v."""
        rows = torch.searchsorted(g.row_ptr, torch.nonzero(g.col == v)[:, 0],
                                  right=True) - 1
        return int(rows[rows != v][0])
    s = state.slots
    lanes = torch.nonzero(s.active)[:3, 0].tolist()
    for lane, (v, vp, hop) in zip(lanes, ((hub, in_neighbor(hub), 3),
                                          (hub, -1, 0),
                                          (ragged, in_neighbor(ragged), 2))):
        s.v_curr[lane], s.v_prev[lane], s.hop[lane] = v, vp, hop


@pytest.fixture(scope="module")
def large_graph():
    """The scale-14 WG stand-in with every payload: large enough that a
    1 MiB cache block exceeds a thread block's shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_dataset("WG", weighted=True, with_alias=True,
                        num_edge_types=3, scale_override=14)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("tier,budget", [("shared", 1 << 15),
                                         ("global", 1 << 20)])
@pytest.mark.parametrize("width", [1000, 4096])
def test_fused_cached_kernel_bit_equal_to_plain_version(typed_graphs,
                                                        large_graph, name,
                                                        tier, budget, width):
    """One k = 16 launch with the hot-vertex cache, its block in shared
    memory (scale 10, 32 KiB) or read in place (scale 14, 1 MiB), from a
    mid-drain state: every state tensor equal to the plain version's, the
    three cache counters included, and some leader hits."""
    g = typed_graphs[0] if tier == "shared" else large_graph
    prog = PROGRAMS[name]
    cfg = EngineConfig(num_slots=width, max_hops=20, step_impl="fused",
                       cache_budget=budget)
    cache = fused_ops.cache_block(maybe_build_cache(prog.spec, cfg, g),
                                  g.device)
    assert fused_ops.cache_tier(prog.spec, cfg, cache) == tier
    depth = walk_engine._stage_depth(cfg)
    starts = torch.from_numpy(np.random.default_rng(width).integers(
        0, g.num_vertices, width + width // 16).astype(np.int32)).cuda()
    state = walk_engine.init_state(cfg, depth, starts)
    while bool(state.slots.active.all()):
        state = fused_ref.fused_superstep_ref(g, prog.spec, cfg, depth, state,
                                              (3, 4), 1, cache.hot_ids)
    want = fused_ref.fused_superstep_ref(g, prog.spec, cfg, depth,
                                         _clone(state), (3, 4), 16,
                                         cache.hot_ids)
    before = FUSED_LAUNCHES["fused_superstep"]
    work, block = fused_ops.pack(_clone(state))
    got = fused_ops.fused_superstep(g, prog.spec, cfg, depth, work, (3, 4), 16,
                                    block, cache=cache)
    torch.cuda.synchronize()
    assert FUSED_LAUNCHES["fused_superstep"] == before + 1
    for a, b in zip(_tensors(got), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got.stats.cache_hits) > int(state.stats.cache_hits)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fused_cached_step_equals_cpu_plain_version(typed_graphs, name):
    """A cached fused drain on the card equals the CPU's in all 12 stats,
    and equals the uncached drain but for the three cache counters."""
    g, g_cpu = typed_graphs
    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, 700).astype(np.int32)

    def run(graph, budget):
        return compile(PROGRAMS[name], execution=ExecutionConfig(
            num_slots=256, step_impl="fused", hops_per_launch=4,
            cache_budget=budget)).run(graph, starts, seed=1)
    want, got, off = run(g_cpu, 1 << 14), run(g, 1 << 14), run(g, 0)
    assert torch.equal(got.paths.cpu(), want.paths)
    assert torch.equal(got.lengths.cpu(), want.lengths)
    assert all(int(a) == int(b) for a, b in zip(got.stats, want.stats))
    assert torch.equal(got.paths, off.paths)
    assert int(got.stats.cache_hits) > 0 == int(off.stats.cache_hits)


# ------------------------------------------------ embedding bag, segment sum

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bags(B, H, R, D, pads, weighted, seed):
    r = np.random.default_rng(seed)
    idx = r.integers(-1 if pads else 0, R, (B, H)).astype(np.int32)
    w = r.random((B, H), dtype=np.float32) if weighted else None
    tbl = r.standard_normal((R, D)).astype(np.float32)
    tbl[::7, ::3] = -0.0          # signed zeros meet the pads' row · 0
    return idx, w, tbl


@pytest.mark.parametrize("B,H,R,D,pads,weighted", [
    (4096, 1, 1 << 16, 128, False, False),    # the SGNS step's gathers
    (20480, 1, 1 << 16, 128, False, False),
    (1000, 7, 5000, 100, True, True),         # pads, weights, scalar tail
    (333, 3, 700, 128, True, True),
    (64, 2, 50, 6, True, False),
    (1, 1, 1 << 16, 128, False, False),       # ragged B: one warp,
    (31, 1, 1 << 16, 128, False, False),      # a last block part idle,
    (33, 1, 1 << 16, 128, False, False),
    (20481, 1, 1 << 16, 128, False, False),
    (4096, 2, 1 << 16, 128, True, True),      # pads and weights at D = 128
    (4096, 7, 1 << 16, 128, True, True),
    (20480, 1, 1 << 16, 100, False, False),   # 25 float4 words a row
    (20480, 1, 1 << 16, 102, False, False)])  # the scalar path
def test_embedding_bag_kernel_bit_equal_to_plain_version(card, B, H, R, D,
                                                         pads, weighted):
    """The kernel against its plain version on the card and on the CPU,
    bit for bit, counted once."""
    from repro_torch.kernels.embedding_bag import LAUNCHES as EB
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    idx, w, tbl = _bags(B, H, R, D, pads, weighted, seed=B + H)
    cpu = (torch.from_numpy(idx), torch.from_numpy(tbl),
           None if w is None else torch.from_numpy(w))
    dev = tuple(None if t is None else t.to(card) for t in cpu)
    before = EB["embedding_bag"]
    got = embedding_bag(*dev)
    torch.cuda.synchronize()
    assert EB["embedding_bag"] == before + 1
    assert torch.equal(got, embedding_bag_ref(*dev))
    assert torch.equal(got.cpu(), embedding_bag(*cpu))
    # signed zeros kept
    assert torch.equal(torch.signbit(got.cpu()), torch.signbit(
        embedding_bag(*cpu)))


def test_embedding_bag_kernel_from_an_unaligned_table(card):
    """A table view 4 bytes past 16-byte alignment takes the scalar path
    at D = 128 and stays bit-equal."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    idx, _, tbl = _bags(20480, 1, 1 << 16, 128, False, False, seed=5)
    flat = torch.zeros(tbl.size + 1, device=card)
    flat[1:] = torch.from_numpy(tbl.reshape(-1)).to(card)
    table = flat[1:].view(tbl.shape)
    indices = torch.from_numpy(idx).to(card)
    got = eb_ops.embedding_bag(indices, table)
    torch.cuda.synchronize()
    assert table.data_ptr() % 16 != 0 and not eb_ops.vectorized(table, got)
    assert torch.equal(got, embedding_bag_ref(indices, table))
    assert torch.equal(got.cpu(), embedding_bag_ref(indices.cpu(),
                                                    table.cpu()))


def _segments(E, S, D, hub_share, seed):
    r = np.random.default_rng(seed)
    ids = r.integers(0, S, E).astype(np.int32)
    ids[r.random(E) < hub_share] = S // 3        # a hub segment
    ids[::97] = -1                               # dropped
    ids[1::101] = S                              # dropped
    return ids, r.standard_normal((E, D)).astype(np.float32)


@pytest.mark.parametrize("E,S,D,hub", [
    (4096, 1 << 16, 128, 0.0), (20480, 1 << 16, 128, 0.0),
    (24576, 1 << 16, 128, 0.0), (24576, 5000, 100, 0.2),
    (1000, 300, 7, 0.5)])
def test_segment_sum_kernel_bit_equal_to_cpu_plain_version(card, E, S, D,
                                                          hub):
    """The kernel equals the plain version on CPU copies bit for bit, gives
    the same bytes when launched twice, and agrees with index_add_ on the
    card (atomics: another order) within 1e-3."""
    from repro_torch.kernels.segment_sum import LAUNCHES as SS
    from repro_torch.kernels.segment_sum import SegmentSumOp, segment_sum
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    ids, data = _segments(E, S, D, hub, seed=E + S)
    ids_d, data_d = torch.from_numpy(ids).to(card), torch.from_numpy(
        data).to(card)
    before = SS["segment_sum"]
    got = segment_sum(data_d, ids_d, S)
    again = segment_sum(data_d, ids_d, S)
    torch.cuda.synchronize()
    assert SS["segment_sum"] == before + 2
    want = segment_sum_ref(torch.from_numpy(data), torch.from_numpy(ids), S)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    empty = np.setdiff1d(np.arange(S), ids)
    assert bool((got[torch.from_numpy(empty).to(card)] == 0).all())
    torch.testing.assert_close(got, segment_sum_ref(data_d, ids_d, S),
                               rtol=1e-5, atol=1e-3)
    order = np.argsort(ids, kind="stable")
    op = SegmentSumOp(torch.from_numpy(ids[order]).to(card), S)
    assert torch.equal(op(data_d[torch.from_numpy(order).to(card)]), got)


def test_embedding_kernels_never_fall_back_to_the_plain_version(card):
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.segment_sum import segment_sum
    idx = torch.zeros((8, 1), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="span devices"):
        embedding_bag(idx, torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="span devices"):
        segment_sum(torch.zeros((8, 4)), idx[:, 0], 4)


def test_gather_rows_on_the_card_equals_the_cpu(card):
    """Forward and gradient of the kernel gathers bit-equal to the CPU's
    plain path."""
    from repro_torch.models import embeddings as emb
    r = np.random.default_rng(0)
    table = r.standard_normal((5000, 128)).astype(np.float32)
    ids = r.integers(0, 5000, (4096, 5)).astype(np.int32)
    ids[:, 0] = 17                                  # a repeated row
    out = {}
    for dev in ("cpu", card):
        t = torch.from_numpy(table).to(dev).requires_grad_(True)
        rows = emb.gather_rows(t, torch.from_numpy(ids).to(dev))
        (g,) = torch.autograd.grad(torch.sum(rows * rows.detach()), t)
        out[str(dev)] = (rows.detach().cpu(), g.cpu())
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)


def test_train_embeddings_on_the_card(card):
    """A small run (WG scale 9, dim 8) on the card: every batch bit-equal
    to the CPU's, tables within the CPU tests' tolerance (rtol 1e-5, atol
    1e-6: the loss's reductions run in another order); overlap and serial
    bit-identical on the card; 3 embedding-bag and 3 segment-sum launches
    a step."""
    from repro_torch.kernels.embedding_bag import LAUNCHES as EB
    from repro_torch.kernels.segment_sum import LAUNCHES as SS
    kw = dict(seed=3, rounds=2, walks_per_round=16, steps_per_round=8,
              batch_size=32, dim=8, window=3, num_negatives=4)
    prog = WalkProgram.deepwalk(10)
    logs, outs = {}, {}
    for dev in ("cpu", "cuda"):
        g = make_dataset("WG", weighted=True, with_alias=True,
                         scale_override=9, device=dev)
        logs[dev] = []
        before = EB["embedding_bag"], SS["segment_sum"]
        outs[dev] = compile(prog, execution=ExecutionConfig(
            step_impl="fused", num_slots=64)).train_embeddings(
            g, **kw, batch_hook=lambda s, b, log=logs[dev]: log.append(
                tuple(x.cpu() for x in b)))
        launched = EB["embedding_bag"] - before[0], SS["segment_sum"] - before[1]
        assert launched == ((0, 0) if dev == "cpu" else (48, 48))
    for a, b in zip(logs["cpu"], logs["cuda"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k in ("in_embed", "out_embed"):
        torch.testing.assert_close(outs["cuda"]["params"][k].cpu(),
                                   outs["cpu"]["params"][k], rtol=1e-5,
                                   atol=1e-6)
    g = make_dataset("WG", weighted=True, with_alias=True, scale_override=9)
    ser = compile(prog, execution=ExecutionConfig(
        step_impl="fused", num_slots=64)).train_embeddings(g, **kw,
                                                           overlap=False)
    for k in ("in_embed", "out_embed"):
        assert torch.equal(ser["params"][k], outs["cuda"]["params"][k])


def test_overlapped_training_runs_its_producer_on_its_own_stream(
        card, monkeypatch):
    """Overlapped, the fused launches run on the producer's thread under a
    stream other than the consumer's, and the run equals the serial one
    (whose launches run on the consumer's stream) bit for bit in tables,
    moments and ring."""
    import threading
    launches = []
    real = fused_ops.fused_superstep

    def spy(graph, *args, **kw):
        launches.append((threading.get_ident(),
                         torch.cuda.current_stream(graph.device)))
        return real(graph, *args, **kw)
    monkeypatch.setattr(fused_ops, "fused_superstep", spy)
    g = make_dataset("WG", weighted=True, with_alias=True,
                     scale_override=10)
    w = compile(WalkProgram.deepwalk(10), execution=ExecutionConfig(
        step_impl="fused", num_slots=64))
    kw = dict(seed=3, rounds=3, walks_per_round=256, steps_per_round=8,
              batch_size=64, dim=16, window=3, num_negatives=4)
    consumer = torch.cuda.current_stream(g.device)
    over = w.train_embeddings(g, **kw)
    overlapped, launches[:] = list(launches), []
    ser = w.train_embeddings(g, **kw, overlap=False)
    me = threading.get_ident()
    assert overlapped and all(t != me and s != consumer
                              for t, s in overlapped)
    assert launches and all(t == me and s == consumer for t, s in launches)
    for k in ("in_embed", "out_embed"):
        assert torch.equal(over["params"][k], ser["params"][k])
        assert torch.equal(over["opt_state"].mu[k], ser["opt_state"].mu[k])
        assert torch.equal(over["opt_state"].nu[k], ser["opt_state"].nu[k])
    assert all(torch.equal(a, b) for a, b in zip(over["ring"], ser["ring"]))


# ------------------------------------------- the grid of the fused kernel

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fused_grid_spans_blocks_and_is_bit_equal_at_12288(typed_graphs,
                                                           name):
    """At W = 12,288 the launch takes many blocks, every one owning lanes,
    and one k = 16 launch from a mid-drain state (lanes live, idle and
    just refilled, so refill ranks cross block edges) leaves every state
    tensor equal to the plain version's."""
    g, _ = typed_graphs
    prog = PROGRAMS[name]
    cfg = EngineConfig(num_slots=12_288, max_hops=20, step_impl="fused")
    grid = fused_ops.grid(prog.spec, cfg, g.device)
    assert 1 < grid.blocks <= grid.per_sm * torch.cuda.get_device_properties(
        0).multi_processor_count
    assert 12_288 // grid.blocks >= 1    # every block owns >= W // blocks
    depth = walk_engine._stage_depth(cfg)
    starts = torch.from_numpy(np.random.default_rng(3).integers(
        0, g.num_vertices, 12_288 + 768).astype(np.int32)).cuda()
    state = walk_engine.init_state(cfg, depth, starts)
    while bool(state.slots.active.all()):
        state = fused_ref.fused_superstep_ref(g, prog.spec, cfg, depth, state,
                                              (3, 4), 1)
    want = fused_ref.fused_superstep_ref(g, prog.spec, cfg, depth,
                                         _clone(state), (3, 4), 16)
    work, block = fused_ops.pack(_clone(state))
    got = fused_ops.fused_superstep(g, prog.spec, cfg, depth, work, (3, 4), 16,
                                    block)
    torch.cuda.synchronize()
    for a, b in zip(_tensors(got), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("budget", [0, 1 << 15])
def test_fused_reservoir_with_every_lane_on_the_hub(cuda_graph, budget):
    """Every live lane on the max-degree hub (half after a hop from an
    in-neighbor, half at hop 0), so the hub's chunks are spread over the
    grid's warps; without and with the cache (the hub is its first vertex):
    every state tensor equal to the plain version's."""
    g = cuda_graph
    prog = PROGRAMS["node2vec_w"]
    cfg = EngineConfig(num_slots=256, max_hops=20, step_impl="fused",
                       cache_budget=budget)
    cache = None
    if budget:
        cache = fused_ops.cache_block(maybe_build_cache(prog.spec, cfg, g),
                                      g.device)
    depth = walk_engine._stage_depth(cfg)
    starts = torch.from_numpy(np.random.default_rng(9).integers(
        0, g.num_vertices, 400).astype(np.int32)).cuda()
    state = walk_engine.init_state(cfg, depth, starts)
    deg = g.row_ptr[1:] - g.row_ptr[:-1]
    hub = int(torch.argmax(deg))
    src = torch.searchsorted(g.row_ptr, torch.nonzero(g.col == hub)[:, 0],
                             right=True) - 1
    vp = int(src[src != hub][0])
    s = state.slots
    s.v_curr[:] = hub
    s.v_prev[:] = torch.where(torch.arange(256, device="cuda") % 2 == 0, vp,
                              -1).int()
    s.hop[:] = torch.where(s.v_prev >= 0, 3, 0).int()
    hot = None if cache is None else cache.hot_ids
    want = fused_ref.fused_superstep_ref(g, prog.spec, cfg, depth,
                                         _clone(state), (3, 4), 4, hot)
    work, block = fused_ops.pack(_clone(state))
    got = fused_ops.fused_superstep(g, prog.spec, cfg, depth, work, (3, 4), 4,
                                    block, cache=cache)
    torch.cuda.synchronize()
    for a, b in zip(_tensors(got), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if budget:
        assert int(got.stats.cache_hits) > 0


def _on_the_hub(g, state, width):
    """Every lane of ``state`` on the max-degree hub, even lanes after a hop
    from one of its in-neighbors, odd ones at hop 0 (in place)."""
    deg = g.row_ptr[1:] - g.row_ptr[:-1]
    hub = int(torch.argmax(deg))
    src = torch.searchsorted(g.row_ptr, torch.nonzero(g.col == hub)[:, 0],
                             right=True) - 1
    vp = int(src[src != hub][0])
    s = state.slots
    s.v_curr[:] = hub
    s.v_prev[:] = torch.where(torch.arange(width, device="cuda") % 2 == 0,
                              vp, -1).int()
    s.hop[:] = torch.where(s.v_prev >= 0, 3, 0).int()


@pytest.mark.parametrize("chunk,weighted,budget,where", [
    (64, True, 0, "hub"), (17, True, 0, "hub"), (100, True, 0, "hub"),
    (64, False, 0, "hub"), (64, True, 1 << 15, "hub"),
    (64, True, 1 << 15, "drain")])
def test_traced_reservoir_launch_equals_untraced_and_its_declaration(
        cuda_graph, chunk, weighted, budget, where):
    """Weighted Node2Vec (reservoir CH = ``chunk``; unweighted: every edge
    1.0) at W = 4,096, one superstep from every lane on the hub or from a
    mid-drain state, launched untraced and traced
    (``ops.trace_schedule``, warp 0): both equal the plain version in
    every state tensor.  The trace has no finding from the DMA pass and no
    copy on a cache buffer; from the hub it equals the declaration op for
    op (``dma_schedule`` over the warp's staged windows: one an item at CH
    <= 64, two at CH = 100), cached or not."""
    import dataclasses

    from repro_torch.analysis.dma_hazards import check_schedule
    from repro_torch.kernels.fused_superstep.schedule import dma_schedule
    g = cuda_graph if weighted else dataclasses.replace(cuda_graph,
                                                        weights=None)
    prog = PROGRAMS["node2vec_w"]
    spec = dataclasses.replace(prog.spec, reservoir_chunk=chunk)
    W = 4096
    cfg = EngineConfig(num_slots=W, max_hops=20, step_impl="fused",
                       cache_budget=budget)
    cache = None
    if budget:
        cache = fused_ops.cache_block(maybe_build_cache(spec, cfg, g),
                                      g.device)
        assert fused_ops.cache_tier(spec, cfg, cache) == "shared"
    depth = walk_engine._stage_depth(cfg)
    starts = torch.from_numpy(np.random.default_rng(chunk).integers(
        0, g.num_vertices, W + W // 16).astype(np.int32)).cuda()
    state = walk_engine.init_state(cfg, depth, starts)
    if where == "hub":
        _on_the_hub(g, state, W)
    else:
        while bool(state.slots.active.all()):
            state = fused_ref.fused_superstep_ref(g, spec, cfg, depth, state,
                                                  (3, 4), 1)
    hot = None if cache is None else cache.hot_ids
    want = fused_ref.fused_superstep_ref(g, spec, cfg, depth, _clone(state),
                                         (3, 4), 1, hot)
    work, block = fused_ops.pack(_clone(state))
    fused_ops.fused_superstep(g, spec, cfg, depth, work, (3, 4), 1, block,
                              cache=cache)
    before = FUSED_LAUNCHES["fused_superstep"]
    traced, tblock = fused_ops.pack(_clone(state))
    trace = fused_ops.trace_schedule(g, spec, cfg, depth, traced, (3, 4), 1,
                                     tblock, cache=cache, warp=0)
    torch.cuda.synchronize()
    assert FUSED_LAUNCHES["fused_superstep"] == before + 1
    for a, b in zip(_tensors(traced), _tensors(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(_tensors(work), _tensors(traced)):
        assert torch.equal(a, b)
    assert torch.equal(block, tblock)
    assert trace.items >= 1 and trace.windows >= trace.items
    assert check_schedule(trace.ops, "trace") == []
    assert not [op for op in trace.ops
                if op.kind == "start" and op.buffer.startswith("cache.")]
    if where == "hub":
        assert trace.windows == trace.items * (2 if chunk == 100 else 1)
        assert trace.ops == dma_schedule("reservoir_n2v",
                                         chunks=trace.windows,
                                         cached=bool(budget),
                                         weighted=weighted)


def test_trace_schedule_takes_the_reservoir_on_the_card_only(cuda_graph):
    """Another kind, or a state on the CPU, is refused: only the reservoir
    stages its reads, and the plain version stages nothing."""
    g = cuda_graph
    cfg = EngineConfig(num_slots=32, max_hops=20, step_impl="fused")
    depth = walk_engine._stage_depth(cfg)
    starts = torch.arange(32, dtype=torch.int32)
    for name, device in (("urw", "cuda"), ("node2vec_w", "cpu")):
        state, block = fused_ops.pack(walk_engine.init_state(
            cfg, depth, starts.to(device)))
        with pytest.raises(ValueError):
            fused_ops.trace_schedule(g, PROGRAMS[name].spec, cfg, depth,
                                     state, (3, 4), 1, block)


def test_segment_sum_kernel_empty_and_changed_ids(card):
    """No ids at all gives exact zeros; a second call with other ids over
    the same shapes (a hub over 1,024 times, ids outside [0, S)) equals
    its own plain version, so no chain of the first call survives."""
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    S = 1_000
    out = segment_sum(torch.zeros((0, 8), device=card),
                      torch.zeros((0,), dtype=torch.int32, device=card), S)
    assert out.shape == (S, 8) and bool((out == 0).all())
    first, data = _segments(4096, S, 128, 0.0, seed=1)
    second, _ = _segments(4096, S, 128, 0.3, seed=2)
    data_d = torch.from_numpy(data).to(card)
    for ids in (first, second, first):
        got = segment_sum(data_d, torch.from_numpy(ids).to(card), S)
        want = segment_sum_ref(torch.from_numpy(data), torch.from_numpy(ids),
                               S)
        assert torch.equal(got.cpu(), want)
    assert int((second == S // 3).sum()) > 1024


@pytest.mark.parametrize("width", [1, 31, 33, 4096, 12288])
def test_walk_step_alias_kernel_after_the_kernels_that_wrote_its_inputs(
        cuda_graph, width):
    """The alias kernel (32-thread blocks, a programmatic dependent launch,
    prob and alias loaded in one round trip) right after kernels on the
    same stream wrote v_curr and both uniforms, with no sync between, as
    the per-hop path copies the uniforms' columns just before it."""
    g = cuda_graph
    rng = np.random.default_rng(width + 11)
    deg = (g.row_ptr[1:] - g.row_ptr[:-1]).cpu().numpy()
    v = rng.integers(-1, g.num_vertices + 2, width).astype(np.int32)
    v[::5] = int(np.argmax(deg))
    v = torch.from_numpy(v).cuda()
    u = torch.from_numpy(rng.random((width, 2), dtype=np.float32)).cuda()
    want = ref.walk_step_alias_ref(v, u[:, 0].contiguous(),
                                   u[:, 1].contiguous(), g.row_ptr, g.col,
                                   g.alias_prob, g.alias_idx)
    torch.cuda.synchronize()
    before = LAUNCHES["walk_step_alias"]
    v_in = v + 0
    u_col, u_acc = (u * 1.0)[:, 0].contiguous(), u[:, 1].contiguous()
    got = ops.walk_step_alias(v_in, u_col, u_acc, g.row_ptr, g.col,
                              g.alias_prob, g.alias_idx)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES["walk_step_alias"] == before + 1


def _soak(stream, total, wave, chunk, seed=0):
    """Push ``total`` random starts through ``stream`` (waves of at most
    ``wave`` into free slots, chunks of ``chunk`` supersteps, every
    finished slot harvested and released).  Returns ({(epoch, qid): (start,
    path, length)}, the most epochs live at once)."""
    rng = np.random.default_rng(seed)
    pending = list(rng.integers(0, stream.graph.num_vertices, total))
    harvested, live, mixed = {}, {}, 1
    for _ in range(total):
        if not (pending or live):
            break
        n = min(wave, stream.num_free, len(pending))
        if n:
            starts = np.asarray(pending[:n], np.int32)
            del pending[:n]
            qids, epochs = stream.inject(starts)
            live.update({int(q): (int(e), int(s))
                         for q, e, s in zip(qids, epochs, starts)})
            mixed = max(mixed, len({e for e, _ in live.values()}))
        stream.advance(chunk)
        done = stream.done_live_mask()
        ready = [q for q in live if done[q]]
        if ready:
            paths, lengths = stream.harvest_ids(ready)
            for i, q in enumerate(ready):
                e, s = live.pop(q)
                harvested[e, q] = (s, paths[i].copy(), int(lengths[i]))
            stream.release(ready)
    assert len(harvested) == total, "the stream stalled"
    return harvested, mixed


def _same_harvest(a, b):
    return a.keys() == b.keys() and all(
        a[k][0] == b[k][0] and a[k][2] == b[k][2]
        and np.array_equal(a[k][1], b[k][1]) for k in a)


@pytest.mark.parametrize("name,budget", [(n, 0) for n in sorted(PROGRAMS)]
                         + [("deepwalk", 1 << 15)])
def test_fused_stream_wraps_and_equals_torch_stream(typed_graphs, name,
                                                    budget):
    """A fused stream on the card whose ring wraps three times or more
    (epochs 0-3 at least, several live at once) harvests what the torch stream on the card does,
    with every stat but ``launches`` (and, cached, the cache counters)
    equal; its launches are the kernel's own count."""
    g, _ = typed_graphs
    out = {}
    for impl in ("torch", "fused"):
        w = compile(PROGRAMS[name], execution=ExecutionConfig(
            num_slots=256, step_impl=impl, hops_per_launch=4,
            cache_budget=budget if impl == "fused" else 0))
        stream = w.stream(g, capacity=512, seed=6)
        before = FUSED_LAUNCHES["fused_superstep"]
        out[impl] = (*_soak(stream, 1_800, 128, 8), stream.walk_stats())
        launched = FUSED_LAUNCHES["fused_superstep"] - before
        assert launched == (out[impl][2].launches if impl == "fused" else 0)
    (want, _, ws), (got, mixed, gs) = out["torch"], out["fused"]
    assert _same_harvest(got, want)
    assert {0, 1, 2, 3} <= {e for e, _ in got} and mixed >= 2
    skip = {"launches", "cache_hits", "cache_misses", "cache_coalesced"}
    assert all(a == b for f, a, b in zip(ws._fields, ws, gs) if f not in skip)
    assert 0 < gs.launches < gs.supersteps
    assert (gs.cache_hits > 0) == (budget > 0)


@pytest.mark.parametrize("name", ["urw", "deepwalk"])
def test_cuda_stream_launches_its_walk_step_kernel(cuda_graph, name):
    """A stream under ``cuda`` launches its walk-step kernel once a
    superstep and equals the fused stream on the card."""
    kernel = "walk_step_alias" if name == "deepwalk" else "walk_step_uniform"
    out = {}
    for impl in ("cuda", "fused"):
        w = compile(PROGRAMS[name], execution=ExecutionConfig(
            num_slots=256, step_impl=impl))
        stream = w.stream(cuda_graph, capacity=384, seed=2)
        before = dict(LAUNCHES)
        harvested, _ = _soak(stream, 1_000, 96, 16)
        st = stream.walk_stats()
        out[impl] = harvested, st
        counted = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        want = {k: 0 for k in LAUNCHES}
        if impl == "cuda":
            want[kernel] = st.supersteps
        assert counted == want
    assert _same_harvest(out["cuda"][0], out["fused"][0])
    assert out["cuda"][1].supersteps == out["fused"][1].supersteps


# ------------------------------------------------------------ the service

@pytest.fixture(scope="module")
def serve_graphs():
    """The scale-9 WG stand-in with alias tables and 3 edge types, on the
    card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(weighted=True, with_alias=True, num_edge_types=3,
              scale_override=9)
    return make_dataset("WG", **kw), make_dataset("WG", device="cpu", **kw)


def _serve(g, name, impl):
    """A small service (W = 32, capacity 64, chunk 4) driven by one fixed
    sequence of submissions and steps; returns (requests, stats)."""
    svc = compile(PROGRAMS[name], execution=ExecutionConfig(
        num_slots=32, step_impl=impl, hops_per_launch=4)).serve(
        g, capacity=64, chunk=4, seed=3)
    rng = np.random.default_rng(1)
    for i, n in enumerate((24, 40, 9, 64, 17, 33, 50, 8)):
        svc.submit(rng.integers(0, g.num_vertices, n))
        if i % 2:
            svc.step()
    return svc.drain(), svc.walk_stats()


@pytest.mark.parametrize("impl", ["fused", "cuda"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_service_on_the_card_equals_cpu_torch_service(serve_graphs, name,
                                                      impl):
    """A service on the card under ``fused`` and ``cuda`` serves what the
    same service under ``torch`` on the CPU does, request for request
    (slot ids, epochs, paths, lengths, superstep clocks), with every stat
    but ``launches`` equal; the card's launches are its kernels' counts."""
    g, cpu = serve_graphs
    want, want_stats = _serve(cpu, name, "torch")
    before = {**LAUNCHES, **FUSED_LAUNCHES}
    got, stats = _serve(g, name, impl)
    counted = {k: v - before[k] for k, v in {**LAUNCHES,
                                             **FUSED_LAUNCHES}.items()}
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for a, b in zip(got, want):
        for f in ("qids", "epochs", "paths", "lengths", "submitted_at",
                  "admitted_at", "completed_at"):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), (a.request_id, f)
        assert a.wall_completed >= a.wall_admitted >= a.wall_submitted
    assert all(x == y for f, x, y in zip(stats._fields, stats, want_stats)
               if f != "launches")
    assert max(int(r.epochs.max()) for r in got) >= 1
    if impl == "fused":
        assert counted["fused_superstep"] == stats.launches > 0
    elif name in ("urw", "ppr", "deepwalk"):
        kernel = "walk_step_alias" if name == "deepwalk" else \
            "walk_step_uniform"
        assert counted[kernel] == stats.supersteps


def test_serve_main_serves_the_same_weights_on_the_card(card, monkeypatch):
    """``launch.serve.main --device cuda`` serves the weights that
    ``--device cpu`` serves, bit for bit (both drawn on a CPU generator)."""
    from repro_torch.checkpoint.checkpointer import leaves
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    real = tfm.init_params
    drawn = []

    def spy(*args, **kw):
        drawn.append(real(*args, **kw))
        return drawn[-1]
    monkeypatch.setattr(tfm, "init_params", spy)
    for dev in ("cpu", "cuda"):
        serve.main(["--device", dev, "--arch", "granite_moe", "--requests",
                    "2", "--slots", "2", "--max-new", "2"])
    cpu, card = drawn
    assert leaves(card)[0].device.type == "cuda"
    assert all(torch.equal(a, b.cpu())
               for a, b in zip(leaves(cpu), leaves(card)))


def test_train_main_starts_dcn_from_the_same_weights_on_the_card(
        card, monkeypatch, tmp_path):
    """``launch.train.main --arch dcn_v2 --device cuda`` starts from the
    weights that ``--device cpu`` starts from, bit for bit: both are drawn
    and scaled on a CPU generator (a CUDA tensor divided by a Python
    number rounds otherwise than the CPU's division)."""
    from repro_torch.checkpoint.checkpointer import leaves, tree_map
    from repro_torch.launch import train
    from repro_torch.models.recsys import dcn
    real = dcn.init_params
    drawn = []

    def spy(*args, **kw):
        tree = real(*args, **kw)
        drawn.append(tree_map(torch.clone, tree))   # training updates it
        return tree
    monkeypatch.setattr(dcn, "init_params", spy)
    for dev in ("cpu", "cuda"):
        train.main(["--device", dev, "--arch", "dcn_v2", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / dev)])
    cpu, on_card = drawn
    assert leaves(on_card)[0].device.type == "cuda"
    assert all(torch.equal(a, b.cpu())
               for a, b in zip(leaves(cpu), leaves(on_card)))


def test_kernels_on_the_card_record_no_meta_cost(card):
    """A CUDA call launches its kernel and never reaches the ``meta``
    shape rule: an open ``KernelCost`` records nothing."""
    from repro_torch.kernels.embedding_bag import LAUNCHES as EB_LAUNCHES
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.meta_cost import KernelCost
    from repro_torch.kernels.segment_sum import segment_sum
    ids = torch.randint(0, 50, (64, 3), dtype=torch.int32, device=card)
    table = torch.randn(50, 8, device=card)
    before = EB_LAUNCHES["embedding_bag"]
    with KernelCost() as cost:
        rows = embedding_bag(ids, table)
        segment_sum(rows, ids[:, 0].contiguous(), 50)
    assert EB_LAUNCHES["embedding_bag"] == before + 1
    assert (cost.flops, cost.bytes, cost.calls) == (0, 0, {})
