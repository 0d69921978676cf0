"""The LM training substrate in device groups: ``distributed.mesh``'s
``ppermute``, grouped ``GridMesh``es and ``axis_devices``,
``runtime.elastic.build_mesh`` over the devices given,
``distributed.pipeline.pipeline_apply`` over the groups of a ``pipe``
axis, ``optim.grad_compression.crosspod_psum_compressed`` over pods in
groups, and ``checkpointer.restore`` / ``train_loop.resume_or_init``
placing leaves where ``shardings`` says.

The groups are ``[cpu] * G`` (a mesh may name one device G times), so
these tests run the grouped code on the CPU; a group on ``meta`` shows
where a leaf was placed.  The reference's own multi-device runs (its
``pipeline_apply`` over 4 forced host devices, its
``crosspod_psum_compressed`` inside ``shard_map`` over 2 and 4 pods) come
from one subprocess, the ``ref_groups`` fixture.

Tolerances, each with its reason:
- the compressed reduction: bit for bit, grouped against stacked, numpy
  and the reference (the quantizer is the same float32 expression, the
  int32 sum and the max are exact);
- the GPipe schedule: grouped against one group bit for bit (each group
  applies its stages one after another, so every grouping does the same
  arithmetic); against the reference's 4-device run ``atol=1e-5``, the
  reference test's tolerance; gradients against the stages in turn
  ``rtol=1e-5, atol=1e-6`` (``tests/test_torch_substrate.py``'s);
- granite_moe SMOKE stages against the reference's layer loop on the
  same weights: ``tests/test_torch_lm.py``'s ``TOL`` (rtol 1e-4, atol
  1e-5), the same float32 function with its sums in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro.models import transformer as ref_tfm
from repro_torch.checkpoint import checkpointer
from repro_torch.checkpoint.checkpointer import leaves, tree_map
from repro_torch.distributed import (GridMesh, Mesh, StageGroups,
                                     axis_devices, card_groups, pipeline,
                                     place_stages, ppermute)
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.optim import grad_compression as gc
from repro_torch.runtime import elastic, train_loop
from test_torch_lm import TOL, both_params
from test_torch_substrate import crosspod_numpy, draws

CPU = torch.device("cpu")
META = torch.device("meta")
PIPES = [(4, 8), (2, 3), (4, 1)]           # (stages, microbatches)
PODS = (2, 4)
MB, D = 4, 16                              # microbatch rows, width
STEPS = 3                                  # error-feedback steps
REF_STEPS = 2                              # ... in the reference's run


def pipe_inputs(stages, micro):
    return (draws((stages, D, D), 100 + stages, 0.3),
            draws((micro, MB, D), 200 + 10 * stages + micro))


def pod_grads(pods):
    """A tree of gradients, pods first on each leaf; "s" is bfloat16."""
    return {"w": draws((pods, 16, 5), 300 + pods),
            "b": [draws((pods, 7), 310 + pods)],
            "s": draws((pods,), 320 + pods, 3.0)}


def as_torch(grads):
    out = tree_map(torch.from_numpy, grads)
    out["s"] = out["s"].to(torch.bfloat16)
    return out


REF_GROUPS = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.compat import shard_map
from repro.distributed.pipeline import pipeline_apply
from repro.optim.grad_compression import crosspod_psum_compressed

inp = dict(np.load({IN!r}))
out = {{}}
for S, M in {PIPES!r}:
    mesh = Mesh(np.array(jax.devices()[:S]), ("pipe",))
    got = pipeline_apply(lambda w, x: jnp.tanh(x @ w),
                         jnp.asarray(inp[f"pipe.{{S}}.{{M}}.w"]),
                         jnp.asarray(inp[f"pipe.{{S}}.{{M}}.x"]), mesh)
    out[f"pipe.{{S}}.{{M}}"] = np.asarray(got)
for pods in {PODS!r}:
    mesh = Mesh(np.array(jax.devices()[:pods]), ("pod",))
    g = {{"w": jnp.asarray(inp[f"pod.{{pods}}.w"]),
          "b": [jnp.asarray(inp[f"pod.{{pods}}.b"])],
          "s": jnp.asarray(inp[f"pod.{{pods}}.s"]).astype(jnp.bfloat16)}}
    e = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), g)
    # Not under jax.jit: there XLA fuses the error's g - q * scale, whose
    # last bits then differ from the same expression op by op.
    fn = shard_map(
        lambda g, e: crosspod_psum_compressed(g, e, "pod"), mesh=mesh,
        in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
        check_vma=False)
    for step in range({REF_STEPS}):
        red, e = fn(g, e)
        for k, a in (("w", red["w"]), ("b", red["b"][0]), ("s", red["s"]),
                     ("ew", e["w"]), ("eb", e["b"][0]), ("es", e["s"])):
            out[f"pod.{{pods}}.{{step}}.{{k}}"] = np.asarray(a)
np.savez({OUT!r}, **out)
print("REF_GROUPS_OK")
"""


@pytest.fixture(scope="session")
def ref_groups(tmp_path_factory):
    """The reference's ``pipeline_apply`` at each of PIPES on as many
    forced host devices, and its ``crosspod_psum_compressed`` inside
    ``shard_map`` at 2 and 4 pods over REF_STEPS steps (op by op, the
    subprocess's slow part), in one subprocess on 4 host devices."""
    d = tmp_path_factory.mktemp("ref_groups")
    inp = {}
    for S, M in PIPES:
        inp[f"pipe.{S}.{M}.w"], inp[f"pipe.{S}.{M}.x"] = pipe_inputs(S, M)
    for pods in PODS:
        g = pod_grads(pods)
        inp.update({f"pod.{pods}.w": g["w"], f"pod.{pods}.b": g["b"][0],
                    f"pod.{pods}.s": g["s"]})
    np.savez(d / "in.npz", **inp)
    code = REF_GROUPS.format(IN=str(d / "in.npz"), OUT=str(d / "out.npz"),
                             PIPES=PIPES, PODS=PODS, REF_STEPS=REF_STEPS)
    out = run_in_subprocess(code, devices=4, timeout=300)
    assert "REF_GROUPS_OK" in out
    return dict(np.load(d / "out.npz"))


def split(x, G):
    """A stacked tensor as a list of G per-group blocks."""
    return list(x.chunk(G))


def grouped(tree, G):
    return tree_map(lambda a: split(a, G), tree)


def join(tree):
    """A pod tree's per-group leaves (lists of G tensors) joined into the
    stacked layout."""
    return {"w": torch.cat(tree["w"]), "b": [torch.cat(tree["b"][0])],
            "s": torch.cat(tree["s"])}


# --------------------------------------------------------------- ppermute

@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("perm", ["ring", "shift", "swap", "none"])
def test_ppermute_moves_blocks_as_jax_lax_ppermute(perm, groups):
    """Position dst gets position src's block, positions that receive
    nothing get zeros; per-group lists give the stacked call's blocks, one
    tensor a group."""
    n = 4
    x = torch.from_numpy(draws((n, 3, 2), 7))
    pairs = {"ring": [(i, (i + 1) % n) for i in range(n)],
             "shift": [(i, i + 1) for i in range(n - 1)],
             "swap": [(0, 3), (3, 0), (1, 2)], "none": []}[perm]
    want = torch.zeros_like(x)
    for s, d in pairs:
        want[d] = x[s]
    stacked = ppermute(x, pairs)
    assert torch.equal(stacked, want)
    parts = ppermute(split(x, groups), pairs)
    assert isinstance(parts, list) and len(parts) == groups
    assert torch.equal(torch.cat(parts), want)


def test_ppermute_copies_blocks_to_the_receiving_group():
    """A block that crosses groups lands on the receiving group's device;
    a repeated source or destination, or one out of range, raises."""
    x = [torch.arange(6.0).reshape(2, 3), torch.zeros((2, 3), device=META)]
    out = ppermute(x, [(0, 2), (1, 0)])
    assert out[0].device == CPU and out[1].device == META
    assert out[1].shape == (2, 3)
    assert out[0].tolist() == [[3.0, 4.0, 5.0], [0.0, 0.0, 0.0]]
    for bad in ([(0, 1), (0, 2)], [(0, 1), (2, 1)], [(0, 4)]):
        with pytest.raises(ValueError, match="permutation"):
            ppermute(torch.zeros(4, 1), bad)


# ------------------------------------------------------------ mesh groups

def test_grid_mesh_groups_positions_in_row_major_order():
    """G devices over a grid's positions: consecutive positions share a
    device; ``axis_devices`` gives one device a group along an axis (the
    other axes at 0); G must divide the positions, and an axis whose
    positions fall into groups of other sizes raises."""
    g = GridMesh((2, 4), ("data", "pipe"), [CPU, META])
    assert g.devices == (CPU, META)
    assert axis_devices(g, "pipe") == (CPU,)
    assert axis_devices(g, "data") == (CPU, META)
    g = GridMesh((4, 2), ("pipe", "model"), ["cpu", "meta"])
    assert axis_devices(g, "pipe") == (CPU, META)
    assert axis_devices(g, "model") == (CPU,)
    g = GridMesh((2, 2, 2), ("pod", "data", "model"), [CPU] * 4)
    assert [len(axis_devices(g, a)) for a in g.axis_names] == [2, 2, 1]
    assert GridMesh((2, 4), ("a", "b"), CPU).device == CPU
    with pytest.raises(ValueError, match="device groups"):
        GridMesh((2, 4), ("a", "b"), [CPU, META]).device
    with pytest.raises(ValueError, match="do not divide"):
        GridMesh((2, 3), ("a", "b"), [CPU] * 4)
    with pytest.raises(ValueError, match="groups of one size"):
        axis_devices(GridMesh((4, 3), ("a", "b"), [CPU] * 6), "b")
    assert axis_devices(Mesh(4, [CPU, META], "pod"), "pod") == (CPU, META)


def test_build_mesh_places_positions_over_the_devices_given():
    """As the reference's ``np.asarray(devices[:n]).reshape(shape)``: n
    devices for n positions, the first n of more; fewer devices hold the
    positions in groups, which must divide them."""
    m = elastic.build_mesh((4,), ("pipe",), devices=[CPU, META] * 3)
    assert m == Mesh(4, [CPU, META, CPU, META], "pipe")
    m = elastic.build_mesh((4,), ("pipe",), devices=[CPU, META])
    assert axis_devices(m, "pipe") == (CPU, META)
    g = elastic.build_mesh((2, 4), ("data", "pipe"), devices=[CPU, META])
    assert isinstance(g, GridMesh) and g.devices == (CPU, META)
    with pytest.raises(ValueError, match="do not divide"):
        elastic.build_mesh((4,), ("pipe",), devices=[CPU] * 3)


@pytest.mark.parametrize("cards,shape,want", [
    (0, (4,), ("cuda",)), (1, (4,), ("cuda",)),
    (4, (4,), ("cuda:0", "cuda:1", "cuda:2", "cuda:3")),
    (4, (6,), ("cuda:0", "cuda:1", "cuda:2")), (2, (3,), ("cuda",)),
    (4, (2, 16, 16), ("cuda:0", "cuda:1", "cuda:2", "cuda:3")),
    (8, (2,), ("cuda:0", "cuda:1"))])
def test_build_mesh_defaults_to_a_group_a_visible_card(monkeypatch, cards,
                                                       shape, want):
    """Without devices: G = the largest divisor of the positions at most
    the visible cards, on cuda:0 .. cuda:G-1; one group on ``cuda``,
    unchecked, when G is 1 (no card visible included)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    want = tuple(torch.device(d) for d in want)
    assert card_groups(int(np.prod(shape))) == want
    axes = ("pod", "data", "model")[-len(shape):]
    assert elastic.build_mesh(shape, axes).devices == want


# ---------------------------------------------------- compressed reduction

def run_crosspod(grads, G, pods, steps=STEPS):
    """STEPS steps over a mesh of ``pods`` pods in G groups on the CPU:
    each step's reduced gradients and errors, every leaf's groups joined."""
    mesh = Mesh(pods, [CPU] * G, "pod")
    g = grads if G == 1 else grouped(grads, G)
    e = gc.init_error_state(g)
    out = []
    for _ in range(steps):
        red, e = gc.crosspod_psum_compressed(g, e, "pod", mesh=mesh)
        if G > 1:
            assert all(isinstance(x, list) and len(x) == G
                       for x in (red["w"], red["b"][0], e["s"]))
        out.append((red, e) if G == 1 else (join(red), join(e)))
    return out


@pytest.mark.parametrize("pods,groups", [(2, 1), (2, 2), (4, 1), (4, 2),
                                         (4, 4)])
def test_crosspod_in_groups_equals_stacked_and_numpy(pods, groups):
    """The pods in G groups over three steps of error feedback: the
    reduced gradients and errors bit-equal to the stacked call (no mesh)
    and to numpy's reduction; every pod holds the same result."""
    grads = as_torch(pod_grads(pods))
    got = run_crosspod(grads, groups, pods)
    e = gc.init_error_state(grads)
    want_e = [np.zeros(x.shape, np.float32) for x in leaves(grads)]
    for red, err in got:
        sr, e = gc.crosspod_psum_compressed(grads, e, "pod")
        for i, (g, r, ee, s_r, s_e) in enumerate(zip(
                leaves(grads), leaves(red), leaves(err), leaves(sr),
                leaves(e))):
            want_r, want_e[i] = crosspod_numpy(g.float().numpy(), want_e[i])
            assert r.dtype == torch.float32 and r.shape == g.shape
            assert torch.equal(r, s_r) and torch.equal(ee, s_e)
            assert np.array_equal(r.numpy(), want_r)
            assert np.array_equal(ee.numpy(), want_e[i])
            assert all(torch.equal(r[0], r[p]) for p in range(pods))


@pytest.mark.parametrize("pods,groups", [(2, 1), (2, 2), (4, 1), (4, 2),
                                         (4, 4)])
def test_crosspod_in_groups_equals_reference_shard_map(ref_groups, pods,
                                                       groups):
    """The reference's ``crosspod_psum_compressed`` inside ``shard_map``,
    one pod a host device: each step's reduced gradients and errors equal
    the port's grouped run bit for bit."""
    got = run_crosspod(as_torch(pod_grads(pods)), groups, pods, REF_STEPS)
    for step, (red, err) in enumerate(got):
        for k, a in (("w", red["w"]), ("b", red["b"][0]), ("s", red["s"]),
                     ("ew", err["w"]), ("eb", err["b"][0]),
                     ("es", err["s"])):
            want = ref_groups[f"pod.{pods}.{step}.{k}"]
            assert a.numpy().tobytes() == want.tobytes(), (step, k)


def test_crosspod_checks_the_grouped_layout():
    """Over 2 groups every leaf must be a list of 2 tensors on the groups'
    devices; without a mesh a list leaf is a tree node (the stacked
    layout)."""
    mesh = Mesh(4, [CPU, CPU], "pod")
    x = torch.from_numpy(draws((4, 3), 1))
    with pytest.raises(ValueError, match="list of 2"):
        gc.crosspod_psum_compressed({"a": x}, {"a": x * 0}, "pod", mesh)
    with pytest.raises(ValueError, match="list of 2"):
        gc.crosspod_psum_compressed({"a": split(x, 4)},
                                    {"a": split(x * 0, 4)}, "pod", mesh)
    on_meta = Mesh(4, [CPU, META], "pod")
    with pytest.raises(ValueError, match="groups are on"):
        gc.crosspod_psum_compressed({"a": split(x, 2)},
                                    {"a": split(x * 0, 2)}, "pod", on_meta)
    red, _ = gc.crosspod_psum_compressed([x[:2], x[2:]],
                                         [x[:2] * 0, x[2:] * 0], "pod")
    assert not torch.equal(red[0][0], red[1][0])   # two stacked leaves


# --------------------------------------------------------------- pipeline

def tanh_stage(w, x):
    return torch.tanh(x @ w)


def run_pipe(stages, micro, groups, Ws=None, xs=None):
    if Ws is None:
        Ws, xs = map(torch.from_numpy, pipe_inputs(stages, micro))
    mesh = elastic.build_mesh((stages,), ("pipe",), devices=[CPU] * groups)
    return pipeline.pipeline_apply(tanh_stage, Ws, xs, mesh)


@pytest.mark.parametrize("stages,micro,groups",
                         [(s, m, g) for s, m in PIPES
                          for g in range(1, s + 1) if s % g == 0])
def test_pipeline_in_groups_equals_one_group(stages, micro, groups):
    """P stages over every G dividing P: the outputs bit-equal to one
    group's, and to the stages applied in turn (each group applies its
    stages one after another, so the arithmetic is the same)."""
    Ws, xs = map(torch.from_numpy, pipe_inputs(stages, micro))
    out = run_pipe(stages, micro, groups)
    assert out.shape == xs.shape
    assert torch.equal(out, run_pipe(stages, micro, 1))
    seq = xs
    for i in range(stages):
        seq = torch.stack([tanh_stage(Ws[i], x) for x in seq])
    assert torch.equal(out, seq)


@pytest.mark.parametrize("stages,micro", PIPES)
@pytest.mark.parametrize("groups", [1, 2])
def test_pipeline_in_groups_equals_reference_on_devices(ref_groups, stages,
                                                        micro, groups):
    """The reference's ``pipeline_apply``, one stage a host device under
    ``shard_map``, against the port's groups: within the reference test's
    atol 1e-5."""
    out = run_pipe(stages, micro, groups)
    np.testing.assert_allclose(out.numpy(),
                               ref_groups[f"pipe.{stages}.{micro}"],
                               rtol=0, atol=1e-5)


def test_place_stages_views_on_the_same_device_and_copies_to_another():
    """A group on the tree's device holds views of its block (no copy); a
    group on another device a copy of its block alone; the placed stages
    run as the stacked tree does, and stages placed for another mesh
    raise."""
    P = 4
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(P, D, D, generator=g),
              "b": torch.randn(P, D, generator=g)}
    mesh = elastic.build_mesh((P,), ("pipe",), devices=[CPU, META])
    placed = place_stages(params, mesh)
    assert isinstance(placed, StageGroups) and placed.devices == (CPU, META)
    assert placed.groups[0]["w"].data_ptr() == params["w"].data_ptr()
    assert placed.groups[1]["b"].device == META
    assert placed.groups[1]["w"].shape == (2, D, D)
    two = elastic.build_mesh((P,), ("pipe",), devices=[CPU, CPU])
    placed = place_stages(params, two)
    assert placed.groups[1]["w"].data_ptr() == params["w"][2].data_ptr()
    xs = torch.randn(3, 2, D, generator=g)

    def fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    assert torch.equal(pipeline.pipeline_apply(fn, placed, xs, two),
                       pipeline.pipeline_apply(fn, params, xs, two))
    with pytest.raises(ValueError, match="placed on"):
        pipeline.pipeline_apply(fn, placed, xs, Mesh(P, CPU, "pipe"))
    with pytest.raises(ValueError, match="lead with"):
        place_stages({"w": params["w"][:3]}, two)


def test_pipeline_gradients_across_groups():
    """The gradient through a 2-group schedule (stages on a ``GridMesh``'s
    ``pipe`` axis, 2 groups along it) equals the stages applied in turn."""
    P, Dm = 4, 8
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(P, Dm, Dm, generator=g) * 0.3,
              "b": torch.randn(P, Dm, generator=g)}
    xs = torch.randn(5, 2, Dm, generator=g)
    mesh = elastic.build_mesh((P, 2), ("pipe", "data"), devices=[CPU] * 2)
    assert len(axis_devices(mesh, "pipe")) == 2

    def fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    ws = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    pipeline.pipeline_apply(fn, ws, xs, mesh).square().sum().backward()
    seq = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y = xs
    for i in range(P):
        y = fn({k: v[i] for k, v in seq.items()}, y)
    y.square().sum().backward()
    for k in params:
        np.testing.assert_allclose(ws[k].grad.numpy(), seq[k].grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


def granite_stage(cfg):
    """One GPipe stage of the transformer: its layers' ``_block`` in turn
    over hidden states (positions 0..S-1)."""
    def stage(layers, x):
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for lp in L.tree_unstack(layers):
            x = tfm._block(cfg, x, positions, lp)[0]
        return x
    return stage


@pytest.mark.parametrize("groups", [1, 2])
def test_granite_moe_smoke_pipeline(groups):
    """granite_moe SMOKE's 2 layers as 2 stages of 1 layer over 3
    microbatches of hidden states: bit-equal to the stages applied in
    turn, and within ``TOL`` of the reference's layer loop (``_block``
    over its layers) on the same weights."""
    ref_cfg, cfg, rp, pp = both_params("granite_moe")
    P, M, S = 2, 3, 8
    xs = draws((M, 1, S, cfg.d_model), 400)
    stacked = tree_map(lambda a: a.reshape(P, -1, *a.shape[1:]),
                       pp["layers"])
    stage = granite_stage(cfg)
    mesh = elastic.build_mesh((P,), ("pipe",), devices=[CPU] * groups)
    with torch.no_grad():
        out = pipeline.pipeline_apply(stage, place_stages(stacked, mesh),
                                      torch.from_numpy(xs), mesh)
        seq = []
        for x in torch.from_numpy(xs):
            for i in range(P):
                x = stage(tree_map(lambda a, i=i: a[i], stacked), x)
            seq.append(x)
    assert torch.equal(out, torch.stack(seq))
    positions = jnp.arange(S)[None, :]
    for m in range(M):
        x = jnp.asarray(xs[m])
        for i in range(cfg.n_layers):
            lp = tree_map(lambda a, i=i: a[i], rp["layers"])
            x = ref_tfm._block(ref_cfg, x, positions, lp)[0]
        np.testing.assert_allclose(out[m].numpy(), np.asarray(x), **TOL)


# ---------------------------------------------------------------- restore

def test_checkpoint_elastic_reshard(tmp_path):
    """The reference's ``test_checkpoint_elastic_reshard`` on the port:
    restore with an explicit one-device placement; ``like`` on ``meta``
    (its structure, shapes and dtypes only) shows the leaf was placed;
    ``None`` keeps ``like``'s device."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    checkpointer.save(str(tmp_path), 5, tree)
    like = tree_map(lambda a: a.to(META), tree)
    back = checkpointer.restore(str(tmp_path), 5, like, {"w": CPU})
    assert back["w"].device == CPU
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"].numpy())
    assert checkpointer.restore(str(tmp_path), 5, like,
                                {"w": None})["w"].device == META
    assert checkpointer.restore(str(tmp_path), 5, like)["w"].device == META
    for bad in ({"w": [CPU, CPU]}, [CPU], {"v": CPU}):
        with pytest.raises(ValueError, match="structure"):
            checkpointer.restore(str(tmp_path), 5, like, bad)


def test_elastic_restart_from_two_groups_onto_one_device(tmp_path):
    """State saved from 2 groups (the pods' error-feedback state and
    reduced gradients after two steps, each leaf a list of 2 per-group
    tensors), then a remesh to one device (``plan_remesh(1)``,
    ``build_mesh``) and ``resume_or_init`` onto it: every leaf on the new
    mesh's device, bit-equal to the saved leaves, the groups joined equal
    to a one-group run's state."""
    pods = 4
    grads = as_torch(pod_grads(pods))
    mesh = Mesh(pods, [CPU, CPU], "pod")
    g = grouped(grads, 2)
    e = gc.init_error_state(g)
    for _ in range(2):
        red, e = gc.crosspod_psum_compressed(g, e, "pod", mesh=mesh)
    state = {"errors": e, "reduced": red}
    checkpointer.save(str(tmp_path), 2, state)
    shape, axes = elastic.plan_remesh(1)
    one = elastic.build_mesh(shape, axes, devices=[CPU])
    assert (shape, one.device) == ((1,), CPU)
    like = tree_map(lambda a: a.to(META), state)
    back, step = train_loop.resume_or_init(
        str(tmp_path), like, tree_map(lambda _: one.device, like))
    assert step == 2
    for a, b in zip(leaves(back), leaves(state), strict=True):
        assert a.device == CPU and a.dtype == b.dtype
        assert torch.equal(a, b)
    e1 = gc.init_error_state(grads)
    for _ in range(2):
        r1, e1 = gc.crosspod_psum_compressed(grads, e1, "pod")
    joined = leaves(join(back["errors"])) + leaves(join(back["reduced"]))
    for a, b in zip(joined, leaves(e1) + leaves(r1), strict=True):
        assert torch.equal(a, b)
    fresh, s0 = train_loop.resume_or_init(str(tmp_path / "none"), like,
                                          tree_map(lambda _: CPU, like))
    assert fresh is like and s0 == 0
