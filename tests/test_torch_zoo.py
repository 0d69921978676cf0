"""The graph-learning model zoo on the port, held against the reference on
the CPU.

Each arch of the zoo (``ZOO_ARCHS``, the GNN and recsys archs of
``repro_torch.configs.ARCHS``: SchNet, PNA, MeshGraphNet, MACE, DCN-v2) runs at its ``SMOKE`` config on the reference's smoke
batches (``tests/test_arch_smoke.py``), from the reference's parameters
(``jax.random.PRNGKey(0)``, carried across with
``layers.tree_from_reference``), through the JAX function and the port's.

Tolerances, each with its reason:
- forward outputs ``rtol=1e-4, atol=1e-5``, the loss ``rtol=1e-5``, every
  gradient leaf ``rtol=1e-3, atol=1e-6``: matmuls and XLA's scatter sum in
  another order than the port's kernels and BLAS;
- PNA: outputs ``rtol=1e-4`` and gradients ``rtol=1e-3``, each with an
  ``atol`` of 1e-4 times the array's largest magnitude.  The std
  aggregator ``sqrt(max(E[m²] - E[m]², 0) + 1e-6)`` cancels: where a
  segment's messages are (nearly) equal, ``E[m²] - E[m]²`` is a
  difference of nearly equal numbers (exactly 0 for a node with one
  in-edge or duplicated edges, whose gradient ``2·msg·g - 2·mean·g`` is
  an exact cancellation too), and the slope of ``sqrt(v + 1e-6)`` near 0
  (up to 500) scales each package's rounding residue of the messages
  into the output and the gradients.  Without such segments the plain
  tolerances hold (``test_pna_plain_tolerance_without_zero_variance``);
- MACE with ``message_dtype="bf16"``: ``rtol=2e-2`` (the reference sums
  the messages in bfloat16; the kernels sum them in float32);
- equivariance: the reference's own ``rtol=atol=2e-4``.
Knobs that change no value (``scan_layers``, ``remat``) are compared bit
for bit within the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.gnn as ref_gnn
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_arch as ref_get_arch
from repro.data import pipeline as ref_pipe
from repro.graph import datasets as ref_datasets
from repro.models.recsys import dcn as ref_dcn
from repro.models.recsys import embedding as ref_emb
import repro_torch.models.gnn as gnn
from repro_torch.checkpoint.checkpointer import flatten_with_paths, unflatten
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.rng import seeded_generator
from repro_torch.graph import make_cora_like
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.segment_sum import ops as ss_ops
from repro_torch.models import layers as L
from repro_torch.models.gnn import common
from repro_torch.models.recsys import dcn
from repro_torch.models.recsys import embedding as emb

KEY = jax.random.PRNGKey(0)
FWD = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)
GNN_ARCHS = ("schnet", "pna", "meshgraphnet", "mace")
ZOO_ARCHS = tuple(a for a in ARCHS if get_arch(a).FAMILY != "lm")
LM_NAMES = ("phi35_moe", "granite_moe", "deepseek_7b", "minitron_8b",
            "stablelm_12b", "phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m",
            "deepseek-7b", "minitron-8b", "stablelm-12b")


def modules(arch):
    if arch == "dcn_v2":
        return ref_dcn, dcn
    return getattr(ref_gnn, arch), getattr(gnn, arch)


@functools.lru_cache(maxsize=None)
def ref_params(arch, cfg):
    """The reference's parameters for ``cfg`` from ``KEY`` (one jitted
    init, compiled at XLA's lowest backend optimization: it only makes
    the weights, which the port then takes as they are)."""
    m, _ = modules(arch)
    p = jax.jit(functools.partial(m.init_params, cfg=cfg),
                compiler_options={"xla_backend_optimization_level": 0})(KEY)
    return jax.tree.map(np.asarray, p)


def smoke_batch(arch, cfg):
    """The reference's smoke batch for ``arch`` (numpy)."""
    if arch in ("schnet", "mace"):
        return ref_pipe.molecule_batch(12, 40, 4)
    if arch == "dcn_v2":
        return ref_pipe.recsys_batch(16, cfg.n_dense, cfg.n_sparse,
                                     cfg.vocabs())
    return ref_pipe.gnn_batch(100, 400, cfg.node_in, d_edge=4, n_classes=5)


def to_torch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def assert_ids_in_range(arch, batch):
    """The models never hand the kernels an id outside the table (the
    segment sum would drop it, the embedding bag clamp it)."""
    if "edge_index" in batch:
        n = batch["species" if "species" in batch else "node_feats"].shape[0]
        assert 0 <= batch["edge_index"].min() and batch["edge_index"].max() < n
    if "mol_id" in batch:
        assert batch["mol_id"].max() < batch["energies"].shape[0]
    if "sparse" in batch:
        assert batch["sparse"].min() >= 0


def forward(arch, m, params, b, cfg):
    """The arch's forward output on batch ``b`` (either package's arrays)."""
    if arch in ("schnet", "mace"):
        return m.apply(params, b["species"], b["positions"], b["edge_index"],
                       cfg, b["mol_id"], b["energies"].shape[0])
    if arch == "meshgraphnet":
        return m.apply(params, b["node_feats"], b["edge_feats"],
                       b["edge_index"], cfg)
    if arch == "pna":
        return m.apply(params, b["node_feats"], b["edge_index"], cfg)
    return m.predict(params, b["dense"], b["sparse"], cfg)


@functools.lru_cache(maxsize=None)
def ref_step(arch, cfg):
    """The reference's forward, loss and gradients as one jitted function
    of (params, batch), compiled once per (arch, config, shapes)."""
    m, _ = modules(arch)

    def f(params, b):
        loss, grads = jax.value_and_grad(m.train_loss)(params, b, cfg)
        return forward(arch, m, params, b, cfg), loss, grads
    return jax.jit(f)


def ref_run(arch, cfg, params, b):
    out, loss, grads = ref_step(arch, cfg)(params,
                                           jax.tree.map(jnp.asarray, b))
    paths, leaves, _ = _flatten_with_paths(grads)
    return np.asarray(out), (float(loss), paths,
                             [np.asarray(x) for x in leaves])


def port_loss_grads(m, params, b, cfg):
    leaves = [p.detach().clone().requires_grad_(True)
              for _, p in flatten_with_paths(params)]
    loss = m.train_loss(unflatten(params, iter(leaves)), to_torch(b), cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    paths = [p for p, _ in flatten_with_paths(params)]
    return float(loss.detach()), paths, [g.numpy() for g in grads]


def assert_out_close(got, want, arch):
    atol = 1e-4 * float(np.abs(want).max()) if arch == "pna" else FWD["atol"]
    np.testing.assert_allclose(got, want, rtol=FWD["rtol"], atol=atol)


def assert_grads_close(ref, port, scaled_atol=None):
    _, ref_paths, ref_g = ref
    _, port_paths, port_g = port
    assert port_paths == ref_paths
    for path, want, got in zip(ref_paths, ref_g, port_g):
        assert got.shape == want.shape, path
        assert np.all(np.isfinite(got)), path
        atol = GRAD["atol"] if scaled_atol is None \
            else scaled_atol * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=GRAD["rtol"], atol=atol,
                                   err_msg=path)


def run_both(arch, cfg_ref, cfg_port, b, params=None):
    """Forward, loss and gradients of both packages on one batch, from the
    reference's parameters for ``cfg_ref``."""
    _, m_port = modules(arch)
    rp = params if params is not None else ref_params(arch, cfg_ref)
    pp = L.tree_from_reference(rp)
    want, ref = ref_run(arch, cfg_ref, rp, b)
    got = forward(arch, m_port, pp, to_torch(b), cfg_port).detach().numpy()
    return (want, got), ref, port_loss_grads(m_port, pp, b, cfg_port)


# ------------------------------------------------------------- the archs

def test_archs_and_configs_equal_the_reference():
    from repro.configs import ARCHS as REF_ARCHS
    assert ARCHS == REF_ARCHS
    assert ZOO_ARCHS == ("meshgraphnet", "schnet", "pna", "mace", "dcn_v2")
    for arch in ZOO_ARCHS:
        ref, port = ref_get_arch(arch), get_arch(arch)
        assert port.FAMILY == ref.FAMILY
        for name in ("FULL", "SMOKE"):
            assert dataclasses.asdict(getattr(port, name)) == \
                dataclasses.asdict(getattr(ref, name)), (arch, name)
        assert {k: (c.name, c.kind, c.dims) for k, c in port.SHAPES.items()} \
            == {k: (c.name, c.kind, c.dims) for k, c in ref.SHAPES.items()}
    assert get_arch("dcn-v2") is get_arch("dcn_v2")
    assert get_arch("ridgewalker").FAMILY == "walk"


def _lm_config_fields(cfg):
    """A language model's config as a dict, its dtype by name (jnp's and
    torch's dtypes are different objects)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix("torch.")
    return d


@pytest.mark.parametrize("name", LM_NAMES)
def test_language_models_resolve(name):
    """Each language-model arch and alias resolves to the port's config
    module, with FULL, SMOKE and SHAPES equal to the reference's."""
    ref, port = ref_get_arch(name), get_arch(name)
    assert port.__name__ == ref.__name__.replace("repro.", "repro_torch.", 1)
    assert port.FAMILY == ref.FAMILY == "lm"
    for cfg in ("FULL", "SMOKE"):
        assert _lm_config_fields(getattr(port, cfg)) == \
            _lm_config_fields(getattr(ref, cfg)), (name, cfg)
    assert {k: (c.name, c.kind, c.dims) for k, c in port.SHAPES.items()} \
        == {k: (c.name, c.kind, c.dims) for k, c in ref.SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        get_arch("resnet")


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_smoke_arch_equals_reference(arch):
    cfg = get_arch(arch).SMOKE
    b = smoke_batch(arch, cfg)
    assert_ids_in_range(arch, b)
    (want, got), ref, port = run_both(arch, ref_get_arch(arch).SMOKE, cfg, b)
    assert got.shape == want.shape
    assert_out_close(got, want, arch)
    np.testing.assert_allclose(port[0], ref[0], **LOSS)
    assert_grads_close(ref, port, scaled_atol=1e-4 if arch == "pna" else None)


def test_pna_plain_tolerance_without_zero_variance():
    """Every node receives 4 distinct messages: no zero-variance segment,
    so PNA's gradients hold the plain tolerance."""
    cfg = get_arch("pna").SMOKE
    rng = np.random.default_rng(5)
    b = smoke_batch("pna", cfg)
    src = np.concatenate([rng.choice(np.delete(np.arange(100), i), 4,
                                     replace=False) for i in range(100)])
    b["edge_index"] = np.stack([src, np.repeat(np.arange(100), 4)]) \
        .astype(np.int32)
    (want, got), ref, port = run_both("pna", ref_get_arch("pna").SMOKE, cfg,
                                      b)
    np.testing.assert_allclose(got, want, **FWD)
    assert_grads_close(ref, port)


# ----------------------------------------------------------------- knobs

@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_mace_propagate_lmax(lmax):
    cfg = dataclasses.replace(get_arch("mace").SMOKE, propagate_lmax=lmax,
                              edges_sorted=lmax == 1)
    ref_cfg = dataclasses.replace(ref_get_arch("mace").SMOKE,
                                  propagate_lmax=lmax)
    b = smoke_batch("mace", cfg)
    (want, got), ref, port = run_both(
        "mace", ref_cfg, cfg, b,
        params=ref_params("mace", ref_get_arch("mace").SMOKE))
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(port[0], ref[0], **LOSS)
    assert_grads_close(ref, port)


def test_mace_bf16_messages():
    cfg = dataclasses.replace(get_arch("mace").SMOKE, message_dtype="bf16")
    ref_cfg = dataclasses.replace(ref_get_arch("mace").SMOKE,
                                  message_dtype="bf16")
    b = smoke_batch("mace", cfg)
    rp = ref_params("mace", ref_get_arch("mace").SMOKE)
    want, _ = ref_run("mace", ref_cfg, rp, b)
    got = forward("mace", gnn.mace, L.tree_from_reference(rp), to_torch(b),
                  cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-2)


def test_pna_isolated_nodes():
    """Half the nodes receive no edge: their max/min segments hold -inf,
    masked to 0, and no gradient picks up a NaN."""
    cfg = get_arch("pna").SMOKE
    b = smoke_batch("pna", cfg)
    b["edge_index"] = (b["edge_index"] % 50).astype(np.int32)
    (want, got), ref, port = run_both("pna", ref_get_arch("pna").SMOKE, cfg,
                                      b)
    mx = common.scatter_max(torch.ones((4, 2)), torch.tensor([0, 0, 2, 2]), 4)
    assert torch.equal(mx[:, 0], torch.tensor([1.0, -np.inf, 1.0, -np.inf]))
    assert_out_close(got, want, "pna")
    assert_grads_close(ref, port, scaled_atol=1e-4)


def test_pna_duplicated_edges_split_max_ties():
    """Every edge twice (the sampler draws with replacement): identical
    messages tie in the max and min, whose gradient both packages split
    evenly among the tied rows."""
    cfg = get_arch("pna").SMOKE
    b = smoke_batch("pna", cfg)
    b["edge_index"] = np.concatenate([b["edge_index"]] * 2, axis=1)
    (want, got), ref, port = run_both("pna", ref_get_arch("pna").SMOKE, cfg,
                                      b)
    assert_out_close(got, want, "pna")
    assert_grads_close(ref, port, scaled_atol=1e-4)
    # the tie rule itself, exactly
    msg = torch.tensor([[1.0], [1.0], [0.5]], requires_grad=True)
    common.scatter_max(msg, torch.tensor([0, 0, 0]), 1).sum().backward()
    g = jax.grad(lambda x: jax.ops.segment_max(x, jnp.array([0, 0, 0]),
                                               num_segments=1).sum())(
        jnp.array([[1.0], [1.0], [0.5]]))
    np.testing.assert_array_equal(msg.grad.numpy(), np.asarray(g))
    assert msg.grad[:, 0].tolist() == [0.5, 0.5, 0.0]


@pytest.mark.parametrize("arch,knob", [("schnet", "scan_layers"),
                                       ("pna", "scan_layers"),
                                       ("meshgraphnet", "remat")])
def test_value_free_knobs(arch, knob):
    """``scan_layers`` and ``remat`` change no number: the port's two
    settings give the same bits, and the other setting also matches the
    reference's run with it."""
    base = get_arch(arch).SMOKE
    off = dataclasses.replace(base, **{knob: False})
    ref_off = dataclasses.replace(ref_get_arch(arch).SMOKE, **{knob: False})
    b = smoke_batch(arch, base)
    m = getattr(gnn, arch)
    pp = L.tree_from_reference(ref_params(arch, ref_get_arch(arch).SMOKE))
    on_loss = port_loss_grads(m, pp, b, base)
    off_loss = port_loss_grads(m, pp, b, off)
    assert on_loss[0] == off_loss[0]
    for a, c in zip(on_loss[2], off_loss[2]):
        np.testing.assert_array_equal(a, c)
    (want, got), ref, port = run_both(
        arch, ref_off, off, b,
        params=ref_params(arch, ref_get_arch(arch).SMOKE))
    assert_out_close(got, want, arch)
    assert_grads_close(ref, port, scaled_atol=1e-4 if arch == "pna" else None)


# ----------------------------------------------------------- equivariance

def _rotation(seed=3):
    a, b, c = np.random.default_rng(seed).random(3) * 2 * np.pi
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                   [0, np.sin(c), np.cos(c)]])
    return torch.tensor((Rz @ Ry @ Rx).astype(np.float32))


@pytest.mark.parametrize("arch,cfg,shift", [
    ("mace", gnn.mace.MACEConfig(n_layers=2, d_hidden=8, n_rbf=4), 1.5),
    ("schnet", gnn.schnet.SchNetConfig(n_interactions=2, d_hidden=16,
                                       n_rbf=16), -0.3)])
def test_rotation_invariance(arch, cfg, shift):
    """E(3): rotating and translating every position leaves the energies
    unchanged (the reference's ``tests/test_models.py`` check, on the
    port, with the port's own initialisation)."""
    rng = np.random.default_rng(0)
    m = getattr(gnn, arch)
    p = m.init_params(seeded_generator(0), cfg, device="cpu")
    N, E = 20, 60
    species = torch.tensor(rng.integers(0, 5, N), dtype=torch.int32)
    pos = torch.tensor(rng.random((N, 3), np.float32) * 3)
    ei = torch.tensor(np.stack([rng.integers(0, N, E),
                                rng.integers(0, N, E)]), dtype=torch.int32)
    e1 = m.apply(p, species, pos, ei, cfg)
    e2 = m.apply(p, species, pos @ _rotation().T + shift, ei, cfg)
    np.testing.assert_allclose(e1.detach().numpy(), e2.detach().numpy(),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------- recsys

def test_dcn_retrieval_and_bags_equal_reference():
    cfg = get_arch("dcn_v2").SMOKE
    rp = ref_params("dcn_v2", ref_get_arch("dcn_v2").SMOKE)
    pp = L.tree_from_reference(rp)
    b = smoke_batch("dcn_v2", cfg)
    rb, pb = jax.tree.map(jnp.asarray, b), to_torch(b)
    want = ref_dcn.user_embedding(rp, rb["dense"], rb["sparse"], cfg)
    got = dcn.user_embedding(pp, pb["dense"], pb["sparse"], cfg)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    cands = np.random.default_rng(1).standard_normal(
        (100, cfg.retrieval_dim)).astype(np.float32)
    want = ref_dcn.retrieval_scores(rp, rb["dense"][:1], rb["sparse"][:1],
                                    jnp.asarray(cands), cfg)
    got = dcn.retrieval_scores(pp, pb["dense"][:1], pb["sparse"][:1],
                               torch.tensor(cands), cfg)
    assert got.shape == (1, 100)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    # multi-hot bags over one table, pad -1, with and without weights
    rng = np.random.default_rng(2)
    table = rp["tables"]["table_3"]
    idx = rng.integers(-1, table.shape[0], (9, 5)).astype(np.int32)
    w = rng.random((9, 5), np.float32)
    for weights in (None, w):
        want = ref_emb.lookup_bags(jnp.asarray(table), jnp.asarray(idx),
                                   None if weights is None
                                   else jnp.asarray(weights))
        tw = None if weights is None else torch.tensor(weights)
        for use_kernel in (False, True):
            got = emb.lookup_bags(torch.tensor(table), torch.tensor(idx),
                                  tw, use_kernel=use_kernel)
            np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_zoo_runs_on_the_kernels(monkeypatch):
    """A step's gathers and sums go through the two kernels' wrappers
    (their plain versions on the CPU), and the gradient of a gather is a
    segment sum, of a sum a gather."""
    calls = []
    real_eb, real_ss = eb_ops.ref.embedding_bag_ref, ss_ops.ref.segment_sum_ref
    monkeypatch.setattr(eb_ops.ref, "embedding_bag_ref",
                        lambda *a: calls.append("eb") or real_eb(*a))
    monkeypatch.setattr(ss_ops.ref, "segment_sum_ref",
                        lambda *a: calls.append("ss") or real_ss(*a))
    eb_ops.reset_launches()
    ss_ops.reset_launches()
    cfg = get_arch("schnet").SMOKE
    pp = L.tree_from_reference(ref_params("schnet",
                                          ref_get_arch("schnet").SMOKE))
    port_loss_grads(gnn.schnet, pp, smoke_batch("schnet", cfg), cfg)
    n = cfg.n_interactions
    # forward: gathers of embed, both positions and x[src] a layer; sums a
    # layer and the energies.  Backward: a sum for each gather that needs
    # a gradient (not the positions'), a gather for each sum.
    assert calls.count("eb") == (3 + n) + (n + 1)
    assert calls.count("ss") == (n + 1) + (1 + n)
    # nothing launched: CPU tensors run the plain versions
    assert eb_ops.LAUNCHES["embedding_bag"] == 0
    assert ss_ops.LAUNCHES["segment_sum"] == 0


# --------------------------------------------------- full configs, shapes

def _dry_run_widths(cell):
    """``launch/specs.py:_gnn_batch_structs``' feature width for a cell."""
    if cell == "minibatch_lg":
        return 602
    if cell == "molecule":
        return 16
    return get_arch("pna").SHAPES[cell].dims.get("d_feat", 16)


def _full_configs():
    out = []
    for arch in ZOO_ARCHS:
        cells = [None]
        if arch in ("pna", "meshgraphnet"):
            cells = list(get_arch(arch).SHAPES)
        for cell in cells:
            out.append((arch, cell))
    return out


@pytest.mark.parametrize("arch,cell", _full_configs())
def test_full_config_tree_equals_reference(arch, cell):
    """The ``FULL`` parameter tree (at the dry-run's widths for PNA and
    MeshGraphNet) has the reference's paths, shapes and dtypes: the
    reference's through ``jax.eval_shape``, the port's on ``meta``."""
    ref_cfg, cfg = ref_get_arch(arch).FULL, get_arch(arch).FULL
    if cell is not None:
        d = _dry_run_widths(cell)
        over = dict(node_in=d, edge_in=4) if arch == "meshgraphnet" \
            else dict(node_in=d, out_dim=47)
        ref_cfg = dataclasses.replace(ref_cfg, **over)
        cfg = dataclasses.replace(cfg, **over)
    m_ref, m_port = modules(arch)
    want = jax.eval_shape(functools.partial(m_ref.init_params, cfg=ref_cfg),
                          KEY)
    got = m_port.init_params(seeded_generator(0), cfg, device="meta")
    paths, leaves, _ = _flatten_with_paths(want)
    port = flatten_with_paths(got)
    assert [p for p, _ in port] == paths
    for (path, t), s in zip(port, leaves):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(s.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype), path


def test_cora_like_shapes():
    g, feats, labels = make_cora_like(0, device="cpu")
    cell = get_arch("pna").SHAPES["full_graph_sm"].dims
    assert g.num_vertices == cell["n_nodes"]
    assert feats.shape == (cell["n_nodes"], cell["d_feat"])
    assert labels.shape == (cell["n_nodes"],) and labels.max() < 7
    rg, _, _ = ref_datasets.make_cora_like(0)
    assert g.num_edges == rg.num_edges <= cell["n_edges"]
