"""Per-(arch × shape × mesh) step functions and their ``meta`` arguments,
the reference's ``repro.launch.specs``.

``build_cell`` returns ``(fn, args, donate, meta)``.  ``fn`` is the port's
own step: a training cell takes the gradient of the family's
``train_loss`` through autograd and applies ``optim.adamw`` in place
(``launch.train``'s ``make_lm_step`` / ``make_grad_step``); a prefill
cell is ``transformer.prefill``, a decode cell ``transformer.decode_step``,
a serve cell ``dcn.predict`` and a retrieval cell
``dcn.retrieval_scores``.  ``args`` is a :class:`CellArgs`: the
arguments as trees of ``meta`` tensors of the reference's global shapes
and dtypes, with ``args.specs`` the parallel trees of
:class:`~repro_torch.distributed.mesh.PartitionSpec` (each leaf's
placement, the reference's ``NamedSharding`` spec), ``args.mesh`` and
what the dry-run's collective rules read (``launch.dryrun``).  Running
``fn(*args)`` allocates nothing.

Bulk dims that must divide the mesh are padded up as the reference pads
them (recorded in ``meta``): the launcher does the same for real data.

A decode cell's ``cache_len`` is a ``meta`` scalar, which holds no value:
its step writes the new token at the cache's last slot, ``seq_len - 1``,
whose cost is that of any other slot (every step attends over the whole
cache under a mask).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.checkpointer import leaves, unflatten
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.core.rng import seeded_generator
from repro_torch.distributed.mesh import PartitionSpec as P
from repro_torch.distributed.mesh import axes_size
from repro_torch.launch.mesh import dp_axes, flat_axes
from repro_torch.launch.train import (make_gnn_step, make_lm_step,
                                      make_recsys_step)
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

META = torch.device("meta")


def _pad_up(n: int, div: int) -> int:
    return -(-n // div) * div


def _sds(shape, dtype):
    """A ``meta`` tensor of ``shape`` and ``dtype`` (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device=META)


def spec_leaves(spec_tree) -> list:
    """A tree of :class:`PartitionSpec`s' leaves in the reference's leaf
    order: a spec is a leaf, not a tuple to descend into."""
    if isinstance(spec_tree, P):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree)
                for s in spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, (tuple, list)):
        return [s for v in spec_tree for s in spec_leaves(v)]
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def _replicated(tree):
    """``P()`` for every leaf of ``tree``, in its structure."""
    return unflatten(tree, iter([P() for _ in leaves(tree)]))


class CellArgs(tuple):
    """A cell's arguments (trees of ``meta`` tensors), with the parallel
    ``specs``, the ``mesh``, and what the dry-run's collective rules
    read: the ``family`` and ``kind``, the config ``cfg``, the index of
    the batch-carrying argument ``batch_arg`` (its leading dimension is
    the batch) and the mesh axes ``batch_axes`` the batch is split over
    (the data axes for a language model; every axis for the graph and
    recsys families, whose bulk dims shard over every device)."""

    def __new__(cls, args, specs, mesh, family, kind, cfg, batch_arg,
                batch_axes):
        self = super().__new__(cls, args)
        self.specs = tuple(specs)
        self.mesh, self.family, self.kind, self.cfg = mesh, family, kind, cfg
        self.batch_arg, self.batch_axes = batch_arg, tuple(batch_axes)
        return self


def zero_spec(spec: P, shape, axis: str = "data", div: int = 16) -> P:
    """ZeRO-style optimizer-state sharding: add the data axis on the first
    unsharded, divisible dim (optimizer state must never be replicated
    across data-parallel replicas at this scale)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d % div == 0 and d >= div:
            entries[i] = axis
            break
    return P(*entries)


def _opt_specs(pspecs, pstruct):
    mu = unflatten(pstruct, iter([
        zero_spec(sp, st.shape)
        for sp, st in zip(spec_leaves(pspecs), leaves(pstruct), strict=True)]))
    return adamw.AdamWState(step=P(), mu=mu, nu=mu)


def _param_count(pstruct) -> int:
    return int(sum(leaf.numel() for leaf in leaves(pstruct)))


# ------------------------------- LM ---------------------------------------

def _lm_cell(mod, cell: ShapeCell, mesh, multi_pod: bool):
    cfg: tfm.TransformerConfig = mod.FULL
    dp = dp_axes(multi_pod)
    dpP = dp if len(dp) > 1 else dp[0]
    seq, gb = cell.dims["seq_len"], cell.dims["global_batch"]
    pspecs = tfm.param_specs(cfg)
    params = tfm.init_params(seeded_generator(0), cfg, device=META)
    meta = {"params": _param_count(params)}

    def cell_args(args, specs, donate, batch_arg):
        return CellArgs(args, specs, mesh, "lm", cell.kind, cfg, batch_arg,
                        dp), donate

    if cell.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        opt = adamw.init_state(params)
        ospecs = _opt_specs(pspecs, params)
        tok_spec = P(dpP, None)
        toks = _sds((gb, seq), torch.int32)
        lm_step = make_lm_step(cfg, opt_cfg)

        def step(params, opt_state, tokens, labels):
            (params, opt_state), aux = lm_step((params, opt_state),
                                               (tokens, labels))
            return params, opt_state, aux["loss"]

        args, donate = cell_args((params, opt, toks, toks),
                                 (pspecs, ospecs, tok_spec, tok_spec),
                                 (0, 1), 2)
        return step, args, donate, meta

    if cell.kind == "prefill":
        toks = _sds((gb, seq), torch.int32)

        def step(params, tokens):
            return tfm.prefill(params, tokens, cfg)

        args, donate = cell_args((params, toks), (pspecs, P(dpP, None)),
                                 (), 1)
        return step, args, donate, meta

    # decode: one new token against a seq_len KV cache
    bsz = gb
    cache_shape = (cfg.n_layers, 2, bsz, seq, cfg.n_kv_heads, cfg.d_head)
    dhead_mode = getattr(cfg, "decode_cache_shard", "seq") == "dhead"
    if bsz == 1:
        # long-context: sequence-shard the cache over every mesh axis
        cache_spec = P(None, None, None, flat_axes(multi_pod), None, None)
        tok_spec = P(None, None)
    elif dhead_mode:
        cache_spec = P(None, None, dpP, None, None, "model")
        tok_spec = P(dpP, None)
    else:
        cache_spec = P(None, None, dpP, "model", None, None)
        tok_spec = P(dpP, None)
    caches = _sds(cache_shape, cfg.dtype)
    token = _sds((bsz, 1), torch.int32)
    clen = _sds((), torch.int32)

    def step(params, token, caches, cache_len):
        return tfm.decode_step(params, token, caches, seq - 1, cfg)

    args, donate = cell_args((params, token, caches, clen),
                             (pspecs, tok_spec, cache_spec, P()), (2,), 1)
    return step, args, donate, meta


# ------------------------------- GNN --------------------------------------

def _gnn_batch_structs(arch: str, cell: ShapeCell, mesh, multi_pod: bool):
    fa = flat_axes(multi_pod)
    nchips = axes_size(mesh, fa)
    d = dict(cell.dims)
    if cell.name == "minibatch_lg":
        seeds = d["batch_nodes"]
        f1, f2 = d["fanout"]
        n_nodes = seeds + seeds * f1 + seeds * f1 * f2
        n_edges = seeds * f1 + seeds * f1 * f2
        d_feat = 602  # Reddit-like
    elif cell.name == "molecule":
        n_nodes = d["n_nodes"] * d["batch"]
        n_edges = d["n_edges"] * d["batch"]
        d_feat = 16
    else:
        n_nodes, n_edges = d["n_nodes"], d["n_edges"]
        d_feat = d.get("d_feat", 16)
    N = _pad_up(n_nodes, nchips)
    E = _pad_up(n_edges, nchips)
    nmol = _pad_up(d.get("batch", 1), nchips) if cell.name == "molecule" else 1
    geo = arch in ("schnet", "mace")
    b, s = {}, {}
    if geo:
        b["species"], s["species"] = _sds((N,), torch.int32), P(fa)
        b["positions"] = _sds((N, 3), torch.float32)
        s["positions"] = P(fa, None)
        b["energies"] = _sds((nmol,), torch.float32)
        s["energies"] = P(fa) if nmol >= nchips else P(None)
        b["mol_id"], s["mol_id"] = _sds((N,), torch.int32), P(fa)
    else:
        b["node_feats"] = _sds((N, d_feat), torch.float32)
        s["node_feats"] = P(fa, None)
        if arch == "meshgraphnet":
            b["edge_feats"] = _sds((E, 4), torch.float32)
            s["edge_feats"] = P(fa, None)
            b["targets"] = _sds((N, 3), torch.float32)
            s["targets"] = P(fa, None)
        else:
            b["labels"], s["labels"] = _sds((N,), torch.int32), P(fa)
    b["edge_index"] = _sds((2, E), torch.int32)
    s["edge_index"] = P(None, fa)
    meta = {"padded_nodes": N, "padded_edges": E, "d_feat": d_feat}
    return b, s, d_feat, meta


def _gnn_cell(arch, mod, cell: ShapeCell, mesh, multi_pod: bool):
    batch, bspecs, d_feat, meta = _gnn_batch_structs(arch, cell, mesh,
                                                     multi_pod)
    cfg = mod.FULL
    if arch == "meshgraphnet":
        cfg = dataclasses.replace(cfg, node_in=d_feat, edge_in=4)
        from repro_torch.models.gnn import meshgraphnet as m
    elif arch == "pna":
        cfg = dataclasses.replace(cfg, node_in=d_feat, out_dim=47)
        from repro_torch.models.gnn import pna as m
    elif arch == "schnet":
        from repro_torch.models.gnn import schnet as m
    else:
        from repro_torch.models.gnn import mace as m

    params = m.init_params(seeded_generator(0), cfg, device=META)
    meta["params"] = _param_count(params)
    opt = adamw.init_state(params)
    # GNN params are small: replicate (graph data dominates).
    grad_step = make_gnn_step(arch, cfg, adamw.AdamWConfig())

    def step(params, opt_state, batch):
        (params, opt_state), aux = grad_step((params, opt_state), batch)
        return params, opt_state, aux["loss"]

    args = CellArgs((params, opt, batch),
                    (_replicated(params), _replicated(opt), bspecs), mesh,
                    "gnn", cell.kind, cfg, 2, flat_axes(multi_pod))
    return step, args, (0, 1), meta


# ------------------------------ recsys ------------------------------------

def _recsys_cell(mod, cell: ShapeCell, mesh, multi_pod: bool):
    from repro_torch.models.recsys import dcn
    cfg = mod.FULL
    fa = flat_axes(multi_pod)
    nchips = axes_size(mesh, fa)

    params = dcn.init_params(seeded_generator(0), cfg, device=META)
    pspecs = _replicated(params)
    # embedding tables row-sharded over `model`
    pspecs["tables"] = {k: P("model", None) for k in params["tables"]}
    meta = {"params": _param_count(params)}

    B = _pad_up(cell.dims["batch"], nchips)
    bspec = fa if B >= nchips else None
    batch = {
        "dense": _sds((B, cfg.n_dense), torch.float32),
        "sparse": _sds((B, cfg.n_sparse), torch.int32),
        "labels": _sds((B,), torch.int32),
    }
    bspecs = {"dense": P(bspec, None), "sparse": P(bspec, None),
              "labels": P(bspec)}

    def cell_args(args, specs, batch_arg):
        return CellArgs(args, specs, mesh, "recsys", cell.kind, cfg,
                        batch_arg, fa)

    if cell.kind == "train":
        opt = adamw.init_state(params)
        ospecs = _opt_specs(pspecs, params)
        grad_step = make_recsys_step(cfg, adamw.AdamWConfig())

        def step(params, opt_state, batch):
            (params, opt_state), aux = grad_step((params, opt_state), batch)
            return params, opt_state, aux["loss"]

        return step, cell_args((params, opt, batch), (pspecs, ospecs, bspecs),
                               2), (0, 1), meta

    if cell.kind == "serve":
        def step(params, batch):
            return dcn.predict(params, batch["dense"], batch["sparse"], cfg)

        return step, cell_args((params, batch), (pspecs, bspecs), 1), (), meta

    # retrieval: 1 query vs n_candidates item embeddings
    nc = _pad_up(cell.dims["n_candidates"], nchips)
    cands = _sds((nc, cfg.retrieval_dim), torch.float32)
    q = {
        "dense": _sds((1, cfg.n_dense), torch.float32),
        "sparse": _sds((1, cfg.n_sparse), torch.int32),
    }
    qspecs = {"dense": P(None, None), "sparse": P(None, None)}
    meta["padded_candidates"] = nc

    def step(params, q, cands):
        return dcn.retrieval_scores(params, q["dense"], q["sparse"], cands,
                                    cfg)

    return step, cell_args((params, q, cands), (pspecs, qspecs, P(fa, None)),
                           1), (), meta


# ------------------------------ overrides ---------------------------------

class _ModProxy:
    """Arch module stand-in with an overridden FULL config (used for the
    L=1/L=2 cost-extrapolation runs)."""

    def __init__(self, mod, full):
        self.FAMILY = mod.FAMILY
        self.SHAPES = mod.SHAPES
        self.SMOKE = mod.SMOKE
        self.FULL = full


LAYER_FIELD = {"lm": "n_layers", "meshgraphnet": "n_layers", "pna": "n_layers",
               "schnet": "n_interactions"}


def scan_layer_count(arch: str):
    """(field, L) if the arch's layers are stacked on a leading axis (the
    reference scans them, and XLA's cost model counts a scan body once;
    the port's loop counts every layer, and the dry-run extrapolates from
    L = 1 and 2 to keep the sweep fast)."""
    mod = get_arch(arch)
    if mod.FAMILY == "lm":
        return "n_layers", mod.FULL.n_layers
    if arch in ("meshgraphnet", "pna"):
        return "n_layers", mod.FULL.n_layers
    if arch == "schnet":
        return "n_interactions", mod.FULL.n_interactions
    return None, None  # mace/dcn: python loop, fully counted


def apply_overrides(cfg, overrides: dict):
    """dataclasses.replace with dotted-path keys ('moe.dispatch')."""
    nested: dict = {}
    flat = {}
    for k, v in overrides.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
        else:
            flat[k] = v
    for head, sub in nested.items():
        flat[head] = apply_overrides(getattr(cfg, head), sub)
    return dataclasses.replace(cfg, **flat)


def build_cell(arch: str, shape, mesh, multi_pod: bool,
               layers_override: int | None = None,
               overrides: dict | None = None):
    """Returns (fn, args, donate, meta) for one dry-run cell.  ``shape``
    names one of the arch's ``SHAPES``, or is a :class:`ShapeCell` of its
    own (a cell at another batch, as the smoke run measures it)."""
    mod = get_arch(arch)
    if overrides:
        mod = _ModProxy(mod, apply_overrides(mod.FULL, overrides))
    if layers_override is not None:
        field, _ = scan_layer_count(arch)
        if field is None:
            raise ValueError(f"{arch} has no stacked layers to override")
        mod = _ModProxy(mod, dataclasses.replace(
            mod.FULL, scan_layers=False, **{field: layers_override}))
    cell = shape if isinstance(shape, ShapeCell) else mod.SHAPES[shape]
    if mod.FAMILY == "lm":
        return _lm_cell(mod, cell, mesh, multi_pod)
    if mod.FAMILY == "gnn":
        return _gnn_cell(arch.replace("-", "_"), mod, cell, mesh, multi_pod)
    if mod.FAMILY == "recsys":
        return _recsys_cell(mod, cell, mesh, multi_pod)
    raise ValueError(mod.FAMILY)
