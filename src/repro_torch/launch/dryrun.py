"""Multi-pod dry-run tool, the reference's ``repro.launch.dryrun``, on
``meta`` tensors with an H100's roofline.

For every (architecture × input shape × mesh) cell, the port's own step
(``launch.specs.build_cell``) runs once on ``meta`` tensors of the
reference's global shapes and dtypes: nothing is allocated, nothing is
launched, no card is needed.  The record of each cell lands in
``<out>/<single|multi>/<arch>__<shape>[__tag].json`` with the
reference's keys, so the sweep is resumable (``--force`` redoes a cell).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi35_moe --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--jobs N]

What a record holds, per device (the global count over the mesh's
devices, as the reference's SPMD module is the per-device program):

* ``cost_analysis.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the aten ops (the matrix products), plus the hand-written
  kernels' own FLOPs, which their ``meta`` shape rules record
  (``kernels/meta_cost.py``).
* ``cost_analysis.bytes_accessed``: every aten op's input and output
  bytes, summed by a dispatch mode (views and empty allocations move
  nothing), plus the kernels' bytes.
* ``kernels``: the hand-written kernels' share of those two counts, and
  their calls over the whole mesh (a key the reference has not).
* ``collectives``: bytes and counts of each collective by the rules
  below; ``total`` is their sum.
* ``memory_analysis``: ``argument_size_in_bytes``, each argument leaf's
  per-device shard bytes under its placement; ``output_size_in_bytes``,
  the same for the outputs: an output of a donated argument's shape and
  dtype takes that argument's placement (XLA aliases a donated buffer to
  such an output, and counts it among the outputs), any other output is
  split where one of its dimensions has the size of a split dimension of
  a data argument (the batch, the tokens, the caches, the candidates),
  over the same axes, and is replicated elsewhere.
* ``roofline``: :func:`roofline_terms` over ``launch.mesh``'s H100 peaks.

The collective rules.  There is no SPMD partitioner, so the collectives
are counted from the placements (``args.specs``).  Each counts where its
group spans more than one device; ``n`` is the group's size:

1. Train cells: each parameter leaf's gradient is all-reduced over the
   batch axes its placement does not split, ring: 2·(n−1)/n of its
   per-device bytes.
2. Train cells: each ZeRO-sharded optimizer leaf (split over an axis its
   parameter is not) is all-gathered over those axes for the update:
   (n−1)/n of its per-device bytes under its parameter's placement.
3. Language models: each layer's row-parallel projections all-reduce
   their output over the model axis, ring 2·(n−1)/n: attention's ``wo``
   and a dense FFN's ``w_down`` their (batch, tokens, d_model)
   activation; the experts' ``w_down`` under ``"ffn"`` sharding the
   (E, C, d_model) capacity buffer.  Once in the forward and again in the
   backward of a train cell.
4. Language models with experts under ``"expert"`` sharding: the dispatch
   and the combine are all-to-alls of the (E, C, d_model) capacity buffer
   over the model axis, (n−1)/n each; forward, and again in the backward
   of a train cell.

Activations and capacity buffers are in the config's dtype and split over
the batch's shards.  Nothing else is counted: the model-sharded recsys
tables' lookups, the long-context decode's sequence-sharded cache and
the output's gathers have no rule.

Deviations from the reference, each by design:

* Bytes are counted before fusion: each aten op's operands as if each
  went to memory.  XLA counts after fusion, so this count is an upper
  bound beside the reference's.
* Collectives come from the rules above, not from a partitioned program.
* ``temp_size_in_bytes`` cannot be had on ``meta`` (no storage, no
  allocator): it is recorded as ``{"error": ...}``, as the reference
  records a field its backend lacks; ``generated_code_size_in_bytes``
  has no counterpart.
* The port's layer loop is Python, so every layer it runs is counted;
  the reference lowers L = 1 and L = 2 because XLA counts a scan body
  once.  The port runs the same two depths and extrapolates
  ``c(L) = c(1) + (L − 1)·(c(2) − c(1))`` only to keep the sweep fast:
  the layers are alike, so the extrapolation equals the full count (a
  test holds it so).  ``cost_analysis_raw`` (XLA's count with the scan
  body once) has no counterpart.
* ``lower_compile_s`` is the seconds the cell took to build and count:
  nothing is lowered or compiled.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from fractions import Fraction
from functools import partial

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.checkpoint.checkpointer import leaves
from repro_torch.configs import ARCHS, get_arch
from repro_torch.distributed.mesh import (PartitionSpec, axes_size,
                                          axis_size, entry_axes, shard_shape)
from repro_torch.kernels.meta_cost import KernelCost
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.launch.specs import build_cell, scan_layer_count, spec_leaves
from repro_torch.models.moe import capacity

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.bfloat16: 2, torch.float16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_aten = torch.ops.aten
# Ops that move no bytes beside the views: allocations without a fill.
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten._unsafe_view.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES[t.dtype]


class _Traffic(TorchDispatchMode):
    """Sums every aten op's input and output bytes (views and bare
    allocations excepted)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in _NO_TRAFFIC):
            self.bytes += sum(_nbytes(t) for t in pytree.tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


def _shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    n = 1
    for d in shard_shape(t.shape, spec, mesh):
        n *= d
    return n * _DTYPE_BYTES[t.dtype]


def argument_bytes(tree, spec_tree, mesh) -> int:
    """Per-device bytes of a tree of ``meta`` tensors under its parallel
    tree of placements."""
    return sum(_shard_bytes(t, s, mesh) for t, s in
               zip(leaves(tree), spec_leaves(spec_tree), strict=True))


def collective_bytes(args) -> dict:
    """Per-device bytes and counts of each collective of a cell, by the
    module's rules, from its placements (``args`` a
    ``launch.specs.CellArgs``): ``{op: bytes, ..., "total", "counts"}``,
    bytes as exact fractions."""
    mesh = args.mesh
    out = {c: Fraction(0) for c in _COLLECTIVES}
    counts = {c: 0 for c in _COLLECTIVES}

    def add(op, n, per_device_bytes, times=1):
        if n > 1:
            ring = 2 * (n - 1) if op == "all-reduce" else n - 1
            out[op] += Fraction(ring * per_device_bytes * times, n)
            counts[op] += times

    pspecs = spec_leaves(args.specs[0])
    if args.kind == "train":
        for t, s in zip(leaves(args[0]), pspecs, strict=True):
            split = {a for e in s for a in entry_axes(e)}
            red = [a for a in args.batch_axes if a not in split]
            add("all-reduce", axes_size(mesh, red), _shard_bytes(t, s, mesh))
        for t, ps, os_ in zip(leaves(args[1].mu) + leaves(args[1].nu),
                              pspecs + pspecs,
                              spec_leaves(args.specs[1].mu)
                              + spec_leaves(args.specs[1].nu), strict=True):
            have = {a for e in ps for a in entry_axes(e)}
            extra = [a for e in os_ for a in entry_axes(e) if a not in have]
            add("all-gather", axes_size(mesh, extra),
                _shard_bytes(t, ps, mesh))

    if args.family == "lm":
        cfg = args.cfg
        tok = args[args.batch_arg]
        b_dev = shard_shape(tok.shape, args.specs[args.batch_arg], mesh)[0]
        b_shards = tok.shape[0] // b_dev
        seq = tok.shape[1] if args.kind in ("train", "prefill") else 1
        item = _DTYPE_BYTES[cfg.dtype]
        tp = axis_size(mesh, cfg.tp_axis)
        times = cfg.n_layers * (2 if args.kind == "train" else 1)
        act = b_dev * seq * cfg.d_model * item
        add("all-reduce", tp, act, times)                        # wo
        if cfg.moe:
            m = cfg.moe
            if m.dispatch == "row":
                buf = b_dev * m.padded_experts * capacity(m, seq) \
                    * cfg.d_model * item
            else:
                buf = Fraction(m.padded_experts
                               * capacity(m, tok.shape[0] * seq)
                               * cfg.d_model * item, b_shards)
            if m.expert_sharding == "expert":
                add("all-to-all", tp, buf, 2 * times)    # dispatch, combine
            else:
                add("all-reduce", tp, buf, times)        # experts' w_down
        else:
            add("all-reduce", tp, act, times)                    # w_down
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    out["counts"] = counts
    return out


def _output_specs(args, donate, out_leaves) -> list:
    """Each output leaf's placement (the module docstring's rule)."""
    donated = [(t, s) for i in donate for t, s in
               zip(leaves(args[i]), spec_leaves(args.specs[i]), strict=True)]
    split = [(size, e) for i in range(args.batch_arg, len(args))
             for t, s in zip(leaves(args[i]), spec_leaves(args.specs[i]),
                             strict=True)
             for size, e in zip(t.shape, s) if e is not None]
    specs = []
    for o in out_leaves:
        hit = next((k for k, (t, _) in enumerate(donated)
                    if t.shape == o.shape and t.dtype == o.dtype), None)
        if hit is not None:
            specs.append(donated.pop(hit)[1])
            continue
        used, entries = set(), []
        for d in o.shape:
            e = next((e for size, e in split if size == d
                      and not used & set(entry_axes(e))), None)
            used |= set(entry_axes(e))
            entries.append(e)
        specs.append(PartitionSpec(*entries))
    return specs


def _run(fn, args) -> tuple:
    """``fn(*args)`` on ``meta`` under the counters: (global FLOPs, global
    bytes, the kernels' share of both and their calls, the output's
    tensor leaves)."""
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    with KernelCost() as kernels, flops, traffic:
        out = fn(*args)
    return (flops.get_total_flops() + kernels.flops,
            traffic.bytes + kernels.bytes,
            {"flops": kernels.flops, "bytes_accessed": kernels.bytes,
             "calls": dict(kernels.calls)},
            [t for t in pytree.tree_leaves(out)
             if isinstance(t, torch.Tensor)])


def _measure(arch, shape, mesh, multi_pod, overrides, layers_override=None,
             memo=None):
    """One run of a cell's step on ``meta``: global FLOPs and bytes,
    per-device collectives and argument and output bytes.  ``memo`` (a
    dict) keeps each run's global counts by the cell and its arguments'
    shapes and dtypes: a language-model cell has the same global shapes
    on both production meshes, so ``--mesh both`` runs it once."""
    fn, args, donate, meta = build_cell(arch, shape, mesh, multi_pod,
                                        layers_override=layers_override,
                                        overrides=overrides)
    arg_bytes = sum(argument_bytes(a, s, mesh)
                    for a, s in zip(args, args.specs))
    key = (arch, repr(shape), repr(overrides), layers_override,
           tuple((tuple(t.shape), t.dtype) for t in leaves(tuple(args))))
    if memo is None:
        memo = {}
    if key not in memo:
        memo[key] = _run(fn, args)
    flops, nbytes, kernels, out_leaves = memo[key]
    out_bytes = sum(_shard_bytes(t, s, mesh) for t, s in
                    zip(out_leaves, _output_specs(args, donate, out_leaves)))
    coll = collective_bytes(args)
    return meta, {"flops": flops, "bytes_accessed": nbytes, "kernels": kernels,
                  "collectives": {c: coll[c] for c in _COLLECTIVES},
                  "counts": coll["counts"],
                  "output_size_in_bytes": out_bytes}, arg_bytes


def _extrapolate(c1, c2, L):
    """``c1 + (L − 1)·(c2 − c1)`` on every number of a count (the
    reference's, with its floor of 0 on the per-layer step)."""
    if isinstance(c1, dict):
        return {k: _extrapolate(c1[k], c2[k], L) for k in c1}
    return c1 + (L - 1) * max(c2 - c1, 0)


def count_cell(arch: str, shape, mesh, multi_pod: bool,
               overrides: dict | None = None, memo: dict | None = None
               ) -> dict:
    """The record of one cell on ``mesh`` (``run_cell``'s, without the
    file): ``meta``, ``cost_analysis``, ``collectives``,
    ``memory_analysis``, ``roofline`` and, for stacked layers,
    ``cost_extrapolation``.  ``shape`` is a name of the arch's ``SHAPES``
    or a ``ShapeCell``; ``memo`` as :func:`_measure` takes it."""
    chips = axes_size(mesh, mesh.axis_names)
    rec = {}
    field, L = scan_layer_count(arch)
    if field is not None and overrides and field in overrides:
        L = overrides[field]      # the reference extrapolates to FULL's L
    if field is not None and L and L > 1:
        _, c1, _ = _measure(arch, shape, mesh, multi_pod, overrides, 1, memo)
        _, c2, _ = _measure(arch, shape, mesh, multi_pod, overrides, 2,
                            memo)
        _, full_args, _, meta = build_cell(arch, shape, mesh, multi_pod,
                                           overrides=overrides)
        arg_bytes = sum(argument_bytes(a, s, mesh)
                        for a, s in zip(full_args, full_args.specs))
        cost = _extrapolate(c1, c2, L)

        def short(c):
            return {"flops": c["flops"] / chips,
                    "bytes_accessed": c["bytes_accessed"] / chips,
                    "collective_bytes": float(sum(c["collectives"].values()))}
        rec["cost_extrapolation"] = {"layers": L, "L1": short(c1),
                                     "L2": short(c2)}
    else:
        meta, cost, arg_bytes = _measure(arch, shape, mesh, multi_pod,
                                         overrides, memo=memo)
    coll_total = sum(cost["collectives"].values())
    rec["meta"] = meta
    rec["cost_analysis"] = {"flops": cost["flops"] / chips,
                            "bytes_accessed": cost["bytes_accessed"] / chips}
    k = cost["kernels"]
    rec["kernels"] = {"flops": k["flops"] / chips,
                      "bytes_accessed": k["bytes_accessed"] / chips,
                      "calls": k["calls"]}
    rec["collectives"] = {c: float(cost["collectives"][c])
                          for c in _COLLECTIVES}
    rec["collectives"]["total"] = float(coll_total)
    rec["collectives"]["counts"] = cost["counts"]
    rec["memory_analysis"] = {
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(cost["output_size_in_bytes"]),
        "temp_size_in_bytes": {"error": "a meta tensor has no storage and no "
                               "allocator runs: temporaries are not "
                               "measured"}}
    rec["roofline"] = roofline_terms(rec["cost_analysis"]["flops"],
                                     rec["cost_analysis"]["bytes_accessed"],
                                     rec["collectives"]["total"], chips)
    return rec


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int) -> dict:
    """Terms in seconds, over one device's peaks: the inputs are already
    per device (the global count over ``chips``), so the reference's
    formula ``total / (chips × peak)`` is the same."""
    ct = flops / PEAK_FLOPS_BF16
    mt = bytes_accessed / HBM_BW
    lt = coll_bytes / ICI_BW
    terms = {"compute_s": ct, "memory_s": mt, "collective_s": lt}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = max(ct, mt, lt)
    return terms


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False, overrides: dict | None = None,
             tag: str = "", memo: dict | None = None) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(d, f"{arch}__{shape}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = axes_size(mesh, mesh.axis_names)
    rec = {"arch": arch, "shape": shape, "mesh": list(mesh.shape),
           "chips": chips, "status": "error", "overrides": overrides or {},
           "tag": tag}
    t0 = time.time()
    try:
        rec.update(count_cell(arch, shape, mesh, multi_pod, overrides, memo))
        rec["lower_compile_s"] = time.time() - t0
        rec["status"] = "ok"
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        rec["lower_compile_s"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def _run_group(out_dir, force, group) -> list:
    """``run_cell`` over one (arch, shape)'s meshes with one memo (a
    worker's task under ``--jobs``)."""
    memo = {}
    return [run_cell(a, s, mp, out_dir, force=force, memo=memo)
            for a, s, mp in group]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, each counting an (arch, shape)'s "
                         "meshes; the records and lines are the same")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    groups = []
    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    for a in archs:
        mod = get_arch(a)
        shapes = list(mod.SHAPES) if args.shape is None else [args.shape]
        for s in shapes:
            groups.append([(a, s, mp) for mp in meshes])

    count = partial(_run_group, args.out, args.force)
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:
            pool = stack.enter_context(ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")))
            done = pool.map(count, groups)
        else:
            done = map(count, groups)
        cells = [(cell, rec) for group, recs in zip(groups, done)
                 for cell, rec in zip(group, recs)]
    n_ok = 0
    for (a, s, mp), rec in cells:
        tag = "multi " if mp else "single"
        if rec["status"] == "ok":
            n_ok += 1
            r = rec["roofline"]
            print(f"[{tag}] {a:14s} {s:14s} OK   "
                  f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s dom={r['dominant']}",
                  flush=True)
        else:
            print(f"[{tag}] {a:14s} {s:14s} FAIL {rec['error'][:120]}",
                  flush=True)
    print(f"{n_ok}/{len(cells)} cells OK")


if __name__ == "__main__":
    main()
