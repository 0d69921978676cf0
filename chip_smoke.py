#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA walker (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure raises and
the script exits non-zero (no phase catches another's error):

1. Build the CUDA kernels (walk_step, fused_superstep) from the checkout's
   sources with nvcc, one process each, started together; print the build
   times, both ptxas reports and the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit.  The one-hop walk-step kernels at W = 4096 and W = 1000 lanes over
   the main path's graph (lanes include dangling vertices, the max-degree
   hub and idle lanes), timed with CUDA events around CUDA-graph replays
   (median of 60 replays of 10 calls each: device time per call).  The
   fused superstep kernel for URW, PPR, DeepWalk and MetaPath: one launch
   of k = 16 through the kernel and through its plain version, on copies
   of one state, must leave every state tensor equal.  The states: the
   main path's batch one superstep in (W = 4096, every lane live and the
   queue full, so every superstep refills), and the drain's tail at
   W = 4096, 1000 and 12288 (live, idle and just-refilled lanes; plus PPR
   in static mode with an injection delay).  The launch is timed with
   CUDA events (median of 30, the state restored outside the timed
   region, host enqueue hidden behind a device sleep); the plain version
   and the bound from the main-path state.
3. Drive the main path: ``compile(program).run(graph, starts)`` for URW,
   PPR and DeepWalk on the WG stand-in at its Table II size (scale 20,
   weighted, alias tables) under ``step_impl`` torch, cuda, fused, fused,
   cuda, torch, and MetaPath (0, 1, 2) on the typed WG stand-in (scale 20,
   3 edge types) under torch, fused, fused, torch; 65,536 starts, 4,096
   slots, 80 hops, 16 supersteps per fused launch.  Every run zeroes the
   kernels' launch counts before it and reads them after: the impls must
   agree bit for bit in paths, lengths and the 11 stats other than
   ``launches``; ``launches == supersteps`` per hop; a fused run's
   ``launches`` equals its kernel's count and is below ``supersteps``;
   every recorded hop is an edge of the graph (of the scheduled type for
   MetaPath).  ``torch.profiler`` over a one-batch run of each program and
   impl prints where the time goes.  A small batch on the card (cuda;
   fused, also static with a delay and without path records) equals the
   same batch on the CPU, whose plain path the CPU tests hold to the JAX
   reference.
4. Print the kernels' JSON summary, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is unavailable or when the
script is run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

NUM_STARTS = 65_536
NUM_SLOTS = 4_096
MAX_HOPS = 80
WG_SCALE = 20
HOPS_PER_LAUNCH = 16
METAPATH = (0, 1, 2)
KERNEL_WIDTHS = (4_096, 1_000)   # the main path's W, and a ragged W
FUSED_WIDTHS = (4_096, 1_000, 12_288)
TIMED_REPS = 60                  # graph replays timed per function
GRAPH_CALLS = 10                 # calls captured per graph (600 timed)
FUSED_TIMED_REPS = 30            # fused launches timed per version
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
CUDA_CORE_OPS_PER_S = 67e12      # H100 SXM float32 outside tensor cores
# int32 rate of the whole card: 132 SMs x 64 int32 lanes per SM per clock
# at the 1,980 MHz maximum boost clock (Hopper white paper) = 16.7 Tops/s.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
THREEFRY_OPS = 80                # int32 ops per Threefry-2x32 block
LANE_OPS = 40                    # other int32 ops per live lane-superstep
SECTOR = 32                      # bytes the memory system moves per gather
RUN_ORDER = {"urw": ("torch", "cuda", "fused", "fused", "cuda", "torch"),
             "ppr": ("torch", "cuda", "fused", "fused", "cuda", "torch"),
             "deepwalk": ("torch", "cuda", "fused", "fused", "cuda", "torch"),
             "metapath": ("torch", "fused", "fused", "torch")}

KERNELS = {
    "walk_step_uniform": {
        "replaces": "src/repro/kernels/walk_step/walk_step.py:227",
        "ops_per_lane": 16,   # clamps, address adds, cvt, mul, floor, pick
    },
    "walk_step_alias": {
        "replaces": "src/repro/kernels/walk_step/walk_step.py:249",
        "ops_per_lane": 22,   # the uniform ops plus the accept test
    },
}
CU_SOURCE = "src/repro_torch/kernels/walk_step/csrc/walk_step.cu"
FUSED_SOURCE = ("src/repro_torch/kernels/fused_superstep/csrc/"
                "fused_superstep.cu")
FUSED_REPLACES = "src/repro/kernels/fused_superstep/fused_superstep.py:805"
FUSED_TIMED = "ppr"              # the program whose launch the JSON row times


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def ptxas_report(log: str):
    """The register report of an nvcc ``-Xptxas -v`` log: each kernel's
    ``Compiling entry function`` line (mangled name), its spill line and
    its ``Used ...`` line."""
    for line in log.splitlines():
        if ("Compiling entry function" in line or "spill" in line
                or "Used" in line):
            yield "  " + line.strip()


def programs():
    from repro_torch.walker import WalkProgram
    return {"urw": WalkProgram.urw(MAX_HOPS),
            "ppr": WalkProgram.ppr(0.15, MAX_HOPS),
            "deepwalk": WalkProgram.deepwalk(MAX_HOPS),
            "metapath": WalkProgram.metapath(METAPATH, MAX_HOPS)}


def kernel_inputs(g, width: int, seed: int):
    """Lanes over ``g`` at ``width``: random vertices plus dangling
    vertices, the max-degree hub and idle lanes (-1); uniforms include 0
    and the largest float32 below 1."""
    import torch
    rng = np.random.default_rng(seed)
    deg = (g.row_ptr[1:] - g.row_ptr[:-1]).cpu().numpy()
    v = rng.integers(0, g.num_vertices, width).astype(np.int32)
    dangling = np.flatnonzero(deg == 0)
    v[0:width:7] = rng.choice(dangling, len(v[0:width:7]))
    v[1:width:11] = int(np.argmax(deg))
    v[2:width:13] = -1
    u = rng.random((2, width), dtype=np.float32)
    u[:, 3:width:17] = 0.0
    u[:, 4:width:19] = np.nextafter(np.float32(1), np.float32(0))
    dev = g.device
    return (torch.from_numpy(v).to(dev), torch.from_numpy(u[0]).to(dev),
            torch.from_numpy(u[1]).to(dev))


def kernel_args(name, g, v, u_col, u_acc):
    if name == "walk_step_uniform":
        return (v, u_col, g.row_ptr, g.col)
    return (v, u_col, u_acc, g.row_ptr, g.col, g.alias_prob, g.alias_idx)


def bytes_needed(name, g, v, u_col, u_acc) -> int:
    """Bytes this call must move: lane I/O once, plus each distinct 32-byte
    sector its gathers touch (the row_ptr pair of every lane; the alias
    probes and the column read of every lane with degree > 0)."""
    import torch

    from repro_torch.core.samplers import _uniform_index
    lane_io = v.shape[0] * 4 * (4 if name == "walk_step_uniform" else 5)
    vc = torch.clamp(v, 0, g.num_vertices - 1).long()
    addr, deg = g.row_ptr[vc], g.row_ptr[vc + 1] - g.row_ptr[vc]

    def sectors(word_index):
        return SECTOR * int(torch.unique(word_index * 4 // SECTOR).numel())
    total = lane_io + sectors(torch.cat([vc, vc + 1]))
    live = deg > 0
    idx = _uniform_index(deg, u_col)
    if name == "walk_step_alias":
        ek = (addr + idx)[live].long()
        total += 2 * sectors(ek)            # prob and alias, same offsets
        idx = idx.clone()
        idx[live] = torch.where(u_acc[live] < g.alias_prob[ek], idx[live],
                                g.alias_idx[ek])
    return total + sectors((addr + idx)[live].long())   # the column read


def time_launches(fn, reps=TIMED_REPS, calls=GRAPH_CALLS) -> float:
    """Median device time of one call of ``fn`` in ms.

    ``calls`` calls are captured in a CUDA graph and the graph is replayed
    ``reps`` times between CUDA events, so each sample is back-to-back
    device work (host launch overhead excluded), divided by ``calls``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return float(np.median(samples))


def check_kernels(g) -> dict:
    """Phase 2: each kernel bit-equal to its plain version, timed."""
    from repro_torch.kernels.walk_step import ops, ref
    plain = {"walk_step_uniform": ref.walk_step_uniform_ref,
             "walk_step_alias": ref.walk_step_alias_ref}
    rows = {}
    for name, spec in KERNELS.items():
        kernel = getattr(ops, name)
        max_err = 0
        for width in KERNEL_WIDTHS:
            v, u_col, u_acc = kernel_inputs(g, width, seed=width)
            args = kernel_args(name, g, v, u_col, u_acc)
            got, want = kernel(*args), plain[name](*args)
            for a, b in zip(got, want):
                err = int((a.long() - b.long()).abs().max())
                max_err = max(max_err, err)
                if err != 0 or a.dtype != b.dtype:
                    raise AssertionError(
                        f"{name} disagrees with its plain version at W={width}"
                        f" (max abs err {err})")
            print(f"{name} W={width}: bit-equal to the plain version "
                  f"(tolerance 0: integer outputs)")
        width = KERNEL_WIDTHS[0]
        v, u_col, u_acc = kernel_inputs(g, width, seed=width)
        args = kernel_args(name, g, v, u_col, u_acc)
        ms = time_launches(lambda: kernel(*args))
        plain_ms = time_launches(lambda: plain[name](*args))
        nbytes = bytes_needed(name, g, v, u_col, u_acc)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = width * spec["ops_per_lane"] / CUDA_CORE_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": spec["replaces"], "launches": None,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        print(f"{name} W={width}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {max(t_bytes, t_ops):.6f} ms ({nbytes} bytes)")
    return rows


def clone_state(x):
    """A deep copy of a (nested) NamedTuple of tensors."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(clone_state(f) for f in x))


def state_tensors(state, prefix=""):
    """(name, tensor) for every tensor of a (nested) NamedTuple state."""
    import torch
    for name, f in zip(state._fields, state):
        if isinstance(f, torch.Tensor):
            yield prefix + name, f
        else:
            yield from state_tensors(f, prefix + name + ".")


def state_err(a, b) -> int:
    """Max abs difference over every tensor of two engine states (slots,
    queue counters, head_hist, all 12 stats, done, lengths, paths)."""
    err = 0
    for (name, x), (_, y) in zip(state_tensors(a), state_tensors(b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{name}: {x.dtype}{tuple(x.shape)} vs "
                                 f"{y.dtype}{tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def mid_drain_state(g, prog, cfg, key, seed):
    """A state some plain supersteps into a batch of W + W/16 starts: they
    run until the queue has run dry and lanes start to idle, so the state
    holds live, idle and just-refilled lanes (the drain's tail)."""
    import torch

    from repro_torch.core import walk_engine
    from repro_torch.kernels.fused_superstep import ref
    depth = walk_engine._stage_depth(cfg)
    W = cfg.num_slots
    starts = np.random.default_rng(seed).integers(
        0, g.num_vertices, W + W // 16).astype(np.int32)
    state = walk_engine.init_state(cfg, depth,
                                   torch.from_numpy(starts).to(g.device))
    for _ in range(60):
        state = ref.fused_superstep_ref(g, prog.spec, cfg, depth, state, key, 1)
        if not bool(state.slots.active.all()):
            break
    return state, depth


def main_path_state(g, prog, cfg, key, starts_np):
    """The main path's state one plain superstep into its batch (the same
    starts and key): every lane live, the queue holding more than one
    launch can take, lanes that ended refilled."""
    import torch

    from repro_torch.core import walk_engine
    from repro_torch.kernels.fused_superstep import ref
    depth = walk_engine._stage_depth(cfg)
    state = walk_engine.init_state(cfg, depth,
                                   torch.from_numpy(starts_np).to(g.device))
    return ref.fused_superstep_ref(g, prog.spec, cfg, depth, state, key, 1), depth


def fused_bound(prog, cfg, before, after):
    """(bound ms, bound_by, int32 ops, bytes) of one fused launch, counted
    from what this launch's data needed: its live lane-supersteps,
    advancing hops, terminations and refills."""
    def d(field):
        return int(getattr(after.stats, field)) - int(getattr(before.stats,
                                                              field))
    from repro_torch.kernels.fused_superstep import ops
    live = d("slot_steps") - d("bubbles")
    refills = int(after.queue.head) - int(before.queue.head)
    # Threefry blocks per live lane: 2 fold query id and hop (epoch 0
    # throughout a closed batch), shared by the draws; each draw then folds
    # its salt and runs its block.  PPR draws twice.
    blocks = 2 + 2 * (2 if prog.spec.stop_prob > 0 else 1)
    ops_count = live * (blocks * THREEFRY_OPS + LANE_OPS)
    gather = {"uniform": 12, "alias": 20, "metapath": 24}[prog.spec.kind]
    nbytes = (2 * cfg.num_slots * 21           # lane state in and out
              + live * gather                  # row_ptr pair, column, probes
              + d("steps") * 8                 # path record + length
              + d("terminations")              # done bytes
              + refills * 20                   # order/start/epoch, path, length
              + 2 * 8 * (ops.CTL_HIST + cfg.injection_delay + 1))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            ops_count, nbytes)


def time_fused(launch, pristine, device_only, reps=FUSED_TIMED_REPS) -> float:
    """Median ms of ``launch(state)`` between CUDA events, each on a fresh
    copy of ``pristine`` made outside the timed region.  With
    ``device_only`` the copy is packed beforehand (``launch(state, block)``
    is called) and a device sleep runs
    ahead of the start event, so the host's enqueue is hidden and the time
    is the kernel's; otherwise it includes the host (the plain version is
    host-driven, with a device sync per superstep)."""
    import torch

    from repro_torch.kernels.fused_superstep import ops
    samples = []
    for _ in range(reps + 2):                 # the first two warm up
        work = clone_state(pristine)
        if device_only:
            work = ops.pack(work)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if device_only:
            torch.cuda._sleep(2_000_000)      # ~1 ms of device time
        start.record()
        if device_only:
            launch(*work)
        else:
            launch(work)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples[2:]))


def check_fused(graphs, starts_np) -> dict:
    """Phase 2, fused: one k = 16 launch of the kernel equals its plain
    version in every state tensor, per program, from two kinds of state:
    the main path's batch one superstep in (W = 4,096, the queue full:
    timed against the plain version and the bound; PPR's is the JSON
    row), and the drain's tail (W = 4,096, 1,000 and 12,288, plus PPR in
    static mode with a delay; the kernel timed, to show its scaling)."""
    import torch

    from repro_torch.core.rng import stream_key
    from repro_torch.core.walk_engine import EngineConfig
    from repro_torch.kernels.fused_superstep import LAUNCHES, ops, ref
    cases = [(name, NUM_SLOTS, "zero_bubble", 0, "main") for name in graphs]
    cases += [(name, W, "zero_bubble", 0, "tail") for name in graphs
              for W in FUSED_WIDTHS]
    cases.append(("ppr", 1_000, "static", 2, "tail"))
    max_err, row = 0, None
    for name, W, mode, delay, where in cases:
        prog, g = programs()[name], graphs[name]
        cfg = EngineConfig(num_slots=W, max_hops=MAX_HOPS, mode=mode,
                           injection_delay=delay, step_impl="fused",
                           hops_per_launch=HOPS_PER_LAUNCH)
        if where == "main":
            key = tuple(int(k) for k in stream_key(0))   # the main path's
            state, depth = main_path_state(g, prog, cfg, key, starts_np)
        else:
            key = tuple(int(k) for k in stream_key(7))
            state, depth = mid_drain_state(g, prog, cfg, key, seed=W)
        live = int(state.slots.active.sum())
        fresh = int((state.slots.active & (state.slots.hop == 0)).sum())
        if not (0 < live < W if where == "tail" else live == W):
            raise AssertionError(f"fused {name} W={W} {where}: the state "
                                 f"has {live} live lanes of {W}")

        def plain(st, prog=prog, g=g, cfg=cfg, depth=depth, key=key):
            return ref.fused_superstep_ref(g, prog.spec, cfg, depth, st, key,
                                           HOPS_PER_LAUNCH)

        def kernel(st, block, prog=prog, g=g, cfg=cfg, depth=depth, key=key):
            return ops.fused_superstep(g, prog.spec, cfg, depth, st, key,
                                       HOPS_PER_LAUNCH, block)
        want = plain(clone_state(state))
        work, block = ops.pack(clone_state(state))
        n0 = LAUNCHES["fused_superstep"]
        got = kernel(work, block)
        torch.cuda.synchronize()
        if LAUNCHES["fused_superstep"] != n0 + 1:
            raise AssertionError("fused launch not counted once")
        if got is not work:
            raise AssertionError("the fused launch did not update in place")
        err = state_err(got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"fused_superstep {name} W={W} {mode} C={delay}"
                                 f" {where} disagrees with its plain version "
                                 f"(max abs err {err})")
        ran = int(got.stats.supersteps) - int(state.stats.supersteps)
        idle = int(got.stats.bubbles) - int(state.stats.bubbles)
        refills = int(got.queue.head) - int(state.queue.head)
        if where == "main" and (idle != 0 or ran != HOPS_PER_LAUNCH
                                or int(got.queue.head) >= int(got.queue.tail)):
            raise AssertionError(f"fused {name}: the main-path launch was not "
                                 f"full ({idle} idle lane-supersteps)")
        print(f"fused_superstep {name} W={W} mode={mode} delay={delay} "
              f"{where}: bit-equal to the plain version in every state "
              f"tensor (tolerance 0: integer state) over {ran} supersteps "
              f"from {live} live / {W - live} idle / {fresh} just-refilled "
              f"lanes; {refills} refills, {idle} idle lane-supersteps")
        if mode != "zero_bubble":
            continue
        ms = time_fused(kernel, state, device_only=True)
        if where == "tail":    # the kernel's scaling with W; no plain time
            print(f"fused_superstep {name} W={W} k={HOPS_PER_LAUNCH} tail: "
                  f"kernel {ms:.6f} ms/launch ({ms / max(ran, 1) * 1e3:.3f} "
                  f"us per superstep)")
            continue
        plain_ms = time_fused(plain, state, device_only=False)
        bound_ms, bound_by, n_ops, nbytes = fused_bound(prog, cfg, state, got)
        print(f"fused_superstep {name} W={W} k={HOPS_PER_LAUNCH} main: kernel "
              f"{ms:.6f} ms/launch ({ms / max(ran, 1) * 1e3:.3f} us per "
              f"superstep), plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms "
              f"by {bound_by} ({n_ops} int32 ops at "
              f"{INT32_OPS_PER_S / 1e12:.2f} Tops/s, {nbytes} bytes at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        if name == FUSED_TIMED:
            row = {"name": "fused_superstep", "route": "cuda",
                   "source": FUSED_SOURCE, "replaces": FUSED_REPLACES,
                   "launches": None, "max_abs_err": None, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    row["max_abs_err"] = max_err
    return row


def check_paths(g, starts, res, schedule=None) -> None:
    """Every recorded walk starts at its start vertex and every recorded hop
    is an edge of the graph (with ``schedule``: of the type scheduled for
    that hop); lengths and steps agree."""
    import torch
    paths, lengths = res.paths, res.lengths
    q = paths.shape[0]
    if paths.shape != (q, MAX_HOPS + 1) or lengths.shape != (q,):
        raise AssertionError(f"result shapes {tuple(paths.shape)}, "
                             f"{tuple(lengths.shape)}")
    if not torch.equal(paths[:, 0], starts):
        raise AssertionError("paths do not begin at their start vertices")
    if int(lengths.min()) < 1 or int(lengths.max()) > MAX_HOPS + 1:
        raise AssertionError("lengths out of [1, max_hops + 1]")
    if int(res.stats.steps) != int((lengths - 1).sum()):
        raise AssertionError("stats.steps != recorded hops")
    if int(res.stats.terminations) != q:
        raise AssertionError("not every query terminated")
    t = torch.arange(MAX_HOPS, device=paths.device)
    hop = t[None, :] < (lengths[:, None] - 1)
    src, dst = paths[:, :-1][hop].long(), paths[:, 1:][hop].long()
    n = g.num_vertices
    rows = torch.repeat_interleave(
        torch.arange(n, device=paths.device),
        (g.row_ptr[1:] - g.row_ptr[:-1]).long())
    keys = rows * n + g.col.long()
    probe = src * n + dst
    if schedule is not None:
        types = g.num_edge_types
        keys = keys * types + g.edge_type.long()
        sched = torch.tensor(schedule, device=paths.device)
        hop_type = sched[t % len(schedule)][None, :].expand_as(hop)[hop]
        probe = probe * types + hop_type
    keys = torch.sort(keys).values
    pos = torch.searchsorted(keys, probe).clamp(max=keys.numel() - 1)
    if not bool((keys[pos] == probe).all()):
        raise AssertionError("a recorded hop is not an edge of the graph"
                             + (" of its scheduled type" if schedule else ""))
    if bool((paths[~torch.cat([torch.ones_like(hop[:, :1]), hop], 1)]
             != -1).any()):
        raise AssertionError("path entries past a walk's length are not -1")


def same_walks(a, b) -> bool:
    """Paths, lengths and every stat but ``launches`` equal."""
    import torch
    return (torch.equal(a.paths, b.paths) and torch.equal(a.lengths, b.lengths)
            and all(int(x) == int(y) for f, x, y in
                    zip(a.stats._fields, a.stats, b.stats) if f != "launches"))


def run_main_path(graphs, starts_np) -> dict:
    """Phase 3: each program under each of its impls, in turns, through
    the Walker.  Every run zeroes the launch counts just before it and
    reads them just after; returns each kernel's launches summed over the
    runs of its path."""
    import torch

    from repro_torch.core.scheduler import analyze_run
    from repro_torch.kernels.fused_superstep import ops as fused_ops
    from repro_torch.kernels.walk_step import ops as step_ops
    from repro_torch.walker import ExecutionConfig, compile
    kernel_of = {"urw": "walk_step_uniform", "ppr": "walk_step_uniform",
                 "deepwalk": "walk_step_alias"}
    totals = {**step_ops.LAUNCHES, **fused_ops.LAUNCHES}
    totals = {k: 0 for k in totals}
    for name, prog in programs().items():
        g = graphs[name]
        starts = torch.from_numpy(starts_np).to(g.device)
        walkers = {impl: compile(prog, execution=ExecutionConfig(
            num_slots=NUM_SLOTS, record_paths=True, step_impl=impl,
            hops_per_launch=HOPS_PER_LAUNCH))
            for impl in RUN_ORDER[name]}
        for w in walkers.values():   # warm-up: one batch's worth of starts
            w.run(g, starts[:NUM_SLOTS], seed=0)
        torch.cuda.synchronize()
        results = []
        for impl in RUN_ORDER[name]:   # in turns, so drift in the host's
            step_ops.reset_launches()  # speed shows as spread, not as a gap
            fused_ops.reset_launches()
            t0 = time.perf_counter()
            res = walkers[impl].run(g, starts, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {**step_ops.LAUNCHES, **fused_ops.LAUNCHES}
            drain = walkers[impl].last_drain
            a = analyze_run(res.stats, wall)
            want = {k: 0 for k in launched}
            if impl == "cuda":
                want[kernel_of[name]] = a.supersteps
            if impl == "fused":
                want["fused_superstep"] = a.launches
            if launched != want:
                raise AssertionError(f"{name}/{impl}: kernel launches "
                                     f"{launched}, expected {want}")
            if impl == "fused" and not 0 < a.launches < a.supersteps:
                raise AssertionError(f"{name}/fused: {a.launches} launches "
                                     f"for {a.supersteps} supersteps")
            if impl != "fused" and a.launches != a.supersteps:
                raise AssertionError(f"{name}/{impl}: launches != supersteps")
            check_paths(g, starts, res,
                        prog.spec.metapath if name == "metapath" else None)
            for k in totals:
                totals[k] += launched[k]
            results.append(res)
            print(f"main {name} step_impl={impl}: "
                  f"walks/s={NUM_STARTS / wall:.1f} "
                  f"MSteps/s={a.msteps_per_s:.4f} supersteps={a.supersteps} "
                  f"launches={a.launches} "
                  f"supersteps_per_launch={a.supersteps_per_launch:.3f} "
                  f"steps={a.steps} bubble_ratio={a.bubble_ratio:.6f} "
                  f"host_sync_share={drain.sync_s / drain.wall_s:.4f} "
                  f"wall_ms_per_superstep={wall / a.supersteps * 1e3:.4f} "
                  f"wall_s={wall:.4f} kernel_launches={launched}")
        for impl, res in zip(RUN_ORDER[name][1:], results[1:]):
            if not same_walks(results[0], res):
                raise AssertionError(f"{name}: {impl} differs from torch")
        print(f"main {name}: {' == '.join(dict.fromkeys(RUN_ORDER[name]))} "
              f"in paths, lengths and the {len(res.stats) - 1} stats other "
              f"than launches")
    return totals


def profile_supersteps(graphs, starts_np) -> None:
    """Where the time goes: ``torch.profiler`` over a one-batch run of each
    program under each step impl — device busy time (the sum of the device
    activities' times) against the run's wall time, device launches per
    superstep, and the top kernels.  The profiler's own overhead inflates
    the wall time, so the busy share printed is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.walker import ExecutionConfig, compile
    for name, prog in programs().items():
        g = graphs[name]
        starts = torch.from_numpy(starts_np[:NUM_SLOTS]).to(g.device)
        for impl in dict.fromkeys(RUN_ORDER[name]):
            w = compile(prog, execution=ExecutionConfig(
                num_slots=NUM_SLOTS, step_impl=impl,
                hops_per_launch=HOPS_PER_LAUNCH))
            w.run(g, starts[:NUM_SLOTS // 4], seed=0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                res = w.run(g, starts, seed=0)
                torch.cuda.synchronize()
            rows = []   # device activity (kernels, copies), not the ops
            for e in prof.key_averages():    # that launched them
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                if e.device_type == DeviceType.CUDA and us > 0:
                    rows.append((us, e.count, e.key))
            rows.sort(reverse=True)
            supersteps = int(res.stats.supersteps)
            busy_ms = sum(r[0] for r in rows) / 1e3
            wall_ms = w.last_drain.wall_s * 1e3
            if busy_ms == 0:
                print(f"profile {name}/{impl}: device time not measured "
                      f"(the profiler recorded no device activity)")
                continue
            top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{n}"
                            for us, n, k in rows[:5])
            print(f"profile {name}/{impl}: supersteps={supersteps} "
                  f"launches={int(res.stats.launches)} "
                  f"wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
                  f"device_busy_share={busy_ms / wall_ms:.4f} "
                  f"device_launches_per_superstep="
                  f"{sum(r[1] for r in rows) / supersteps:.2f} "
                  f"wall_ms_per_superstep={wall_ms / supersteps:.4f} "
                  f"top: {top}")


def check_small_against_cpu() -> None:
    """A small batch on the card (cuda and fused steps; fused also in
    static mode with a delay, whose drained pool reloads in bulk, and
    without path records) equals the same batch on the CPU (the plain
    per-hop step, and the fused kernel's plain version, whose launches
    must match too)."""
    import torch

    from repro_torch.graph import make_dataset
    from repro_torch.walker import ExecutionConfig, WalkProgram, compile
    starts = np.random.default_rng(1).integers(0, 512, 300).astype(np.int32)
    graphs = {dev: make_dataset("WG", weighted=True, with_alias=True,
                                num_edge_types=3, scale_override=9,
                                device=dev)
              for dev in ("cpu", "cuda")}
    variants = {"cuda": dict(step_impl="cuda"),
                "fused": dict(step_impl="fused"),
                "fused static C=2": dict(step_impl="fused", mode="static",
                                         injection_delay=2),
                "fused no paths": dict(step_impl="fused", record_paths=False)}
    for prog in (WalkProgram.urw(16), WalkProgram.ppr(0.15, 16),
                 WalkProgram.deepwalk(16), WalkProgram.metapath(METAPATH, 16)):
        for label, knobs in variants.items():
            def run(dev, knobs=knobs, prog=prog):
                return compile(prog, execution=ExecutionConfig(
                    num_slots=64, hops_per_launch=4, **knobs)).run(
                    graphs[dev], starts, seed=3)
            want, got = run("cpu"), run("cuda")
            if not (torch.equal(want.paths, got.paths.cpu())
                    and torch.equal(want.lengths, got.lengths.cpu())
                    and all(int(x) == int(y)
                            for x, y in zip(want.stats, got.stats))):
                raise AssertionError(f"{prog.name}/{label}: card differs "
                                     "from the CPU")
    print("small batch: card == CPU in paths, lengths and all 12 stats for "
          f"urw, ppr, deepwalk, metapath x {{{', '.join(variants)}}}")


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: run it from the root of a checkout "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from repro_torch.graph import make_dataset
    from repro_torch.kernels import build

    # Phase 1: build.
    t0 = time.perf_counter()
    secs = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s {secs}")
    for lib in build.SOURCES:
        print(f"ptxas {lib}:")
        for line in ptxas_report(build.build_log(lib)):
            print(line)
    print(card_line())

    t0 = time.perf_counter()
    g = make_dataset("WG", weighted=True, with_alias=True,
                     scale_override=WG_SCALE)
    gt = make_dataset("WG", num_edge_types=3, scale_override=WG_SCALE)
    print(f"graph WG scale {WG_SCALE}: |V|={g.num_vertices} "
          f"|E|={g.num_edges} max_deg={g.max_degree}; typed (3 edge types): "
          f"|E|={gt.num_edges} max_deg={gt.max_degree}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    graphs = {"urw": g, "ppr": g, "deepwalk": g, "metapath": gt}

    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, NUM_STARTS).astype(np.int32)
    rows = check_kernels(g)                                  # phase 2
    rows["fused_superstep"] = check_fused(graphs, starts)
    launches = run_main_path(graphs, starts)                 # phase 3
    profile_supersteps(graphs, starts)
    check_small_against_cpu()
    for name, row in rows.items():
        row["launches"] = launches[name]
        if row["launches"] <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
