#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA walker (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure raises and
the script exits non-zero (no phase catches another's error):

1. Build the CUDA kernels from the checkout's ``.cu`` sources with nvcc
   and print the build time and the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit, at W = 4096 and W = 1000 lanes over the main path's graph (lanes
   include dangling vertices, the max-degree hub and idle lanes), and time
   kernel and plain version with CUDA events around CUDA-graph replays
   (median of 60 replays of 10 calls each: device time per call).
3. Drive the main path: ``compile(program).run(graph, starts)`` for URW,
   PPR and DeepWalk under ``step_impl`` "torch" and "cuda" (in turns:
   torch, cuda, cuda, torch) on the WG
   stand-in at its Table II size (scale 20, weighted, alias tables),
   65,536 starts, 4,096 slots, 80 hops.  The two impls must agree bit for
   bit in paths, lengths and all 12 stats; every recorded hop must be an
   edge of the graph; each "cuda" run must launch its kernel exactly once
   per superstep.  A small batch on the CPU, whose plain path the CPU
   tests hold to the JAX reference, must agree with the card.
   ``torch.profiler`` over a short run of each program and impl prints
   where the time goes (device busy share, ops per superstep).
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
KERNEL_WIDTHS = (4_096, 1_000)   # the main path's W, and a ragged W
TIMED_REPS = 60                  # graph replays timed per function
GRAPH_CALLS = 10                 # calls captured per graph (600 timed)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
CUDA_CORE_OPS_PER_S = 67e12      # H100 SXM float32 outside tensor cores
SECTOR = 32                      # bytes the memory system moves per gather
RUN_ORDER = ("torch", "cuda", "cuda", "torch")

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


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


def check_paths(g, starts, res) -> None:
    """Every recorded walk starts at its start vertex and every recorded hop
    is an edge of the graph; lengths and steps agree."""
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
    keys = rows * n + g.col.long()              # sorted: CSR is (src, dst)
    probe = src * n + dst
    pos = torch.searchsorted(keys, probe).clamp(max=keys.numel() - 1)
    if not bool((keys[pos] == probe).all()):
        raise AssertionError("a recorded hop is not an edge of the graph")
    if bool((paths[~torch.cat([torch.ones_like(hop[:, :1]), hop], 1)]
             != -1).any()):
        raise AssertionError("path entries past a walk's length are not -1")


def run_main_path(g, starts_np) -> dict:
    """Phase 3: URW, PPR, DeepWalk × {torch, cuda} through the Walker."""
    import torch

    from repro_torch.core.scheduler import analyze_run
    from repro_torch.kernels.walk_step import ops
    from repro_torch.walker import ExecutionConfig, WalkProgram, compile
    starts = torch.from_numpy(starts_np).to(g.device)
    programs = {"urw": WalkProgram.urw(MAX_HOPS),
                "ppr": WalkProgram.ppr(0.15, MAX_HOPS),
                "deepwalk": WalkProgram.deepwalk(MAX_HOPS)}
    kernel_of = {"urw": "walk_step_uniform", "ppr": "walk_step_uniform",
                 "deepwalk": "walk_step_alias"}
    walkers = {(name, impl): compile(prog, execution=ExecutionConfig(
        num_slots=NUM_SLOTS, record_paths=True, step_impl=impl))
        for name, prog in programs.items() for impl in ("torch", "cuda")}
    for w in walkers.values():   # warm-up: one batch's worth of starts
        w.run(g, starts[:NUM_SLOTS], seed=0)
    torch.cuda.synchronize()

    ops.reset_launches()
    for name in programs:
        results = []
        for impl in RUN_ORDER:   # in turns, so drift in the host's speed
            before = dict(ops.LAUNCHES)   # shows as spread, not as a gap
            t0 = time.perf_counter()
            res = walkers[name, impl].run(g, starts, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            drain = walkers[name, impl].last_drain
            a = analyze_run(res.stats, wall)
            launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
            want = {k: 0 for k in before}
            if impl == "cuda":
                want[kernel_of[name]] = a.supersteps
            if launched != want:
                raise AssertionError(
                    f"{name}/{impl}: kernel launches {launched}, expected "
                    f"{want} (one per superstep)")
            check_paths(g, starts, res)
            results.append(res)
            print(f"main {name} step_impl={impl}: "
                  f"walks/s={NUM_STARTS / wall:.1f} "
                  f"MSteps/s={a.msteps_per_s:.4f} supersteps={a.supersteps} "
                  f"steps={a.steps} bubble_ratio={a.bubble_ratio:.6f} "
                  f"host_sync_share={drain.sync_s / drain.wall_s:.4f} "
                  f"wall_ms_per_superstep={wall / a.supersteps * 1e3:.4f} "
                  f"wall_s={wall:.4f} launches={launched}")
        a = results[0]
        for b in results[1:]:
            if not (torch.equal(a.paths, b.paths)
                    and torch.equal(a.lengths, b.lengths)
                    and all(int(x) == int(y)
                            for x, y in zip(a.stats, b.stats))):
                raise AssertionError(f"{name}: torch and cuda runs differ")
        print(f"main {name}: torch == cuda in paths, lengths and all "
              f"{len(a.stats)} stats")
    return dict(ops.LAUNCHES)


def profile_supersteps(g, starts_np) -> None:
    """Where the time goes: ``torch.profiler`` over a one-batch run of each
    program under each step impl — device busy time (the sum of the device
    activities' times) against the run's wall time, device launches per
    superstep, and the top kernels.  The profiler's own overhead inflates the wall time,
    so the busy share printed is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.walker import ExecutionConfig, WalkProgram, compile
    starts = torch.from_numpy(starts_np[:NUM_SLOTS]).to(g.device)
    programs = {"urw": WalkProgram.urw(MAX_HOPS),
                "ppr": WalkProgram.ppr(0.15, MAX_HOPS),
                "deepwalk": WalkProgram.deepwalk(MAX_HOPS)}
    for name, prog in programs.items():
        for impl in ("torch", "cuda"):
            w = compile(prog, execution=ExecutionConfig(
                num_slots=NUM_SLOTS, step_impl=impl))
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
                  f"wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
                  f"device_busy_share={busy_ms / wall_ms:.4f} "
                  f"device_launches_per_superstep="
                  f"{sum(r[1] for r in rows) / supersteps:.1f} "
                  f"wall_ms_per_superstep={wall_ms / supersteps:.4f} "
                  f"top: {top}")


def check_small_against_cpu() -> None:
    """A small batch on the card equals the same batch on the CPU."""
    import torch

    from repro_torch.graph import make_dataset
    from repro_torch.walker import ExecutionConfig, WalkProgram, compile
    starts = np.random.default_rng(1).integers(0, 512, 300).astype(np.int32)
    graphs = {dev: make_dataset("WG", weighted=True, with_alias=True,
                                scale_override=9, device=dev)
              for dev in ("cpu", "cuda")}
    for prog in (WalkProgram.urw(16), WalkProgram.ppr(0.15, 16),
                 WalkProgram.deepwalk(16)):
        want = compile(prog, execution=ExecutionConfig(num_slots=64)).run(
            graphs["cpu"], starts, seed=3)
        got = compile(prog, execution=ExecutionConfig(
            num_slots=64, step_impl="cuda")).run(graphs["cuda"], starts,
                                                 seed=3)
        if not (torch.equal(want.paths, got.paths.cpu())
                and torch.equal(want.lengths, got.lengths.cpu())
                and all(int(x) == int(y)
                        for x, y in zip(want.stats, got.stats))):
            raise AssertionError(f"{prog.name}: card differs from the CPU")
    print("small batch: card (cuda step) == CPU (plain step) for urw, ppr, "
          "deepwalk")


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
    print(build.build_log("walk_step").strip())
    print(card_line())

    t0 = time.perf_counter()
    g = make_dataset("WG", weighted=True, with_alias=True,
                     scale_override=WG_SCALE)
    print(f"graph WG scale {WG_SCALE}: |V|={g.num_vertices} "
          f"|E|={g.num_edges} max_deg={g.max_degree} "
          f"built in {time.perf_counter() - t0:.1f} s")

    rows = check_kernels(g)                                  # phase 2
    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, NUM_STARTS).astype(np.int32)
    launches = run_main_path(g, starts)                      # phase 3
    profile_supersteps(g, starts)
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
