"""Weighted Node2Vec's fused launch, a parent checkout against this one, in
turns on one card.

    python3 tools/reservoir_turns.py PARENT_DIR [OTHER_DIR ...] [--reps N]

``PARENT_DIR`` is an unpacked checkout of the parent commit (``git archive
<commit> | tar -x -C PARENT_DIR``, in a directory ``.gitignore`` lists);
further checkouts (variants of the change) may follow.  The script builds
every tree's fused kernel (nvcc, side by side), makes the WG scale-20
graphs (weighted, alias tables; and 3 edge types for MetaPath) once and
saves them, then runs one process a turn, in the order parent, the
others, this checkout twice, the others in reverse, parent (parent,
change, change, parent for one).  A turn imports its own tree's package and
``chip_smoke.py`` helpers and measures, on the main path's state
(65,536 starts, W = 4,096, ``stream_key(0)``, one plain superstep in):

* the k = 1 and k = 16 weighted Node2Vec launch, device time only
  (``chip_smoke.time_fused``: median ms of fresh-state launches);
* the busiest warp's (lane, chunk) items a superstep over each launch
  (``chip_smoke.busiest_warp``) and the µs an item;
* phase 3's fused runs: each program's fused drain of the 65,536 starts
  (80 hops, k = 16) after a warm-up, its wall s and its fused kernel's
  device ms (a device trace), and weighted Node2Vec's share of each sum.

Each turn prints one JSON line; the script prints the card's name and
power limit, then a summary line a tree (its two turns' values), each
tree named by its directory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = ("urw", "ppr", "deepwalk", "metapath", "node2vec", "node2vec_w")


def _tree_env(tree):
    return dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))


def _graphs_file(out_dir):
    return os.path.join(out_dir, "wg20_graphs.pt")


def make_graphs(path) -> None:
    """The WG scale-20 graphs of chip_smoke.py's phase 1, saved to
    ``path`` (their generator is the same code in both trees)."""
    import dataclasses

    import torch

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.graph import make_dataset
    g = make_dataset("WG", weighted=True, with_alias=True,
                     scale_override=20)
    gt = make_dataset("WG", num_edge_types=3, scale_override=20)
    torch.save({name: {f.name: getattr(x, f.name)
                       for f in dataclasses.fields(x)}
                for name, x in (("g", g), ("gt", gt))}, path)


def turn(graphs_path, reps) -> dict:
    """One turn in this process's tree (cwd): the launches and drains."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from repro_torch.core.rng import stream_key
    from repro_torch.core.walk_engine import EngineConfig
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.kernels.fused_superstep import ops
    from repro_torch.walker import ExecutionConfig, compile
    saved = torch.load(graphs_path, map_location="cuda")
    g, gt = (CSRGraph(**saved[k]) for k in ("g", "gt"))
    graphs = {name: gt if name == "metapath" else g for name in PROGRAMS}
    starts_np = np.random.default_rng(0).integers(
        0, g.num_vertices, cs.NUM_STARTS).astype(np.int32)
    prog = cs.programs()["node2vec_w"]
    out = {"tree": os.getcwd()}
    for k in (1, cs.HOPS_PER_LAUNCH):
        cfg = EngineConfig(num_slots=cs.NUM_SLOTS, max_hops=cs.MAX_HOPS,
                           mode="zero_bubble", injection_delay=0,
                           step_impl="fused",
                           hops_per_launch=cs.HOPS_PER_LAUNCH)
        key = tuple(int(x) for x in stream_key(0))
        state, depth = cs.main_path_state(g, prog, cfg, key, starts_np)

        def kernel(st, block, k=k, cfg=cfg, depth=depth, key=key):
            return ops.fused_superstep(g, prog.spec, cfg, depth, st, key, k,
                                       block)
        ms = cs.time_fused(kernel, state, device_only=True, reps=reps)
        seq = cs.launch_slots(kernel, state, k)
        grid = ops.grid(prog.spec, cfg, g.device)
        mean, top = cs.busiest_warp(g, prog.spec,
                                    grid.blocks * grid.threads // 32, seq)
        out[f"k{k}"] = {"ms": ms, "supersteps": len(seq),
                        "busiest_items": mean, "most_items": top,
                        "us_per_item": ms / len(seq) / mean * 1e3}
    walls, device = {}, {}
    starts = torch.from_numpy(starts_np).cuda()
    for name in PROGRAMS:
        w = compile(cs.programs()[name], execution=ExecutionConfig(
            num_slots=cs.NUM_SLOTS, record_paths=True, step_impl="fused",
            hops_per_launch=cs.HOPS_PER_LAUNCH))
        w.run(graphs[name], starts[:cs.NUM_SLOTS], seed=0)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.run(graphs[name], starts, seed=0)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        with cs.device_trace() as prof:
            w.run(graphs[name], starts, seed=0)
            torch.cuda.synchronize()
        device[name] = sum(us for us, _, n in cs.device_rows(prof)
                           if "fused_superstep_kernel" in n) / 1e3
    out["phase3_wall_s"] = walls
    out["phase3_kernel_ms"] = device
    out["n2vw_wall_share"] = walls["node2vec_w"] / sum(walls.values())
    out["n2vw_kernel_share"] = device["node2vec_w"] / sum(device.values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*",
                    help="the parent checkout, then any other checkouts")
    ap.add_argument("--reps", type=int, default=30,
                    help="timed launches a k (median)")
    ap.add_argument("--turn", metavar="GRAPHS", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.turn, args.reps)))
        return 0
    if not args.trees:
        ap.error("the parent checkout is needed")
    import torch
    if not torch.cuda.is_available():
        print("reservoir_turns.py: CUDA is not available", file=sys.stderr)
        return 1
    others = [os.path.abspath(t) for t in args.trees]
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import build; "
         "build.build(['fused_superstep'])"], env=_tree_env(tree), cwd=tree)
        for tree in (*others, HERE)]
    make_graphs(_graphs_file(out_dir))
    if any(p.wait() != 0 for p in builds):
        raise RuntimeError("a tree's fused kernel did not build")
    print(f"builds and graphs: {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0])
    runs = {}
    order = [*others, HERE, HERE, *reversed(others)]
    for tree in order:
        label = "change" if tree == HERE else os.path.basename(tree)
        r = subprocess.run(
            [sys.executable, os.path.join(HERE, "tools",
                                          "reservoir_turns.py"),
             "--turn", _graphs_file(out_dir), "--reps", str(args.reps)],
            env=_tree_env(tree), cwd=tree, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{label} turn failed:\n{r.stdout}\n"
                               f"{r.stderr}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"turn {label}: {json.dumps(res)}")
        runs.setdefault(label, []).append(res)
    for label, rs in runs.items():
        parts = [f"k=1 {[r['k1']['ms'] for r in rs]} ms",
                 f"k=16 {[r['k16']['ms'] for r in rs]} ms",
                 f"us/item k=1 {[r['k1']['us_per_item'] for r in rs]}",
                 f"us/item k=16 {[r['k16']['us_per_item'] for r in rs]}",
                 f"node2vec_w share of phase 3's fused kernel ms "
                 f"{[r['n2vw_kernel_share'] for r in rs]}",
                 f"of its fused drains' wall "
                 f"{[r['n2vw_wall_share'] for r in rs]}"]
        print(f"{label}: " + "; ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
