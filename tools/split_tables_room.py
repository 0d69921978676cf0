"""SGNS tables that one card cannot hold, trained in row blocks over the
cards.

    python3 tools/split_tables_room.py [--scale 25] [--dim 128] [--steps 4]
                                       [--hops 16] [--cpu]

The sharded backend's ``train_embeddings`` keeps both tables and their
AdamW moments in row blocks over its shard groups, one slab a group
(``distributed.row_blocks.RowBlocks``), and gathers and updates each slab on
its own device.  This script makes a graph of 2^scale vertices with the
repo's generator (``graph.generators.erdos_renyi_edges``, 2 edges a
vertex, on the CPU), partitions it into 4 shards, one group a card of
4, and trains URW walks into embeddings of ``--dim`` (2 rounds of
8,192 walks, batch 4,096) with one slab a card.  At scale 25
and dim 128 the two tables, their dense gradients and their two moments
are 8 x 2^25 x 128 x 4 B = 128 GiB, more than one card's memory.

It prints the card's name and power limit a card, the bytes the tables
need beside one card's memory, each slab's device and shape, each step's
loss and gradient norm, the run's wall, and each card's peak memory
(``torch.cuda.max_memory_allocated``, reset after the graph is placed);
it fails unless every slab lies on its own card, every table and moment
is finite and no card's peak reaches half the whole tables' bytes.
``--cpu`` puts every group on the CPU, to check the script at a small
``--scale``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARDS = 4            # one shard group a card
ROUNDS = 2
WALKS_PER_ROUND = 8_192


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=25)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--hops", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="every group on the CPU (a check of the script at "
                    "a small --scale; no memory is read)")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import walker
    from repro_torch.distributed import Mesh
    from repro_torch.graph import partition_graph
    from repro_torch.graph.csr import build_csr
    from repro_torch.graph.generators import erdos_renyi_edges
    from repro_torch.kernels import build
    from repro_torch.distributed.row_blocks import RowBlocks

    if args.cpu:
        cards = [torch.device("cpu")] * CARDS
    elif torch.cuda.device_count() < CARDS:
        print(f"needs {CARDS} cards", file=sys.stderr)
        return 1
    else:
        cards = [torch.device("cuda", i) for i in range(CARDS)]
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        build.build(["embedding_bag", "segment_sum"])
    t0 = time.perf_counter()
    nv = 1 << args.scale
    g = build_csr(erdos_renyi_edges(nv, 2 * nv, seed=0), nv, device="cpu")
    edges = g.num_edges
    mesh = Mesh(CARDS, cards)
    pg = partition_graph(g, CARDS, mesh)
    del g
    need = 8 * nv * args.dim * 4
    print(f"graph and partition: {time.perf_counter() - t0:.1f} s; "
          f"|V| = {nv}, |E| = {edges}; tables, gradients and moments "
          f"{need / 2**30:.3f} GiB")
    gpus = [] if args.cpu else cards
    if gpus:
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"one card holds {total / 2**30:.3f} GiB")
    for d in gpus:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    w = walker.compile(walker.WalkProgram.urw(args.hops), backend="sharded",
                       mesh=mesh, execution=walker.ExecutionConfig(
                           slots_per_device=1024))
    t0 = time.perf_counter()
    out = w.train_embeddings(pg, seed=0, rounds=ROUNDS,
                             walks_per_round=WALKS_PER_ROUND,
                             steps_per_round=args.steps, batch_size=4_096,
                             dim=args.dim, window=5, num_negatives=5,
                             log_every=1)
    for d in gpus:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    peaks = [torch.cuda.max_memory_allocated(d) for d in gpus]
    failures = []
    for k in ("in_embed", "out_embed"):
        for t, x in (("params", out["params"][k]),
                     ("mu", out["opt_state"].mu[k]),
                     ("nu", out["opt_state"].nu[k])):
            if not isinstance(x, RowBlocks) or x.devices != tuple(cards):
                failures.append(f"{t}.{k} is not one slab a card: {x!r}")
                continue
            if not all(bool(torch.isfinite(s).all()) for s in x.slabs):
                failures.append(f"{t}.{k} has a value that is not finite")
        print(f"{k}: {out['params'][k]!r}")
    for h in out["history"]:
        print(f"step {h['step']}: loss {h['loss']:.6f} grad_norm "
              f"{h['grad_norm']:.6f} dt {h['dt_s'] * 1e3:.3f} ms")
    print(f"{ROUNDS * WALKS_PER_ROUND} walks and {out['step']} steps in "
          f"{wall:.3f} s; peak memory "
          + (", ".join(f"{d} {p / 2**30:.3f} GiB"
                       for d, p in zip(gpus, peaks)) or "not read on the CPU")
          + f" (table-sized buffers {need / CARDS / 2**30:.3f} GiB a "
          f"card)")
    if peaks and max(peaks) >= need // 2:
        failures.append("a card's peak reached half the whole tables' bytes")
    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print("split tables room: every slab on its own card, finite")
    return 0


if __name__ == "__main__":
    sys.exit(main())
