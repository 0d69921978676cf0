"""GRW closed-batch runner on the walker API (`repro_torch.walker.compile`).

  PYTHONPATH=src python -m repro_torch.launch.walk --algo deepwalk \
      --dataset WG --queries 2000 --slots 1024 --step-impl fused \
      --hops-per-launch 16
  PYTHONPATH=src python -m repro_torch.launch.walk --device cpu --scale 9
  PYTHONPATH=src python -m repro_torch.launch.walk --algo node2vec \
      --backend sharded --devices 4 --slots 4096

``--distributed`` is an alias for ``--backend sharded``, as in the
reference.

Prints the graph's size and one summary line (steps, supersteps, launches,
MStep/s, occupancy, starved lane-supersteps, drops; route waits on the
sharded backend).  Throughput is wall time around the drain, on the device
named by ``--device``.  ``--backend sharded`` partitions the graph into
``--devices`` shards (the plain torch superstep), placed as
`repro_torch.walker.compile.default_mesh` places them: on a machine with
several cards, in G groups on the first G cards, G the largest divisor of
the shard count that is at most the number of cards; otherwise all on
``--device``.  Spread over cards, the superstep is slower than on one card
(on four H100s, URW at 4 x 1,024 lanes: 24.14 ms a superstep on one card,
61.25 on 2, 98.31 on 4; ``PERF.md``); ``CUDA_VISIBLE_DEVICES=0`` keeps every
shard on one card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import walker
from repro_torch.configs.ridgewalker import ALGORITHMS, QUERY_LENGTH
from repro_torch.core.scheduler import analyze_run
from repro_torch.graph import make_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="urw", choices=sorted(ALGORITHMS))
    ap.add_argument("--dataset", default="WG")
    ap.add_argument("--scale", type=int, default=None,
                    help="RMAT scale override (default: the dataset's "
                         "stand-in scale)")
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--max-hops", type=int, default=QUERY_LENGTH)
    ap.add_argument("--mode", default="zero_bubble",
                    choices=["zero_bubble", "static"])
    ap.add_argument("--step-impl", default="torch",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--hops-per-launch", type=int, default=16,
                    help="fused only: supersteps per kernel launch")
    ap.add_argument("--backend", default="single",
                    choices=list(walker.BACKENDS))
    ap.add_argument("--distributed", action="store_true",
                    help="alias for --backend sharded")
    ap.add_argument("--devices", type=int, default=8,
                    help="sharded only: shard count (placed over the "
                         "visible cards by the default mesh rule, which "
                         "runs 2-5x slower than one card; "
                         "CUDA_VISIBLE_DEVICES=0 keeps them on one)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--record-paths", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    spec = ALGORITHMS[args.algo]
    program = walker.WalkProgram(spec=spec, max_hops=args.max_hops,
                                 name=args.algo)
    backend = "sharded" if args.distributed else args.backend
    if backend == "sharded":
        if args.mode != "zero_bubble" or args.step_impl != "torch":
            ap.error("--mode/--step-impl only apply to --backend single "
                     "(the sharded superstep is always zero-bubble torch)")
        execution = walker.ExecutionConfig(
            num_slots=args.slots, record_paths=args.record_paths,
            num_devices=args.devices)
    else:
        execution = walker.ExecutionConfig(
            num_slots=args.slots, record_paths=args.record_paths,
            mode=args.mode, step_impl=args.step_impl,
            hops_per_launch=args.hops_per_launch)
    w = walker.compile(program, backend=backend, execution=execution)
    g = make_dataset(args.dataset,
                     weighted=spec.kind in ("alias", "reservoir_n2v"),
                     with_alias=spec.kind == "alias",
                     scale_override=args.scale, seed=args.seed,
                     device=args.device)
    print(f"{args.dataset}: |V|={g.num_vertices} |E|={g.num_edges} "
          f"max_deg={g.max_degree} device={g.device}")
    rng = np.random.default_rng(args.seed)
    starts = rng.integers(0, g.num_vertices, args.queries).astype(np.int32)

    t0 = time.perf_counter()
    res = w.run(g, starts, seed=args.seed)
    if g.device.type == "cuda":
        torch.cuda.synchronize(g.device)
    dt = time.perf_counter() - t0
    a = analyze_run(res.stats, dt)
    print(f"steps={a.steps} supersteps={a.supersteps} launches={a.launches} "
          f"throughput={a.msteps_per_s:.3f} MStep/s "
          f"occupancy={a.occupancy:.3f} starved={a.starved} drops={a.drops}"
          + (f" route_waits={a.route_waits} shards={args.devices}"
             if backend == "sharded" else ""))


if __name__ == "__main__":
    main()
