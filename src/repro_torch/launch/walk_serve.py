"""Open-system GRW serving entry point — continuous Poisson arrivals
against the streaming walk engine (the queuing setting Theorem VI.1
models).

  PYTHONPATH=src python -m repro_torch.launch.walk_serve --algo urw \
      --dataset WG --rho 0.8 --requests 64 --request-size 16 --slots 512 \
      --chunk 8 --step-impl fused --hops-per-launch 16
  PYTHONPATH=src python -m repro_torch.launch.walk_serve --device cpu --scale 9
  PYTHONPATH=src python -m repro_torch.launch.walk_serve --backend sharded \
      --devices 4 --slots 4096

Sharded serving runs the same service over the sharded superstep, its
``--devices`` shards placed as `repro_torch.launch.walk` places them (in
groups over the visible cards, else on ``--device``; spread over cards the
superstep is 2-5x slower than on one, and ``CUDA_VISIBLE_DEVICES=0``
keeps every shard on one card).

Prints the graph's size, the backend and offered load, the counts
(requests, walks, supersteps, drops), the sojourn percentiles in
supersteps with the admission waits (on a card also the wall sojourn in
ms, submit to the host holding the paths), and the throughput (hops a
superstep, MStep/s over the run's wall time, bubble and starved ratios).
Compare with `repro_torch.launch.walk`, which drains a fixed (closed)
batch.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import walker
from repro_torch.configs.ridgewalker import ALGORITHMS, QUERY_LENGTH
from repro_torch.graph import make_dataset
from repro_torch.serve import OpenLoad, run_open_load


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="urw", choices=sorted(ALGORITHMS))
    ap.add_argument("--backend", default="single",
                    choices=sorted(walker.BACKENDS),
                    help="single device, or sharded into --devices shards "
                         "(in groups over the visible cards)")
    ap.add_argument("--devices", type=int, default=4,
                    help="sharded only: shard count (placed as "
                         "--backend sharded says)")
    ap.add_argument("--dataset", default="WG")
    ap.add_argument("--scale", type=int, default=None,
                    help="RMAT scale override (default: the dataset's "
                         "stand-in scale)")
    ap.add_argument("--rho", type=float, default=0.8,
                    help="offered utilization λ·E[L]/W (>=1 overloads)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--request-size", type=int, default=16,
                    help="walks per request")
    ap.add_argument("--slots", type=int, default=512)
    ap.add_argument("--max-hops", type=int, default=QUERY_LENGTH)
    ap.add_argument("--chunk", type=int, default=8,
                    help="supersteps per host-injection chunk")
    ap.add_argument("--capacity", type=int, default=8192,
                    help="live-query slot-ring capacity (slots recycle "
                    "continuously; this bounds concurrency, not volume)")
    ap.add_argument("--injection-delay", type=int, default=0)
    ap.add_argument("--step-impl", default="torch",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--hops-per-launch", type=int, default=16,
                    help="fused only: supersteps per kernel launch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    spec = ALGORITHMS[args.algo]
    program = walker.WalkProgram(spec=spec, max_hops=args.max_hops,
                                 name=args.algo)
    if args.backend == "sharded":
        if args.step_impl != "torch":
            ap.error("--step-impl only applies to --backend single (the "
                     "sharded superstep is always plain torch)")
        execution = walker.ExecutionConfig(num_slots=args.slots,
                                           num_devices=args.devices)
    else:
        execution = walker.ExecutionConfig(
            num_slots=args.slots, injection_delay=args.injection_delay,
            step_impl=args.step_impl, hops_per_launch=args.hops_per_launch)
    w = walker.compile(program, backend=args.backend, execution=execution)
    weighted = spec.kind in ("alias", "reservoir_n2v")
    g = make_dataset(args.dataset, weighted=weighted,
                     with_alias=spec.kind == "alias",
                     scale_override=args.scale, seed=args.seed,
                     device=args.device)
    print(f"{args.dataset}: |V|={g.num_vertices} |E|={g.num_edges} "
          f"max_deg={g.max_degree} device={g.device}")

    svc = w.serve(g, capacity=args.capacity, chunk=args.chunk,
                  seed=args.seed)
    load = OpenLoad(num_requests=args.requests,
                    request_size=args.request_size,
                    utilization=args.rho)
    a = run_open_load(svc, load, seed=args.seed)
    stats = svc.walk_stats()
    print(f"backend={args.backend} step_impl={args.step_impl} "
          f"offered_load={a.offered_load:.2f} walks/superstep "
          f"(rho={a.utilization:.2f})")
    print(f"requests={a.requests} walks={a.walks} supersteps={a.supersteps} "
          f"launches={stats.launches} drops={int(stats.drops)}")
    wall = ""
    if g.device.type == "cuda":
        ms = np.asarray([r.wall_sojourn for r in svc.drain()]) * 1e3
        wall = (f"; wall ms: p50={np.percentile(ms, 50):.3f} "
                f"p99={np.percentile(ms, 99):.3f}")
    print(f"sojourn supersteps: p50={a.p50_sojourn:.1f} "
          f"p99={a.p99_sojourn:.1f} mean={a.mean_sojourn:.1f} "
          f"(admission wait p50={a.p50_admission_wait:.1f} "
          f"p99={a.p99_admission_wait:.1f}){wall}")
    print(f"throughput={a.throughput:.1f} hops/superstep "
          f"({a.msteps_per_s:.3f} MStep/s) bubble_ratio={a.bubble_ratio:.3f} "
          f"starved_ratio={a.starved_ratio:.3f}")


if __name__ == "__main__":
    main()
