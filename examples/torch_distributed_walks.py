"""Distributed walks over 8 shards via the unified walker API, on the
PyTorch port (the counterpart of ``examples/distributed_walks.py``).

`walker.compile(program, backend="sharded")` runs the full §IV dataflow:
vertex-partitioned graph, per-phase butterfly routing (all_to_all),
flow-controlled zero-bubble refill, streaming path write-back — and the
result is bit-identical to the single-device backend (paper §V-A).

  PYTHONPATH=src python examples/torch_distributed_walks.py \\
      --step-impl fused                                 # on the card
  PYTHONPATH=src python examples/torch_distributed_walks.py --device cpu

The shards are placed as `walker.compile.default_mesh` places them: on
one card (or the CPU) all in one group on the graph's device, over
several cards in groups on the first cards.  The sharded superstep is
plain torch; the single-backend run it is checked against uses
``--step-impl`` (``fused``: the multi-hop kernel, whose launches the last
line counts).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import walker
from repro_torch.graph import make_dataset, partition_graph
from repro_torch.kernels.fused_superstep import LAUNCHES as FUSED
from repro_torch.walker.compile import default_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="shard count (the reference's emulated devices)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--step-impl", default="torch",
                    choices=["torch", "cuda", "fused"],
                    help="the single-backend run's superstep")
    ap.add_argument("--scale", type=int, default=12, help="RMAT scale")
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--max-hops", type=int, default=40)
    args = ap.parse_args(argv)

    n_dev = args.devices
    g = make_dataset("CP", scale_override=args.scale, device=args.device)
    pg = partition_graph(g, n_dev, default_mesh(g, n_dev))
    print(f"graph |V|={g.num_vertices} |E|={g.num_edges}, "
          f"partitioned over {n_dev} channels")

    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, args.queries).astype(np.int32)
    program = walker.WalkProgram.urw(args.max_hops)

    sharded = walker.compile(
        program, backend="sharded",
        execution=walker.ExecutionConfig(slots_per_device=128,
                                         log_capacity=1 << 17))
    t0 = time.time()
    res = sharded.run(pg, starts, seed=0)
    steps = int(res.stats.steps)            # waits for the run
    dt = time.time() - t0
    print(f"distributed: {steps} steps in {dt:.1f}s")
    print(f"route waits={int(res.stats.route_waits)} "
          f"drops={int(res.stats.drops)} (must be 0)")

    ref = walker.compile(
        program, execution=walker.ExecutionConfig(
            num_slots=512, step_impl=args.step_impl)).run(g, starts, seed=0)
    dp, dl = res.as_numpy()
    rp, rl = ref.as_numpy()
    same = bool(np.array_equal(dp, rp) and np.array_equal(dl, rl))
    print("bit-identical to single-device engine:", same)
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in FUSED.items()))
    if g.device.type == "cuda":
        torch.cuda.synchronize(g.device)
    return {"sharded": res, "single": ref, "identical": same}


if __name__ == "__main__":
    main()
