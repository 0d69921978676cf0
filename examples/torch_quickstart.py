"""Quickstart on the PyTorch port: compile one `WalkProgram` per GRW
algorithm and run it (the counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py          # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --step-impl fused
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
      --scale 10 --queries 300 --max-hops 16                  # no card

``--step-impl`` picks the superstep: ``torch`` (plain tensor ops),
``cuda`` (the one-hop walk-step kernels; the kinds they do not cover run
the plain superstep) or ``fused`` (the kernel that runs
``--hops-per-launch`` whole supersteps a launch).  The last line counts
the kernel launches of the run (none on the CPU, where every kernel's
plain version runs).
"""
import argparse

import numpy as np

from repro_torch import walker
from repro_torch.core.scheduler import analyze_run
from repro_torch.graph import make_dataset
from repro_torch.kernels.fused_superstep import LAUNCHES as FUSED
from repro_torch.kernels.walk_step import LAUNCHES as STEP


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=12, help="RMAT scale")
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--max-hops", type=int, default=80)
    ap.add_argument("--slots", type=int, default=512)
    ap.add_argument("--step-impl", default="torch",
                    choices=["torch", "cuda", "fused"],
                    help="superstep implementation (fused = the "
                         "device-resident multi-hop kernel)")
    ap.add_argument("--hops-per-launch", type=int, default=16,
                    help="fused only: supersteps per kernel launch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # Graph500-skewed RMAT stand-in for web-Google (paper Table II).
    g = make_dataset("WG", scale_override=args.scale, weighted=True,
                     with_alias=True, num_edge_types=3, device=args.device)
    print(f"graph: |V|={g.num_vertices} |E|={g.num_edges} "
          f"max_deg={g.max_degree}")

    starts = np.random.default_rng(0).integers(0, g.num_vertices,
                                               args.queries)
    H = args.max_hops
    execution = walker.ExecutionConfig(num_slots=args.slots,
                                       step_impl=args.step_impl,
                                       hops_per_launch=args.hops_per_launch)

    programs = [
        ("URW", walker.WalkProgram.urw(H)),
        ("PPR(α=.15)", walker.WalkProgram.ppr(0.15, H)),
        ("DeepWalk", walker.WalkProgram.deepwalk(H)),
        ("Node2Vec(2,.5)", walker.WalkProgram.node2vec(2.0, 0.5, H)),
        ("MetaPath[0,1,2]", walker.WalkProgram.metapath([0, 1, 2], H)),
    ]

    out = {}
    for name, program in programs:
        res = walker.compile(program, execution=execution).run(g, starts)
        a = analyze_run(res.stats)
        paths, lengths = res.as_numpy()
        print(f"{name:16s} steps={a.steps:7d} supersteps={a.supersteps:5d} "
              f"occupancy={a.occupancy:.2f} mean_len={lengths.mean():.1f} "
              f"supersteps/launch={a.supersteps_per_launch:.1f}")
        out[name] = (a, paths, lengths)

    paths, lengths = res.as_numpy()
    print("\nfirst MetaPath walk:", paths[0][: lengths[0]])
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in {**STEP, **FUSED}.items()))
    return out


if __name__ == "__main__":
    main()
