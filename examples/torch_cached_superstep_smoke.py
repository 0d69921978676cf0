"""Cached fused-superstep smoke on the PyTorch port: the gather hierarchy
on a skewed graph (the counterpart of
``examples/cached_superstep_smoke.py``).

Runs one fused closed batch twice on a small Graph500-skewed RMAT —
hot-vertex cache off, then on — and asserts the hierarchy's contract:

  * bit-identical paths, lengths, and every pre-existing stat
    (a hit reads the same bytes from the cache block instead of the
    graph's arrays in device memory);
  * a nonzero hit rate (the skewed degree distribution concentrates
    gather traffic on hubs the budget admits);
  * zero cache counters when the cache is off.

  PYTHONPATH=src python examples/torch_cached_superstep_smoke.py  # card
  PYTHONPATH=src python examples/torch_cached_superstep_smoke.py \\
      --device cpu --scale 8 --queries 96 --max-hops 10 --budget 4096

The last line counts the fused kernel's launches (none on the CPU, where
its plain version runs).
"""
import argparse

import numpy as np

from repro_torch import walker
from repro_torch.graph import build_csr
from repro_torch.graph.generators import GRAPH500, rmat_edges
from repro_torch.kernels.fused_superstep import LAUNCHES as FUSED


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=8, help="RMAT scale")
    ap.add_argument("--queries", type=int, default=96)
    ap.add_argument("--max-hops", type=int, default=10)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--hops-per-launch", type=int, default=8)
    ap.add_argument("--budget", type=int, default=1 << 12,
                    help="hot-vertex cache byte budget (the default covers "
                         "the hubs of the scale-8 fixture but not its tail, "
                         "so both the hit and the miss path run)")
    args = ap.parse_args(argv)

    edges, n = rmat_edges(args.scale, 8, GRAPH500, seed=2)
    g = build_csr(edges, n, device=args.device)
    print(f"graph: |V|={g.num_vertices} |E|={g.num_edges} "
          f"max_deg={g.max_degree}")

    starts = np.random.default_rng(7).integers(0, n, args.queries)
    program = walker.WalkProgram.urw(args.max_hops)

    def run(cache_budget):
        ex = walker.ExecutionConfig(num_slots=args.slots, step_impl="fused",
                                    hops_per_launch=args.hops_per_launch,
                                    cache_budget=cache_budget)
        return walker.compile(program, execution=ex).run(g, starts, seed=0)

    off = run(0)
    on = run(args.budget)

    p_off, l_off = off.as_numpy()
    p_on, l_on = on.as_numpy()
    assert np.array_equal(p_off, p_on), "cached paths diverged from uncached"
    assert np.array_equal(l_off, l_on), "cached lengths diverged from uncached"
    for f in off.stats._fields:
        if f in ("launches", "cache_hits", "cache_misses", "cache_coalesced"):
            continue
        assert int(getattr(off.stats, f)) == int(getattr(on.stats, f)), f

    hits = int(on.stats.cache_hits)
    misses = int(on.stats.cache_misses)
    coal = int(on.stats.cache_coalesced)
    rate = float(on.stats.cache_hit_rate())
    assert hits > 0, "cache served no gathers on the skewed fixture"
    assert rate > 0.0
    for f in ("cache_hits", "cache_misses", "cache_coalesced"):
        assert int(getattr(off.stats, f)) == 0, f

    print(f"cache-off == cache-on: paths/lengths/stats bit-identical over "
          f"{args.queries} walks")
    print(f"cache: hits={hits} misses={misses} coalesced={coal} "
          f"hit_rate={rate:.3f} budget={args.budget}B")
    print("OK")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in FUSED.items()))
    return off, on


if __name__ == "__main__":
    main()
