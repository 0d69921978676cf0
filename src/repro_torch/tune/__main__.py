"""Autotune CLI: populate the persistent tuning cache.

    PYTHONPATH=src python -m repro_torch.tune --cache tune_cache.json
    PYTHONPATH=src python -m repro_torch.tune --no-measure --device cpu

Tunes one (sampler kind x step_impl) grid per requested combination on
a synthetic dataset (the WG stand-in at ``--scale``) on ``--device``
(default the card; without one the graph builder raises), writing each
chosen config into the JSON cache.  Measured tuning times runs on that
device.  Point ``RIDGEWALKER_TUNE_CACHE`` at the written file (or set
``ExecutionConfig.tune_cache``) and any ``ExecutionConfig`` with
``"auto"`` sentinels resolves through it for graphs on the same device.
"""
from __future__ import annotations

import argparse
import sys


def _program_for(kind: str, max_hops: int):
    from repro_torch.walker.program import WalkProgram
    if kind == "uniform":
        return WalkProgram.urw(max_hops)
    if kind == "alias":
        return WalkProgram.deepwalk(max_hops)
    if kind == "rejection_n2v":
        return WalkProgram.node2vec(2.0, 0.5, max_hops)
    if kind == "reservoir_n2v":
        return WalkProgram.node2vec(2.0, 0.5, max_hops, weighted=True)
    if kind == "metapath":
        return WalkProgram.metapath([0, 1, 2], max_hops)
    raise SystemExit(f"unknown sampler kind {kind!r}")


def main(argv=None) -> int:
    from repro_torch.graph import make_dataset
    from repro_torch.tune import TuningCache, WalkMeasurer, autotune
    from repro_torch.walker.execution import ExecutionConfig

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="populate the walk-engine tuning cache")
    ap.add_argument("--no-measure", action="store_true",
                    help="model-only ranking (no wall-clock)")
    ap.add_argument("--cache", default="tune_cache.json",
                    help="JSON cache path to read/extend (default: "
                         "tune_cache.json)")
    ap.add_argument("--dataset", default="WG")
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--max-hops", type=int, default=16)
    ap.add_argument("--kinds", default="uniform,reservoir_n2v",
                    help="comma list of sampler kinds to tune")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the graph lives and runs are timed")
    ap.add_argument("--step-impls", default="torch",
                    help="comma list of step_impl values to tune")
    ap.add_argument("--keep", type=int, default=6,
                    help="model-pruned candidates to measure")
    ap.add_argument("--repeats", type=int, default=3,
                    help="min-of-k timing repeats")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--force", action="store_true",
                    help="retune even on a cache hit")
    args = ap.parse_args(argv)

    g = make_dataset(args.dataset, scale_override=args.scale, weighted=True,
                     with_alias=True, num_edge_types=3, device=args.device)
    cache = TuningCache(args.cache)
    measurer = None if args.no_measure else WalkMeasurer(
        repeats=args.repeats)
    mode = "model-only" if args.no_measure else "measured"
    for kind in [k for k in args.kinds.split(",") if k]:
        program = _program_for(kind, args.max_hops)
        for impl in [s for s in args.step_impls.split(",") if s]:
            execution = ExecutionConfig(record_paths=False, step_impl=impl)
            res = autotune(g, program, execution,
                           num_queries=args.queries, seed=args.seed,
                           measurer=measurer, cache=cache, keep=args.keep,
                           use_cache=not args.force)
            if args.force:
                cache.save()
            print(f"{kind}/{impl} [{res.source}] -> {res.candidate}")
    path = cache.save()
    print(f"# {mode} tuning cache: {len(cache)} entr"
          f"{'y' if len(cache) == 1 else 'ies'} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
