"""Perf hillclimb tool, the reference's ``repro.launch.perf``: count a
dry-run cell with config overrides and compare its roofline terms with
the baseline record of the same cell.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch deepseek_7b \\
      --shape train_4k --tag vpce --set vocab_parallel_ce=true

Results land in experiments/perf/single/<arch>__<shape>__<tag>.json and a
delta line is printed.  The counts and terms are ``launch.dryrun``'s:
``meta`` tensors, the H100's data-sheet peaks.
"""
from __future__ import annotations

import argparse
import json
import os


def parse_val(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (dotted paths ok)")
    ap.add_argument("--baseline-dir", default="experiments/dryrun")
    ap.add_argument("--out", default="experiments/perf")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    from repro_torch.launch.dryrun import run_cell
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_val(v)

    rec = run_cell(args.arch, args.shape, multi_pod=False, out_dir=args.out,
                   force=args.force, overrides=overrides, tag=args.tag)
    base_path = os.path.join(args.baseline_dir, "single",
                             f"{args.arch}__{args.shape}.json")
    base = None
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)

    if rec["status"] != "ok":
        print(f"FAIL: {rec['error'][:300]}")
        return
    r = rec["roofline"]
    line = (f"{args.arch}/{args.shape} [{args.tag}] "
            f"compute={r['compute_s']:.3e} memory={r['memory_s']:.3e} "
            f"coll={r['collective_s']:.3e} bound={r['bound_s']:.3e} "
            f"dom={r['dominant']}")
    if base and base.get("status") == "ok":
        b = base["roofline"]
        line += (f"  | vs baseline bound={b['bound_s']:.3e}: "
                 f"{b['bound_s']/r['bound_s']:.2f}x better "
                 f"(coll {b['collective_s']/max(r['collective_s'],1e-12):.2f}x,"
                 f" mem {b['memory_s']/max(r['memory_s'],1e-12):.2f}x)")
    print(line)


if __name__ == "__main__":
    main()
