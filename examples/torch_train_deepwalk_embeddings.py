"""End-to-end example on the PyTorch port: device-resident walks →
DeepWalk embeddings.

One call — ``Walker.train_embeddings`` — runs the whole pipeline: walk
rounds land in the corpus ring on the device, the consumer samples
(center, context, negatives) windows straight out of it, and SGNS grad
steps (the embedding-bag and segment-sum kernels) train the embedding
tables.  Round ``r+1``'s walks are produced on a thread of their own,
under a CUDA stream of their own, while round ``r``'s grad steps run.
The paths never visit the host (``corpus_ring.no_host_copies`` holds
that here); pass ``--serial`` to time the naive host round-trip wiring
instead — the result is bit-identical either way.

  PYTHONPATH=src python examples/torch_train_deepwalk_embeddings.py \\
      --scale 12 --dim 64 --rounds 8 --steps-per-round 48

On a machine without a card add ``--device cpu`` (and a small
``--scale``).
"""
import argparse
import contextlib
import time

import torch

from repro_torch import walker
from repro_torch.core import corpus_ring
from repro_torch.graph import make_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps-per-round", type=int, default=48)
    ap.add_argument("--walks-per-round", type=int, default=4096)
    ap.add_argument("--walk-len", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--serial", action="store_true",
                    help="naive baseline: host round-trip, no overlap")
    ap.add_argument("--backend", choices=["single", "sharded"],
                    default="single")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint (and resume) here; none by default")
    args = ap.parse_args(argv)

    g = make_dataset("WG", scale_override=args.scale, weighted=True,
                     with_alias=True, device=args.device)
    print(f"graph |V|={g.num_vertices} |E|={g.num_edges} on {args.device}")

    execution = (walker.ExecutionConfig(step_impl="fused")
                 if args.backend == "single" else None)
    w = walker.compile(walker.WalkProgram.deepwalk(args.walk_len),
                       backend=args.backend, execution=execution)
    guard = (contextlib.nullcontext() if args.serial
             else corpus_ring.no_host_copies())
    copies = corpus_ring.host_copies()
    t0 = time.perf_counter()
    with guard:
        out = w.train_embeddings(
            g, seed=0, rounds=args.rounds,
            walks_per_round=args.walks_per_round,
            steps_per_round=args.steps_per_round, batch_size=args.batch,
            dim=args.dim, window=5, num_negatives=5,
            overlap=not args.serial, ckpt_dir=args.ckpt_dir,
            ckpt_every=max(16, args.steps_per_round) if args.ckpt_dir else 0,
            log_every=16)
    if out["params"]["in_embed"].is_cuda:
        torch.cuda.synchronize(out["params"]["in_embed"].device)
    dt = time.perf_counter() - t0

    walks = args.rounds * args.walks_per_round
    samples = out["step"] * args.batch
    mode = "serial" if args.serial else "overlapped"
    print(f"{mode}: {walks} walks → {out['step']} grad steps "
          f"({samples / dt:.0f} samples/sec) in {dt:.1f}s; "
          f"path host round-trips: {corpus_ring.host_copies() - copies}")
    if out["history"]:
        print("loss trajectory:",
              [f"{h['step']}:{h['loss']:.3f}" for h in out["history"][::3]])
    print(f"tables: in_embed{tuple(out['params']['in_embed'].shape)}"
          + (f"; checkpoints in {args.ckpt_dir}" if args.ckpt_dir else ""))
    return out


if __name__ == "__main__":
    main()
