"""Serve walk requests as an open system on the PyTorch port: submit,
poll, harvest (the counterpart of ``examples/serve_walk_requests.py``).

Two tenants submit request waves at different times; the service keeps the
lane pool busy across both, and each tenant harvests exactly its own walks
(request id → ``(epoch, qid)`` slot bookkeeping: each walk occupies a
slot of the device ring, and completed slots are recycled to later
arrivals with a bumped epoch — continuous operation, no drain barrier).

  PYTHONPATH=src python examples/torch_serve_walk_requests.py \\
      --step-impl fused                                 # on the card
  PYTHONPATH=src python examples/torch_serve_walk_requests.py --device cpu

The last line counts the fused kernel's launches (none on the CPU, or
under ``--step-impl torch``).
"""
import argparse

import numpy as np

from repro_torch import walker
from repro_torch.graph import make_dataset
from repro_torch.kernels.fused_superstep import LAUNCHES as FUSED


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--step-impl", default="torch",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--scale", type=int, default=11, help="RMAT scale")
    args = ap.parse_args(argv)

    g = make_dataset("WG", scale_override=args.scale, device=args.device)
    print(f"graph: |V|={g.num_vertices} |E|={g.num_edges}")

    svc = walker.compile(
        walker.WalkProgram.urw(20),
        execution=walker.ExecutionConfig(
            num_slots=256, step_impl=args.step_impl)).serve(
                g, capacity=4096, chunk=4, seed=0)
    rng = np.random.default_rng(0)

    # Tenant A submits three requests; the service starts working at once.
    a_rids = [svc.submit(rng.integers(0, g.num_vertices, 32))
              for _ in range(3)]
    svc.step()
    print(f"after 1 chunk: inflight={svc.num_inflight} clock={svc.clock}")

    # Tenant B arrives mid-stream — no recompilation, no drain barrier.
    b_rids = [svc.submit(rng.integers(0, g.num_vertices, 64))
              for _ in range(2)]
    svc.drain()

    for tenant, rids in (("A", a_rids), ("B", b_rids)):
        for rid in rids:
            r = svc.poll(rid)
            print(f"tenant {tenant} request {rid}: {r.num_walks} walks, "
                  f"slots [{r.qids.min()},{r.qids.max()}] epoch "
                  f"{r.epochs.min()}..{r.epochs.max()}, "
                  f"wait={r.admission_wait} sojourn={r.sojourn} supersteps, "
                  f"mean_len={r.lengths.mean():.1f}")

    r = svc.poll(b_rids[0])
    print("\nfirst walk of tenant B's first request:",
          r.paths[0][: r.lengths[0]])

    a = svc.analyze()
    print(f"\nservice: {a.walks} walks in {a.supersteps} supersteps, "
          f"bubble_ratio={a.bubble_ratio:.2f}, "
          f"p99_sojourn={a.p99_sojourn:.0f} supersteps, "
          f"p99_admission_wait={a.p99_admission_wait:.0f}")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in FUSED.items()))
    return {"a": [svc.poll(rid) for rid in a_rids],
            "b": [svc.poll(rid) for rid in b_rids], "analysis": a}


if __name__ == "__main__":
    main()
