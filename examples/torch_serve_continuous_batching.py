"""LM serving with zero-bubble continuous batching on the PyTorch port
(the counterpart of ``examples/serve_continuous_batching.py``: decode
lanes = walker lanes, requests = queries).

  PYTHONPATH=src python examples/torch_serve_continuous_batching.py  # card
  PYTHONPATH=src python examples/torch_serve_continuous_batching.py \\
      --device cpu

deepseek_7b's reduced (``SMOKE``) config at float32, weights drawn on the
CPU from seed 0 and placed on the device.  The token embedding runs on
the embedding-bag kernel, whose launches the last line counts.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.rng import seeded_generator
from repro_torch.kernels.embedding_bag import LAUNCHES as BAG
from repro_torch.launch.serve import continuous_batching_loop
from repro_torch.models import transformer as tfm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=24)
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_arch("deepseek_7b").SMOKE,
                              dtype=torch.float32)
    params = tfm.init_params(seeded_generator(0), cfg, device=args.device)
    rng = np.random.default_rng(0)

    # variable-priority request stream; all lanes stay busy until drain
    reqs = [torch.as_tensor(rng.integers(0, cfg.vocab, 8), dtype=torch.int32,
                            device=args.device)
            for _ in range(args.requests)]
    t0 = time.time()
    results, stats = continuous_batching_loop(params, cfg, reqs, num_slots=6,
                                              max_new=12, cache_cap=24)
    print(f"served {stats.completed} requests in {time.time()-t0:.1f}s, "
          f"{stats.decode_steps} batched decode steps, "
          f"bubble_ratio={stats.bubble_ratio:.3f}")
    print("sample generation:", results[0])
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in BAG.items()))
    return results, stats


if __name__ == "__main__":
    main()
