"""LM serving launcher with continuous batching, the reference's
``repro.launch.serve``.

Decode slots are lanes; a finished sequence frees its lane, which is
refilled from the pending-request queue.  Bubble ratio (idle lane-steps /
lane-steps) is reported.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_7b \\
      --requests 64 --slots 8 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The loop is the reference's: a float32 cache, a prefill of one request
at a time into its lane, greedy ``argmax``, and one position a decode
step for every lane (the largest of the active lanes'; see the NOTE in
the loop).  ``--device`` (default ``cuda``) picks the device; the
launcher serves the reduced (``SMOKE``) config at float32, as the
reference's does, from weights drawn on the CPU from seed 0 and placed on
the device: every device serves the same weights, as every backend does
under the reference's ``jax.random`` draw.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.rng import seeded_generator
from repro_torch.graph.csr import resolve_device
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class ServeStats:
    lane_steps: int = 0
    busy_steps: int = 0
    completed: int = 0
    decode_steps: int = 0

    @property
    def bubble_ratio(self):
        return 1.0 - self.busy_steps / max(self.lane_steps, 1)


@torch.no_grad()
def continuous_batching_loop(params, cfg, requests, num_slots: int,
                             max_new: int, cache_cap: int, seed: int = 0):
    """requests: list of 1-D int prompt tensors on the parameters' device.
    Greedy decode, slot refill.  ``seed`` is accepted and unused, as in
    the reference."""
    stats = ServeStats()
    device = params["embed"].device

    # Lane state (host-managed; device state is the batched KV cache).
    caches = tfm.make_kv_cache(cfg, num_slots, cache_cap, torch.float32,
                               device=device)
    cur_tok = torch.zeros((num_slots, 1), dtype=torch.int32, device=device)
    lens = np.zeros(num_slots, np.int32)          # per-lane position
    remaining = np.zeros(num_slots, np.int32)     # tokens left to emit
    active = np.zeros(num_slots, bool)
    outputs = [[] for _ in range(num_slots)]
    results = []
    queue = list(enumerate(requests))
    qhead = 0

    def refill():
        nonlocal qhead
        for lane in range(num_slots):
            if not active[lane] and qhead < len(queue):
                _, prompt = queue[qhead]
                qhead += 1
                # prefill this lane (single-request prefill)
                logits, kv = tfm.prefill(params, prompt[None, :], cfg)
                S = prompt.shape[0]
                # kv: (L, 2, 1, S, H, D) -> written into the lane's cache
                caches[:, :, lane:lane + 1, :S] = kv.to(caches.dtype)
                nxt = torch.argmax(logits[0, -1]).to(torch.int32)
                cur_tok[lane, 0] = nxt
                lens[lane] = S
                remaining[lane] = max_new
                active[lane] = True
                outputs[lane] = [int(nxt)]

    refill()
    while active.any():
        stats.lane_steps += num_slots
        stats.busy_steps += int(active.sum())
        stats.decode_steps += 1
        # NOTE (the reference's): one cache_len a call needs equal lane
        # positions in this simplified host loop; every lane steps at the
        # largest active position.
        pos = int(lens[active].max())
        logits, caches = tfm.decode_step(params, cur_tok, caches, pos, cfg)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        cur_tok = nxt[:, None]
        nxt = nxt.tolist()                        # one read for every lane
        for lane in range(num_slots):
            if not active[lane]:
                continue
            outputs[lane].append(nxt[lane])
            lens[lane] += 1
            remaining[lane] -= 1
            if remaining[lane] <= 0 or lens[lane] >= cache_cap - 1:
                results.append(outputs[lane])
                stats.completed += 1
                active[lane] = False
        refill()
    return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek_7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    if mod.FAMILY != "lm":
        raise ValueError(f"--arch {args.arch}: serving is for LM archs, not "
                         f"family {mod.FAMILY!r}")
    device = resolve_device(args.device)
    cfg = dataclasses.replace(mod.SMOKE, dtype=torch.float32)
    with torch.no_grad():
        params = tfm.init_params(seeded_generator(0), cfg, device=device)
    rng = np.random.default_rng(0)
    reqs = [torch.as_tensor(rng.integers(0, cfg.vocab, args.prompt_len),
                            dtype=torch.int32, device=device)
            for _ in range(args.requests)]
    t0 = time.time()
    results, stats = continuous_batching_loop(
        params, cfg, reqs, args.slots, args.max_new,
        cache_cap=args.prompt_len + args.max_new + 2)
    dt = time.time() - t0
    print(f"completed={stats.completed} decode_steps={stats.decode_steps} "
          f"bubble_ratio={stats.bubble_ratio:.3f} time={dt:.1f}s "
          f"device={device}")
    print("sample output:", results[0][:8])


if __name__ == "__main__":
    main()
