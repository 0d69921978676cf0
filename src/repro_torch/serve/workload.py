"""Synthetic open-system workloads for the walk service.

Poisson arrivals at a target *offered load* λ (walks/superstep), expressed
relative to the lane service capacity: with W lanes and mean walk length
E[L], the system completes ~W/E[L] walks per superstep, so utilization
ρ = λ·E[L]/W.  Sweeping ρ past 1.0 drives the service into overload —
the regime where sojourn time diverges (Theorem VI.1's queue keeps *lanes*
busy; it cannot create capacity).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.scheduler import ServiceAnalysis
from repro_torch.serve.service import WalkService


@dataclasses.dataclass(frozen=True)
class OpenLoad:
    """Poisson request arrivals against a WalkService."""

    num_requests: int = 64        # total requests to offer
    request_size: int = 16        # walks per request
    utilization: float = 0.5      # ρ — target fraction of lane capacity
    mean_walk_len: Optional[float] = None  # E[L]; default svc.max_hops

    def walks_per_superstep(self, svc) -> float:
        """λ for target ρ; ``svc`` is a WalkService (or anything exposing
        ``num_slots``/``max_hops``)."""
        mean_len = self.mean_walk_len or float(svc.max_hops)
        return self.utilization * svc.num_slots / mean_len


def run_open_load(svc: WalkService, load: OpenLoad,
                  seed: int = 0) -> ServiceAnalysis:
    """Drive ``svc`` with Poisson arrivals and drain; returns the analysis.

    Arrivals are generated chunk by chunk on the *superstep* clock: each
    iteration submits ``Poisson(λ·t / request_size)`` requests, where ``t``
    is the number of supersteps the previous chunk actually executed (the
    engine stops early when work drains, and an idle chunk counts as a full
    ``chunk`` of elapsed time).  Chunk granularity is thus part of the
    measured sojourn — the honest cost of host-side injection.  The same
    ``seed`` and the same sequence of executed chunks give the same
    submissions.
    """
    rng = np.random.default_rng(seed)
    lam = load.walks_per_superstep(svc)
    nv = svc.graph.num_vertices

    t0 = time.perf_counter()
    submitted = 0
    elapsed = svc.chunk  # supersteps of arrival time covered this iteration
    while submitted < load.num_requests:
        n_req = int(rng.poisson(lam * elapsed / load.request_size))
        for _ in range(min(n_req, load.num_requests - submitted)):
            starts = rng.integers(0, nv, load.request_size).astype(np.int32)
            svc.submit(starts)
            submitted += 1
        ran = svc.step()
        elapsed = ran if ran > 0 else svc.chunk
    svc.drain()
    dt = time.perf_counter() - t0
    return svc.analyze(offered_load=lam, wall_time_s=dt)
