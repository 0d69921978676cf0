"""Measurement backends for the autotuner.

**This is the only module of the tuner allowed to read a clock.**
Everything else in ``repro_torch.tune`` works over injected costs, the
analytical model, or the cache — so tests exercise the full tuning
pipeline with a deterministic :class:`InjectedMeasurer` and the library
never times anything unless explicitly asked to.

A *measurer* is any callable

    measurer(candidates, runners) -> {candidate: cost}

where ``runners[c]`` is a zero-argument callable executing one full run
under candidate ``c`` and returning with the device idle (on the card it
ends in ``torch.cuda.synchronize``).  The tuner builds the
runners; the measurer decides how to time them.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Protocol, Sequence

from repro_torch.tune.space import Candidate


class Measurer(Protocol):
    """Pluggable timing strategy (see module docstring for the shape)."""

    def __call__(self, candidates: Sequence[Candidate],
                 runners: Mapping[Candidate, Callable[[], object]],
                 ) -> Dict[Candidate, float]:
        """Cost (lower is better) per candidate."""
        ...


class InjectedMeasurer:
    """Deterministic measurer for tests: cost = ``cost_fn(candidate)``.

    Never calls the runners and never reads a clock, so a tuning run
    under an InjectedMeasurer is a pure function of its inputs.
    """

    def __init__(self, cost_fn: Callable[[Candidate], float]):
        self.cost_fn = cost_fn
        self.calls = 0

    def __call__(self, candidates, runners=None):
        """Evaluate ``cost_fn`` on every candidate."""
        self.calls += 1
        return {c: float(self.cost_fn(c)) for c in candidates}


class WalkMeasurer:
    """Interleaved min-of-k wall-clock timing of candidate runs.

    Each candidate's runner is executed once un-timed (it builds the
    engine and its cache, and warms the kernels), then the candidates are
    timed **interleaved** —
    round r times every candidate once before round r+1 starts — so
    slow machine-wide drift (thermal, background load) hits all
    candidates equally instead of biasing whichever ran last.  The
    min over rounds estimates the noise floor.
    """

    def __init__(self, repeats: int = 3, warmup: int = 1):
        if repeats <= 0:
            raise ValueError(f"repeats must be positive, got {repeats}")
        self.repeats = int(repeats)
        self.warmup = max(int(warmup), 0)

    def __call__(self, candidates, runners):
        """Time every candidate; returns best-of-``repeats`` seconds."""
        cands = list(candidates)
        for c in cands:
            for _ in range(self.warmup):
                runners[c]()
        best = {c: float("inf") for c in cands}
        for _ in range(self.repeats):
            for c in cands:
                t0 = time.perf_counter()
                runners[c]()
                dt = time.perf_counter() - t0
                if dt < best[c]:
                    best[c] = dt
        return best
