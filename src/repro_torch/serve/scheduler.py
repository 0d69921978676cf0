"""Online chunk-size adaptation for the walk service (Theorem VI.1).

The service's ``chunk`` — supersteps run per ``stream.advance`` call — is
the open-system injection delay C of paper §VI-A: while the device runs a
chunk, the host cannot admit arrivals or release finished slots, so
Theorem VI.1's required stage-ahead depth D = W + ceil(mu·C·W) grows
linearly with it.  Too large a chunk starves lanes (arrivals wait at the
host while lanes idle); too small a chunk drowns the run in host<->device
synchronizations.  The right value depends on load, so
:class:`HopsController` closes the loop online, with the same
queuing-theory discipline as the engine's stage-ahead watermark:

  * observe the engine's occupancy stats over the last window
    (starved-lane ratio = lanes idle *while work existed* — the direct
    Theorem VI.1 violation signal — plus the bubble ratio);
  * **shrink** (halve) the chunk when starvation exceeds the high
    watermark — smaller C restores D <= capacity;
  * **grow** (double) only after ``patience`` consecutive healthy windows
    below the low watermark — fewer host syncs per superstep;
  * clamp to ``[min_chunk, max_chunk]`` always.

The two watermarks plus the patience streak give bounded hysteresis: a
load level sitting between the watermarks never toggles the chunk, and a
single noisy window never triggers growth.  Every decision is recorded as
an :class:`AdaptationEvent`; `WalkService.analyze` exposes the trace on
``ServiceAnalysis.adaptation``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AdaptationEvent:
    """One controller decision (also recorded for unchanged windows where
    a decision was *considered*, i.e. a watermark was crossed)."""

    clock: int            # service superstep clock at the decision
    chunk_before: int
    chunk_after: int
    starved_ratio: float  # over the observation window
    bubble_ratio: float
    reason: str           # "shrink" | "grow" | "hold"


@dataclasses.dataclass
class HopsController:
    """Bounded-hysteresis supersteps-per-launch controller.

    Attributes:
      min_chunk / max_chunk: hard bounds on the adapted chunk.
      low_water:  starved ratio below which a window counts as healthy
                  (growth requires ``patience`` such windows in a row).
      high_water: starved ratio above which the chunk shrinks now.
      patience:   consecutive healthy windows required before growing.
    """

    min_chunk: int = 1
    max_chunk: int = 256
    low_water: float = 0.02
    high_water: float = 0.15
    patience: int = 2
    _healthy_streak: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self):
        if not 0 < self.min_chunk <= self.max_chunk:
            raise ValueError(
                f"need 0 < min_chunk <= max_chunk, got "
                f"{self.min_chunk}/{self.max_chunk}")
        if not 0.0 <= self.low_water < self.high_water:
            raise ValueError(
                f"need 0 <= low_water < high_water, got "
                f"{self.low_water}/{self.high_water}")
        if self.patience <= 0:
            raise ValueError(f"patience must be positive, got "
                             f"{self.patience}")

    def clamp(self, chunk: int) -> int:
        """``chunk`` clipped into the controller's bounds."""
        return max(self.min_chunk, min(self.max_chunk, int(chunk)))

    def propose(self, chunk: int, starved_ratio: float,
                bubble_ratio: float, clock: int = 0,
                ) -> Tuple[int, Optional[AdaptationEvent]]:
        """Next chunk given the last window's occupancy stats.

        Returns ``(new_chunk, event)`` — ``event`` is None when neither
        watermark was crossed (steady state, nothing recorded).
        """
        chunk = self.clamp(chunk)
        if starved_ratio > self.high_water:
            self._healthy_streak = 0
            new = self.clamp(chunk // 2)
            return new, AdaptationEvent(
                clock, chunk, new, starved_ratio, bubble_ratio,
                "shrink" if new != chunk else "hold")
        if starved_ratio < self.low_water:
            self._healthy_streak += 1
            if self._healthy_streak >= self.patience:
                self._healthy_streak = 0
                new = self.clamp(chunk * 2)
                if new != chunk:
                    return new, AdaptationEvent(
                        clock, chunk, new, starved_ratio, bubble_ratio,
                        "grow")
            return chunk, None
        self._healthy_streak = 0
        return chunk, None
