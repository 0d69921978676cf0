"""Sampler definitions and their shared arithmetic.

:class:`SamplerSpec` is the host-programmable configuration of the
sampling module (p, q, α, mode bits).  A spec lowers into a phase program
(`repro_torch.core.phase_program`) that the engine executes.

| GRW            | weighted | sampler            |
|----------------|----------|--------------------|
| URW, PPR       | no       | uniform            |
| DeepWalk       | yes      | alias (Walker)     |
| Node2Vec       | no       | rejection          |
| Node2Vec       | yes      | reservoir (E-S)    |
| MetaPath       | either   | typed uniform      |

Every kind validates and lowers; the uniform, alias and metapath kinds
execute (the Node2Vec kinds raise in ``make_sampler`` until their
executors are ported).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Sampler kinds with a phase-program lowering (`phase_program.lower`).
KINDS = ("uniform", "alias", "rejection_n2v", "reservoir_n2v", "metapath")


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Static configuration of the sampling module.

    Validation happens at construction: a malformed spec (unknown kind,
    empty MetaPath schedule, non-positive Node2Vec parameters) fails here
    with an actionable message."""

    kind: str = "uniform"   # uniform|alias|rejection_n2v|reservoir_n2v|metapath
    p: float = 1.0          # Node2Vec return parameter
    q: float = 1.0          # Node2Vec in-out parameter
    stop_prob: float = 0.0  # PPR teleport/termination probability α
    rejection_rounds: int = 12
    reservoir_chunk: int = 64
    adaptive_chunks: "bool | str" = "auto"
    metapath: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown sampler kind: {self.kind!r} (one of {KINDS})")
        if not isinstance(self.metapath, tuple):
            # Specs stay hashable (lowering is cached on the frozen spec).
            object.__setattr__(self, "metapath",
                               tuple(int(t) for t in self.metapath))
        if self.kind == "metapath":
            if not self.metapath:
                raise ValueError(
                    "metapath samplers need a non-empty edge-type schedule "
                    "(pass metapath=(t0, t1, ...))")
            if any(int(t) < 0 for t in self.metapath):
                raise ValueError(
                    f"metapath schedule entries are edge-type ids and must "
                    f"be non-negative, got {self.metapath}")
        if not 0.0 <= self.stop_prob <= 1.0:
            raise ValueError(
                f"stop_prob must be a probability in [0, 1], got "
                f"{self.stop_prob}")
        if self.second_order and (self.p <= 0 or self.q <= 0):
            raise ValueError(
                f"Node2Vec parameters must be positive, got p={self.p} "
                f"q={self.q}")
        if self.rejection_rounds <= 0:
            raise ValueError(
                f"rejection_rounds must be positive, got "
                f"{self.rejection_rounds}")
        if self.reservoir_chunk <= 0:
            raise ValueError(
                f"reservoir_chunk must be positive, got "
                f"{self.reservoir_chunk}")
        if self.adaptive_chunks not in (True, False, "auto"):
            raise ValueError(
                f"adaptive_chunks must be True, False, or 'auto', got "
                f"{self.adaptive_chunks!r}")

    @property
    def second_order(self) -> bool:
        return self.kind in ("rejection_n2v", "reservoir_n2v")


def _uniform_index(deg: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """index = min(floor(u * deg), deg-1) in float32; safe for deg == 0."""
    idx = torch.floor(u * deg.to(u.dtype)).to(torch.int32)
    return torch.minimum(torch.clamp(idx, min=0), torch.clamp(deg - 1, min=0))
