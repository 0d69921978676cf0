"""Declarative walk programs (the algorithm half of the walker API).

A :class:`WalkProgram` — sampler + termination + hop budget — carries no
machine knobs (those live in :class:`repro_torch.walker.ExecutionConfig`),
so one program runs bit-identically under any execution configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.samplers import SamplerSpec


@dataclasses.dataclass(frozen=True)
class WalkProgram:
    """One graph-random-walk algorithm, decoupled from the machine.

    Attributes:
      spec:      the sampling module configuration (paper Table I).
      max_hops:  hop budget per query (paper §VIII-A4: 80).
      name:      optional label for logs / benchmark rows.
    """

    spec: SamplerSpec = SamplerSpec(kind="uniform")
    max_hops: int = 80
    name: str = ""

    def __post_init__(self):
        # Sampler-level constraints are validated by SamplerSpec itself;
        # only the program-level hop budget is checked here.
        if self.max_hops <= 0:
            raise ValueError(
                f"WalkProgram.max_hops must be positive, got {self.max_hops}; "
                "a walk needs at least one hop of budget")

    @staticmethod
    def urw(max_hops: int = 80) -> "WalkProgram":
        """Unbiased random walk: uniform neighbor sampling."""
        return WalkProgram(SamplerSpec(kind="uniform"), max_hops, "urw")

    @staticmethod
    def ppr(alpha: float = 0.15, max_hops: int = 80) -> "WalkProgram":
        """Personalized PageRank walks: geometric termination with teleport
        probability α; endpoints estimate PPR mass."""
        return WalkProgram(SamplerSpec(kind="uniform", stop_prob=alpha),
                           max_hops, "ppr")

    @staticmethod
    def deepwalk(max_hops: int = 80) -> "WalkProgram":
        """DeepWalk: Walker alias sampling over weighted neighbor lists.
        The graph must carry alias tables."""
        return WalkProgram(SamplerSpec(kind="alias"), max_hops, "deepwalk")

    @staticmethod
    def node2vec(p: float = 2.0, q: float = 0.5, max_hops: int = 80,
                 weighted: bool = False,
                 rejection_rounds: int = 12) -> "WalkProgram":
        """Node2Vec: bounded-round rejection sampling (unweighted) or
        Efraimidis–Spirakis reservoir sampling (weighted), paper
        Table I."""
        kind = "reservoir_n2v" if weighted else "rejection_n2v"
        return WalkProgram(
            SamplerSpec(kind=kind, p=p, q=q,
                        rejection_rounds=rejection_rounds),
            max_hops, "node2vec_w" if weighted else "node2vec")

    @staticmethod
    def metapath(schedule: Sequence[int], max_hops: int = 80) -> "WalkProgram":
        """MetaPath walks: hop t samples uniformly among neighbors of edge
        type schedule[t mod len]; no match → early termination."""
        return WalkProgram(
            SamplerSpec(kind="metapath",
                        metapath=tuple(int(t) for t in schedule)),
            max_hops, "metapath")

    @property
    def second_order(self) -> bool:
        """Whether sampling conditions on ``v_prev`` (Node2Vec family)."""
        return self.spec.second_order

    def requires(self, graph) -> None:
        """Validate that ``graph`` carries the payloads this program samples
        from; raises ValueError with an actionable message otherwise."""
        if self.spec.kind == "alias" and not graph.has_alias:
            raise ValueError(
                "alias (DeepWalk) programs need alias tables on the graph — "
                "build it with with_alias=True / graph.build_alias_tables")
        if self.spec.kind == "metapath" and not graph.typed:
            raise ValueError(
                "metapath programs need a typed graph (num_edge_types > 0)")
        if self.spec.kind == "metapath" and max(
                self.spec.metapath) >= graph.num_edge_types:
            raise ValueError(
                f"metapath schedule {self.spec.metapath} names an edge type "
                f"the graph lacks (it has {graph.num_edge_types})")
