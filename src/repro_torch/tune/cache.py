"""Persistent tuning cache keyed by (graph signature, sampler, machine).

Tuned knob choices are a function of *(graph, sampler, machine,
workload)* — not constants — so the cache key folds in:

  * the **graph signature**: n, m, max degree, payload flags, and two
    degree-quantile ladders (plain and degree-weighted; the weighted
    ladder is what predicts the live-lane max degree of a W-lane pool,
    see `repro_torch.tune.model.live_max_degree`);
  * the **sampler kind** (each kind has its own loads and bytes/hop
    profile);
  * the **machine axes**: backend, ``step_impl``, the graph's device
    (the card's name, or ``cpu``), and an interpret flag kept at 0 so
    keys keep the reference package's shape (the port has no
    interpreter);
  * the **workload bucket**: a power-of-two bucket of the closed-batch
    query count (the optimal lane-pool width depends on how much work
    is offered; bucketing bounds distinct entries).

The store is a flat JSON file (schema version 1, the reference
package's) so tuned configs can be committed and reused
(`python -m repro_torch.tune` writes one; ``RIDGEWALKER_TUNE_CACHE``
points the bind-time resolver at it).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

# Quantile ladders stored in the signature.  The weighted ladder is
# denser near 1.0 because live-lane-max prediction interpolates at
# q = 0.5**(1/W), which approaches 1.0 as the lane pool widens.
PLAIN_QS: Tuple[float, ...] = (0.05, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)
WEIGHTED_QS: Tuple[float, ...] = (0.5, 0.75, 0.9, 0.95, 0.975, 0.99,
                                  0.999, 1.0)

_ENV_CACHE = "RIDGEWALKER_TUNE_CACHE"
_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class GraphSignature:
    """Degree-skew fingerprint of a graph (the tuning-relevant shape).

    Two graphs with the same signature get the same tuned knobs: the
    cost model only reads sizes and the degree distribution, never the
    adjacency itself.
    """

    num_vertices: int
    num_edges: int
    max_degree: int
    weighted: bool
    typed: bool
    deg_q: Tuple[int, ...]    # plain degree quantiles at PLAIN_QS
    deg_wq: Tuple[int, ...]   # degree-weighted quantiles at WEIGHTED_QS

    def token(self) -> str:
        """Stable string form used inside cache keys."""
        q = ".".join(str(v) for v in self.deg_q)
        wq = ".".join(str(v) for v in self.deg_wq)
        return (f"n{self.num_vertices}-m{self.num_edges}"
                f"-dmax{self.max_degree}"
                f"-w{int(self.weighted)}-t{int(self.typed)}"
                f"-q{q}-wq{wq}")


def _degree_quantile(sorted_deg: np.ndarray, q: float) -> int:
    """Plain quantile of the (sorted ascending) degree array."""
    i = min(int(q * (sorted_deg.size - 1) + 0.5), sorted_deg.size - 1)
    return int(sorted_deg[i])


def _weighted_quantile(sorted_deg: np.ndarray, cum: np.ndarray,
                       q: float) -> int:
    """Degree-weighted quantile: the degree d such that a fraction ``q``
    of *edge endpoints* live at vertices of degree <= d.  This is the
    distribution a uniformly random walk actually visits (walks land on
    vertices proportionally to degree), hence the predictor for the max
    degree among W live lanes."""
    i = int(np.searchsorted(cum, q * cum[-1]))
    return int(sorted_deg[min(i, sorted_deg.size - 1)])


def graph_signature(graph) -> GraphSignature:
    """Fingerprint a `CSRGraph` or `PartitionedGraph` on either device
    for the cache (host numpy work over one copy of its row pointers)."""
    groups = getattr(graph, "groups", None)
    arrays = groups[0] if groups else graph
    if groups:                  # PartitionedGraph: per-shard row pointers
        row_ptr = np.concatenate([x.row_ptr.cpu().numpy() for x in groups])
    else:
        row_ptr = graph.row_ptr.cpu().numpy()
    row_ptr = row_ptr.astype(np.int64)
    if row_ptr.ndim == 2:
        deg = np.diff(row_ptr, axis=1).reshape(-1)
    else:
        deg = np.diff(row_ptr)
    if deg.size == 0:
        deg = np.zeros((1,), np.int64)
    sd = np.sort(deg)
    cum = np.cumsum(sd)
    if cum[-1] == 0:
        cum = cum + 1  # degenerate edgeless graph: keep searchsorted sane
    return GraphSignature(
        num_vertices=int(getattr(graph, "num_vertices", deg.size)),
        num_edges=int(getattr(graph, "num_edges", int(deg.sum()))),
        max_degree=int(getattr(graph, "max_degree", int(sd[-1]))),
        weighted=getattr(arrays, "weights", None) is not None,
        typed=getattr(graph, "edge_type", None) is not None,
        deg_q=tuple(_degree_quantile(sd, q) for q in PLAIN_QS),
        deg_wq=tuple(_weighted_quantile(sd, cum, q) for q in WEIGHTED_QS),
    )


def workload_bucket(num_queries: Optional[int]) -> int:
    """Power-of-two bucket (>= 64) of a closed-batch query count; 0 when
    the workload size is unknown (stream/serve resolution)."""
    if not num_queries or num_queries <= 0:
        return 0
    b = 64
    while b < num_queries:
        b <<= 1
    return b


def cache_key(sig: GraphSignature, kind: str, backend: str, step_impl: str,
              device_kind: str, interpret: bool,
              num_queries: Optional[int] = None) -> str:
    """The full lookup key: sampler x machine x workload x graph."""
    return (f"{kind}|{backend}|{step_impl}|{device_kind}"
            f"|interp{int(bool(interpret))}"
            f"|q{workload_bucket(num_queries)}|{sig.token()}")


def default_cache_path() -> Optional[str]:
    """Cache file named by ``RIDGEWALKER_TUNE_CACHE`` (None: in-memory)."""
    p = os.environ.get(_ENV_CACHE, "").strip()
    return p or None


class TuningCache:
    """JSON-backed map: cache key -> {"knobs": {...}, "meta": {...}}.

    ``path=None`` gives a process-local in-memory cache (resolution
    still dedupes work within one process, nothing is persisted).
    A missing or unreadable file is treated as empty — a stale or
    corrupt committed cache must never break compilation.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[str, dict] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                if (isinstance(data, dict)
                        and data.get("version") == _SCHEMA_VERSION
                        and isinstance(data.get("entries"), dict)):
                    self._entries = dict(data["entries"])
            except (OSError, ValueError):
                self._entries = {}

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[dict]:
        """The stored ``{"knobs": ..., "meta": ...}`` record, or None."""
        rec = self._entries.get(key)
        if not isinstance(rec, dict) or "knobs" not in rec:
            return None
        return rec

    def put(self, key: str, knobs: dict, meta: Optional[dict] = None) -> None:
        """Store a tuned knob assignment (JSON-serializable values only)."""
        self._entries[key] = {"knobs": dict(knobs), "meta": dict(meta or {})}

    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Write the cache to ``path`` (or the construction path)."""
        p = path or self.path
        if not p:
            return None
        with open(p, "w") as f:
            json.dump({"version": _SCHEMA_VERSION, "entries": self._entries},
                      f, indent=2, sort_keys=True)
            f.write("\n")
        return p
