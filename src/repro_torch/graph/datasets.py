"""Dataset registry: synthetic stand-ins for the paper's graphs (Table II).

The six real-world graphs (WG/CP/AS/LJ/AB/UK) are replaced by RMAT graphs
of the same category of degree skew (Graph500 initiator) and matched
average degree; ``scale`` sizes them (2**scale vertices).  Directed RMAT
graphs keep zero-out-degree vertices, the dangling ends that make walks
terminate early.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.graph.alias import build_alias_tables
from repro_torch.graph.csr import CSRGraph, build_csr, resolve_device
from repro_torch.graph.generators import GRAPH500, rmat_edges


@dataclass(frozen=True)
class GraphSpec:
    name: str
    num_vertices: int          # full-size |V| (paper Table II)
    num_edges: int             # full-size |E|
    category: str
    # Synthetic stand-in parameters (scaled):
    rmat_scale: int
    rmat_edge_factor: int
    initiator: tuple = GRAPH500
    undirected: bool = False


DATASET_SPECS = {
    "WG": GraphSpec("web-Google", 916_428, 5_105_039, "web", 14, 6),
    "CP": GraphSpec("cit-Patents", 3_774_768, 16_518_948, "citation", 15, 4),
    "AS": GraphSpec("as-Skitter", 1_696_415, 22_190_596, "network", 14, 13,
                    undirected=True),
    "LJ": GraphSpec("soc-LiveJournal", 4_847_571, 68_993_773, "social", 15, 14,
                    undirected=True),
    "AB": GraphSpec("arabic-2005", 22_744_080, 639_999_458, "web", 16, 28),
    "UK": GraphSpec("uk-2005", 39_459_925, 936_364_282, "web", 16, 24),
}


def make_dataset(
    name: str,
    weighted: bool = False,
    with_alias: bool = False,
    num_edge_types: int = 0,
    seed: int = 0,
    scale_override: Optional[int] = None,
    device=None,
) -> CSRGraph:
    """Build the synthetic stand-in CSR graph for a paper dataset key on
    ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    spec = DATASET_SPECS[name]
    scale = spec.rmat_scale if scale_override is None else scale_override
    edges, n = rmat_edges(scale, spec.rmat_edge_factor, spec.initiator,
                          seed=seed, undirected=spec.undirected)
    rng = np.random.default_rng(seed + 1)
    weights = None
    if weighted:
        # ThunderRW-style weights: uniform (0, 1].
        weights = rng.random(edges.shape[0]).astype(np.float32) + 1e-3
    edge_types = None
    if num_edge_types > 0:
        edge_types = rng.integers(0, num_edge_types,
                                  size=edges.shape[0]).astype(np.int32)
    g = build_csr(edges, n, weights=weights, edge_types=edge_types,
                  num_edge_types=num_edge_types, device=device)
    if with_alias:
        g = build_alias_tables(g)
    return g


def make_cora_like(seed: int = 0, device=None
                   ) -> tuple[CSRGraph, np.ndarray, np.ndarray]:
    """Cora-shaped citation graph for GNN ``full_graph_sm``: 2708 nodes,
    10556 directed edges, 1433-dim features, 7 classes; the reference's
    graph, features and labels for a seed.  The graph is on ``device``
    (default ``"cuda"``); features and labels are numpy."""
    n, e, d, c = 2708, 10556, 1433, 7
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    g = build_csr(edges, n, device=device)
    feats = (rng.random((n, d)) < 0.01).astype(np.float32)  # bag-of-words
    labels = rng.integers(0, c, n).astype(np.int32)
    return g, feats, labels
