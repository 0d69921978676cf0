"""Synthetic graph generators (RMAT, balanced and Graph500 initiators).

Deterministic given a seed; numpy edge arrays for ``build_csr``.  The RMAT
generator draws each of the ``scale`` address bits of (src, dst) for all
edges at once.
"""
from __future__ import annotations

import numpy as np

# RMAT initiator matrices: balanced and Graph500.
BALANCED = (0.25, 0.25, 0.25, 0.25)
GRAPH500 = (0.57, 0.19, 0.19, 0.05)


def rmat_edges(
    scale: int,
    edge_factor: int,
    initiator=GRAPH500,
    seed: int = 0,
    undirected: bool = False,
) -> tuple[np.ndarray, int]:
    """Generate RMAT edges. Returns (edges (E,2) int64, num_vertices)."""
    a, b, c, d = initiator
    if abs(a + b + c + d - 1.0) >= 1e-6:
        raise ValueError(f"RMAT initiator must sum to 1, got {initiator}")
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(m)
        # Quadrant choice: P(src_bit=0,dst_bit=0)=a, (0,1)=b, (1,0)=c, (1,1)=d
        src_bit = (r >= a + b).astype(np.int64)
        dst_bit = ((r >= a) & (r < a + b) | (r >= a + b + c)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    edges = np.stack([src, dst], axis=1)
    if undirected:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    return edges, n


def erdos_renyi_edges(num_vertices: int, num_edges: int,
                      seed: int = 0) -> np.ndarray:
    """Uniform random directed edges, (E, 2) int64."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, size=num_edges)
    dst = rng.integers(0, num_vertices, size=num_edges)
    return np.stack([src, dst], axis=1).astype(np.int64)


def power_law_edges(num_vertices: int, num_edges: int, alpha: float = 1.5,
                    seed: int = 0) -> np.ndarray:
    """Directed power-law graph: Zipf-distributed destinations (hubs),
    uniform sources; (E, 2) int64."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(alpha, size=num_edges)
    dst = (ranks - 1) % num_vertices
    src = rng.integers(0, num_vertices, size=num_edges)
    return np.stack([src, dst], axis=1).astype(np.int64)


def dangling_fraction(edges: np.ndarray, num_vertices: int) -> float:
    """Fraction of vertices with no outgoing edge (where walks end early)."""
    deg = np.bincount(edges[:, 0], minlength=num_vertices)
    return float((deg == 0).mean())
