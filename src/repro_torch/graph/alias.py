"""Walker alias-table construction for weighted neighbor lists.

Built on the host (numpy) as a preprocessing step, then placed on the
graph's device.  Sampling (one uniform for the column, one for the accept
test) lives in the walk-step kernel and the ``alias_accept`` executor.
The algorithm is the reference's, step for step, so the tables are equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph


def _vose(prob_seg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose's alias construction for one neighbor list. O(d)."""
    d = prob_seg.size
    scaled = prob_seg * d / prob_seg.sum()
    prob = np.ones(d, dtype=np.float32)
    alias = np.arange(d, dtype=np.int32)
    small = [i for i in range(d) if scaled[i] < 1.0]
    large = [i for i in range(d) if scaled[i] >= 1.0]
    scaled = scaled.astype(np.float64)
    while small and large:
        s = small.pop()
        l = large.pop()  # noqa: E741 — Vose's (small, large) names
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] + scaled[s] - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large:
        prob[i] = 1.0
    for i in small:  # numerical leftovers
        prob[i] = 1.0
    return prob, alias


def build_alias_tables(g: CSRGraph) -> CSRGraph:
    """Attach per-neighbor-list alias tables to a CSR graph.

    An unweighted graph gets identity tables (prob=1, alias=i), so alias
    sampling degenerates to uniform.
    """
    rp = g.row_ptr.cpu().numpy()
    E = g.num_edges
    prob = np.ones(E, dtype=np.float32)
    alias = np.zeros(E, dtype=np.int32)
    if g.weights is not None:
        w = g.weights.cpu().numpy().astype(np.float64)
        for v in range(g.num_vertices):
            s, e = int(rp[v]), int(rp[v + 1])
            if e - s <= 1:
                if e - s == 1:
                    prob[s], alias[s] = 1.0, 0
                continue
            p, a = _vose(w[s:e])
            prob[s:e] = p
            alias[s:e] = a
    else:
        deg = np.diff(rp)
        alias = (np.arange(E, dtype=np.int64)
                 - np.repeat(rp[:-1], deg)).astype(np.int32)
    return dataclasses.replace(
        g, alias_prob=torch.from_numpy(prob).to(g.device),
        alias_idx=torch.from_numpy(alias).to(g.device))
