"""Architecture registry scaffolding (the reference's, unchanged).

Each ``configs/<id>.py`` exposes:
  FAMILY — "lm" | "gnn" | "recsys"
  FULL   — the exact published configuration (dry-run only; never allocated)
  SMOKE  — a reduced same-family configuration for CPU smoke tests
  SHAPES — the arch's own input-shape set (name -> shape dict)

Shape-cell semantics (assignment):
  LM:   train_* lowers train_step; prefill_* lowers serve_prefill;
        decode_* / long_* lower serve_step (1 new token vs a seq_len cache).
  GNN:  all shapes lower train_step on the given graph shape.
  recsys: train_batch lowers train_step; serve_* lower predict;
        retrieval_cand lowers retrieval scoring.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str              # train | prefill | decode | serve | retrieval
    dims: Dict[str, Any]


LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train",
                          dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeCell("prefill_32k", "prefill",
                             dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeCell("decode_32k", "decode",
                            dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeCell("long_500k", "decode",
                           dict(seq_len=524288, global_batch=1)),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeCell("full_graph_sm", "train",
                               dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    "minibatch_lg": ShapeCell("minibatch_lg", "train",
                              dict(n_nodes=232_965, n_edges=114_615_892,
                                   batch_nodes=1024, fanout=(15, 10))),
    "ogb_products": ShapeCell("ogb_products", "train",
                              dict(n_nodes=2_449_029, n_edges=61_859_140,
                                   d_feat=100)),
    "molecule": ShapeCell("molecule", "train",
                          dict(n_nodes=30, n_edges=64, batch=128)),
}

RECSYS_SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", dict(batch=65_536)),
    "serve_p99": ShapeCell("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeCell("serve_bulk", "serve", dict(batch=262_144)),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}
