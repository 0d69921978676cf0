"""Deterministic synthetic data pipelines, the reference's
``repro.data.pipeline``.

Every pipeline is a stateless numpy function of (seed, step) that
returns the reference's arrays bit for bit, so a restart resumes
bit-identically (the data state is just an integer).  The reference's
``shard_batch`` (placement under a JAX sharding) is :func:`to_device`:
the same tree of tensors on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import tree_map


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def lm_batch(cfg: TokenPipelineConfig, step: int):
    """Synthetic Zipf-ish token batch: (tokens, labels) (B, S) int32."""
    rng = np.random.default_rng((cfg.seed, step))
    z = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = ((z - 1) % cfg.vocab).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def lm_batches(cfg: TokenPipelineConfig, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield lm_batch(cfg, step)
        step += 1


def to_device(batch, device=None):
    """A host batch (a dict, list or tuple of numpy arrays) as the same
    tree of tensors on ``device``, copied."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    batch)


def gnn_batch(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0,
              d_edge: int = 0, n_classes: int = 7, out_dim: int = 3):
    rng = np.random.default_rng(seed)
    b = dict(
        node_feats=rng.random((n_nodes, d_feat), np.float32),
        edge_index=np.stack([rng.integers(0, n_nodes, n_edges),
                             rng.integers(0, n_nodes, n_edges)]).astype(np.int32),
        labels=rng.integers(0, n_classes, n_nodes).astype(np.int32),
        targets=rng.random((n_nodes, out_dim), np.float32),
    )
    if d_edge:
        b["edge_feats"] = rng.random((n_edges, d_edge), np.float32)
    return b


def molecule_batch(n_atoms: int, n_edges: int, n_mols: int, seed: int = 0):
    """Batched small molecules: one padded disjoint-union graph."""
    rng = np.random.default_rng(seed)
    N = n_atoms * n_mols
    src = np.concatenate([rng.integers(0, n_atoms, n_edges) + m * n_atoms
                          for m in range(n_mols)])
    dst = np.concatenate([rng.integers(0, n_atoms, n_edges) + m * n_atoms
                          for m in range(n_mols)])
    return dict(
        species=rng.integers(0, 20, N).astype(np.int32),
        positions=(rng.random((N, 3), np.float32) * 4.0),
        edge_index=np.stack([src, dst]).astype(np.int32),
        mol_id=np.repeat(np.arange(n_mols), n_atoms).astype(np.int32),
        energies=rng.random(n_mols).astype(np.float32),
    )


def recsys_batch(batch: int, n_dense: int, n_sparse: int, vocab_sizes,
                 seed: int = 0):
    rng = np.random.default_rng(seed)
    sparse = np.stack([rng.integers(0, v, batch) for v in vocab_sizes],
                      axis=1).astype(np.int32)
    return dict(
        dense=rng.random((batch, n_dense), np.float32),
        sparse=sparse,
        labels=rng.integers(0, 2, batch).astype(np.int32),
    )
