"""Fanout neighbor sampler for GNN minibatch training (``minibatch_lg``),
the reference's ``repro.graph.sampling_service``.

GraphSAGE-style k-hop sampling with replacement, built on the walk
engine's stateless draws: the sample for (node, hop, slot) is a pure
function of (seed, node, hop, slot), so sampling is deterministic,
restartable and shardable — one-hop fanout sampling *is* a
width-``fanout`` bundle of one-step random walks.

Produces fixed-shape padded blocks: per layer an edge list
(2, n_src·fanout) where sampled duplicates are real (with-replacement
semantics, standard GraphSAGE) and zero-degree sources self-loop.

The draws are ``core/rng.py::task_uniforms`` under ``stream_key(seed)``
(the reference's ``jax.random.PRNGKey(seed)``) with the reference's salt,
3, which is ``SALT_CORPUS``'s value: the sampler shares the corpus
channel, as the reference's does, so its blocks are bit-equal to the
reference's.  A corpus draw and a sampler draw coincide wherever they
share (seed, id, hop).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import rng as task_rng
from repro_torch.graph.csr import CSRGraph, row_access


class SampledBlock(NamedTuple):
    """One message-passing layer's sampled bipartite block."""
    edge_index: torch.Tensor   # (2, E) int32 [src_global, dst_global]
    num_src: int
    num_dst: int


def sample_neighbors(graph: CSRGraph, nodes: torch.Tensor, fanout: int,
                     base_key, hop: int) -> torch.Tensor:
    """(n,) nodes -> (n, fanout) sampled neighbor ids (self-loop if deg=0)."""
    addr, deg = row_access(graph, nodes)
    u = task_rng.task_uniforms(base_key, nodes, torch.full_like(nodes, hop),
                               fanout, salt=task_rng.SALT_CORPUS)
    idx = torch.minimum((u * deg[:, None]).to(torch.int32),
                        torch.clamp(deg - 1, min=0)[:, None])
    e = torch.clamp(addr[:, None] + idx, 0, max(graph.num_edges - 1, 0))
    nbrs = graph.col[e.long()]
    return torch.where(deg[:, None] > 0, nbrs, nodes[:, None])


def sample_blocks(graph: CSRGraph, seeds, fanouts: Sequence[int],
                  seed: int = 0) -> Tuple[list, torch.Tensor]:
    """k-hop fanout sampling. Returns (blocks outer-to-inner, all_nodes).

    blocks[i].edge_index holds (neighbor -> frontier) edges for hop i;
    message passing runs inner-to-outer (reverse order).  ``seeds`` (any
    int array) are put on the graph's device.
    """
    base_key = task_rng.stream_key(seed)
    frontier = torch.as_tensor(seeds, device=graph.device).to(torch.int32)
    blocks = []
    all_nodes = [frontier]
    for h, f in enumerate(fanouts):
        nbrs = sample_neighbors(graph, frontier, f, base_key, h)  # (n, f)
        src = nbrs.reshape(-1)
        dst = torch.repeat_interleave(frontier, f)
        blocks.append(SampledBlock(
            edge_index=torch.stack([src, dst]),
            num_src=int(src.shape[0]),
            num_dst=int(frontier.shape[0])))
        frontier = src
        all_nodes.append(frontier)
    return blocks, torch.cat(all_nodes)


def block_union_graph(blocks) -> torch.Tensor:
    """Concatenate all block edges into one (2, ΣE) edge list (the padded
    union graph the dry-run cells lower)."""
    return torch.cat([b.edge_index for b in blocks], dim=1)
