"""Skip-gram with negative sampling (the DeepWalk/node2vec embedding
trainer).

The walk engine generates the corpus, a window over each walk gives
(center, context) pairs, and this model learns the vertex embeddings.
Two consumption paths exist:

* the host path (:func:`pairs_from_walks` + batching by the caller), for
  offline corpus processing;
* the device-resident path: `repro_torch.core.corpus_ring` samples
  (center, context, negatives) windows straight from the ring on the
  device and :func:`make_sgns_step` consumes them, its three row gathers
  on the embedding-bag kernel and their backward on the segment-sum
  kernel.  ``Walker.train_embeddings`` composes the two ends.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import gather_rows, tree_from_reference
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class SkipGramConfig:
    num_vertices: int
    dim: int = 128
    num_negatives: int = 5
    window: int = 5


def init_params(generator: torch.Generator, cfg: SkipGramConfig,
                device=None) -> dict:
    """Embedding tables drawn from ``generator`` (on its device) and moved
    to ``device`` (default: the generator's): ``in_embed`` uniform in
    ±1/dim, ``out_embed`` normal · 0.1 (small but not zero, so the SGNS
    gradients reach ``in_embed`` from the first step).

    The distributions are the reference's, but a ``torch.Generator``
    cannot give ``jax.random``'s numbers: to start both packages from the
    same tables, carry the reference's across with
    :func:`params_from_reference`.  A CPU generator gives the same tables
    whatever ``device`` is.
    """
    shape = (cfg.num_vertices, cfg.dim)
    s = 1.0 / cfg.dim
    where = generator.device
    in_embed = torch.empty(shape, dtype=torch.float32, device=where).uniform_(
        -s, s, generator=generator)
    out_embed = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=where) * 0.1
    return {"in_embed": in_embed.to(device or where),
            "out_embed": out_embed.to(device or where)}


def params_from_reference(params, device=None) -> dict:
    """The reference's embedding tables (a dict of arrays: numpy, or
    anything ``np.asarray`` takes) as the port's float32 tensors on
    ``device``, copied."""
    return {k: torch.tensor(np.array(v, dtype=np.float32), device=device)
            for k, v in params.items()}


def opt_state_from_reference(state, device=None) -> adamw.AdamWState:
    """The reference's ``AdamWState`` (step, mu, nu) as the port's; the
    moments may be any nested tree (``layers.tree_from_reference``)."""
    return adamw.AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        mu=tree_from_reference(state.mu, device),
        nu=tree_from_reference(state.nu, device))


def loss_fn(params: dict, centers, contexts, negatives,
            mask=None) -> torch.Tensor:
    """centers (B,), contexts (B,), negatives (B, K) — the SGNS objective.

    ``mask`` (B,) bool skips invalid pairs (a corpus-ring window that fell
    off its walk) without changing the batch shape; ``None`` takes the
    mean over every pair.  The three row gathers go through
    :func:`gather_rows`.
    """
    ci = gather_rows(params["in_embed"], centers)     # (B, D)
    co = gather_rows(params["out_embed"], contexts)   # (B, D)
    no = gather_rows(params["out_embed"], negatives)  # (B, K, D)
    pos = torch.sum(ci * co, dim=-1)
    # An elementwise product and a sum, not a batched matmul: the same
    # reduction order on every device and no TF32.
    neg = torch.sum(ci[:, None, :] * no, dim=-1)
    per_pair = F.logsigmoid(pos) + torch.sum(F.logsigmoid(-neg), dim=-1)
    if mask is None:
        return -torch.mean(per_pair)
    w = mask.to(per_pair.dtype)
    return -torch.sum(per_pair * w) / torch.clamp(torch.sum(w), min=1.0)


def make_sgns_step(cfg: SkipGramConfig, opt_cfg: adamw.AdamWConfig):
    """Build the SGNS grad step.

    ``step(params, opt_state, batch) -> (params, opt_state, aux)`` where
    ``batch = (centers, contexts, negatives, mask)``.  The tables and the
    optimizer moments are updated in place (`adamw.apply_updates`), so they
    never leave the device and no step holds a second copy; ``aux`` holds
    device scalars (loss, grad_norm, lr), read only if the caller asks.
    """
    keys = ("in_embed", "out_embed")   # sorted: the reference's leaf order

    def step(params, opt_state, batch):
        centers, contexts, negatives, mask = batch
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        with torch.enable_grad():
            loss = loss_fn(leaves, centers, contexts, negatives, mask=mask)
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        params, opt_state, stats = adamw.apply_updates(
            params, dict(zip(keys, grads)), opt_state, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), **stats}

    return step


def pairs_from_walks(paths: np.ndarray, lengths: np.ndarray, window: int,
                     rng: np.random.Generator, max_pairs: int | None = None):
    """Sliding-window (center, context) pairs from walk paths (host-side)."""
    centers, contexts = [], []
    for q in range(paths.shape[0]):
        L = int(lengths[q])
        for i in range(L):
            lo, hi = max(0, i - window), min(L, i + window + 1)
            for j in range(lo, hi):
                if j != i and paths[q, j] >= 0 and paths[q, i] >= 0:
                    centers.append(paths[q, i])
                    contexts.append(paths[q, j])
    c = np.asarray(centers, np.int32)
    x = np.asarray(contexts, np.int32)
    if max_pairs is not None and c.size > max_pairs:
        sel = rng.choice(c.size, max_pairs, replace=False)
        c, x = c[sel], x[sel]
    return c, x
