"""Decoder-only LM (dense + MoE) with GQA, RoPE and KV-cache serving
paths, the reference's ``repro.models.transformer``.

Covers the five LM architectures (phi3.5-moe, granite-moe, deepseek-7b,
minitron-8b, stablelm-12b).  Layers are stacked on a leading axis, as
the reference's ``jax.vmap(init)`` lays them out, and run one after
another (``layers.tree_unstack``) where the reference scans them.

Entry points:
  * ``train_loss(params, tokens, labels, cfg)``      — training objective
  * ``prefill(params, tokens, cfg)``                 — logits + KV cache
  * ``decode_step(params, token, cache, len, cfg)``  — one serving step

Differences from the reference, each without effect on a value:
  * ``remat`` wraps each layer of ``forward`` and of ``prefill`` in
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``) when
    autograd records: the backward recomputes the layer's activations
    instead of keeping them, which trades memory for a second forward
    and changes no value (the gradients are the same bits).  Without
    autograd (serving) it does nothing.  ``scan_layers`` changes no
    value either.  As ``jax.lax.scan`` does, the layer loop raises
    ``TypeError`` when a layer changes the dtype of its carry (bfloat16
    parameters over a float32 cache promote the residual stream), unless
    ``scan_layers=False``, whose unrolled loop the reference lets promote.
  * The sharding fields (``tp_axis``, ``dp_axes``, ``kv_sharding``,
    ``decode_cache_shard``, ``vocab_parallel_ce``'s purpose) place
    nothing on one card; :func:`param_specs` reads them for the dry-run
    (``launch.specs``), which lays ``meta`` tensors out over a mesh.
  * The token embedding of a float32 table is a row gather on the
    embedding-bag kernel; a bfloat16 table is indexed (a gather copies
    bits either way).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.checkpointer import leaves, tree_map
from repro_torch.distributed.mesh import PartitionSpec as P
from repro_torch.models import layers as L
from repro_torch.models.moe import (MoEConfig, moe_apply_batched, moe_init,
                                    moe_param_specs)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 1024
    vocab: int = 1024
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    remat: bool = True
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)
    # flash-style chunked attention kicks in at seq >= chunk_threshold
    chunk_threshold: int = 2048
    q_block: int = 1024
    kv_block: int = 1024
    scan_layers: bool = True
    # cross-entropy's gold logit as a one-hot masked sum (the reference's
    # vocab-parallel form) instead of a gather; the same value
    vocab_parallel_ce: bool = False
    kv_sharding: str = "d_head"
    # cast the float32 norm scales to the activation dtype at use
    cast_norm_scale: bool = False
    decode_cache_shard: str = "seq"

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        if self.moe:
            ff = self.moe.num_experts * 3 * d * self.moe.d_ff \
                + d * self.moe.num_experts
        else:
            ff = 3 * d * f
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        ff = self.moe.top_k * 3 * d * self.moe.d_ff
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


# ------------------------------ init --------------------------------------

def _init_layer(cfg: TransformerConfig, generator, device):
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, torch.float32, device),
        "attn": L.attention_init(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.d_head, cfg.dtype,
                                 device),
        "ln2": L.rmsnorm_init(cfg.d_model, torch.float32, device),
    }
    if cfg.moe:
        p["moe"] = moe_init(generator, cfg.d_model, cfg.moe, cfg.dtype,
                            device)
    else:
        p["ffn"] = L.ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.dtype,
                              device)
    return p


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device=None):
    """Parameters drawn from ``generator`` on its device and put on
    ``device`` (default: the generator's; ``meta`` shapes the tree without
    memory).  A full config drawn on the card needs a CUDA generator.
    Each stacked leaf is allocated once and layer ``i`` drawn into its
    row ``i``, so the peak is the weights and one layer's draws.  On
    another device than the generator's, the tree is drawn and scaled on
    the generator's device and then moved: a CUDA tensor divided by a
    Python number is multiplied by its reciprocal, which rounds otherwise
    than the CPU's division, so every device gets the same bits."""
    device = torch.device(device if device is not None else generator.device)
    if device.type != "meta" and device != generator.device:
        return tree_map(lambda x: x.to(device),
                        _draw(generator, cfg, generator.device))
    return _draw(generator, cfg, device)


def _draw(generator: torch.Generator, cfg: TransformerConfig, device):
    s = 1.0 / math.sqrt(cfg.d_model)
    embed = L.normal(generator, (cfg.vocab, cfg.d_model), cfg.dtype,
                     device).mul_(s)
    layers = tree_map(lambda a: torch.empty((cfg.n_layers, *a.shape),
                                            dtype=a.dtype, device=device),
                      _init_layer(cfg, generator, "meta"))
    if device.type != "meta":
        for i in range(cfg.n_layers):
            tree_map(lambda row, x: row.copy_(x), L.tree_index(layers, i),
                     _init_layer(cfg, generator, device))
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": L.rmsnorm_init(cfg.d_model, torch.float32, device),
        "lm_head": L.normal(generator, (cfg.d_model, cfg.vocab), cfg.dtype,
                            device).mul_(s),
    }


def param_specs(cfg: TransformerConfig):
    """Each leaf's :class:`PartitionSpec` over a ``(data, model)`` mesh,
    the reference's rules line for line: heads (or ``d_head`` where 16
    does not divide them) and the FFN's hidden dimension over
    ``cfg.tp_axis``, the vocabulary (or ``d_model``) of the embedding and
    the head over it, the rest replicated.  The port's tree is the
    reference's: the same keys, the layers stacked on a leading axis as
    ``jax.vmap(init)`` stacks them, so every spec addresses the same leaf
    (the stacked leaves' leading ``None``)."""
    tp = cfg.tp_axis
    heads_div = cfg.n_heads % 16 == 0  # conservative: divisible by max TP
    hq = P(None, None, tp, None) if heads_div else P(None, None, None, tp)
    if cfg.kv_sharding == "heads":
        hkv = P(None, None, tp, None)
    elif cfg.kv_sharding == "replicate":
        hkv = P(None, None, None, None)
    else:  # baseline: shard d_head
        hkv = P(None, None, None, tp)
    attn = {"wq": hq, "wk": hkv, "wv": hkv,
            "wo": P(None, tp, None, None) if heads_div
            else P(None, None, tp, None)}
    norm = {"scale": P(None, None)}
    layer = {"ln1": norm, "ln2": norm, "attn": attn}
    if cfg.moe:
        ms = moe_param_specs(cfg.moe, tp)
        layer["moe"] = {k: P(*((None,) + tuple(s)))
                        for k, s in ms.items()}
    else:
        layer["ffn"] = {"w_gate": P(None, None, tp),
                        "w_up": P(None, None, tp),
                        "w_down": P(None, tp, None)}
    vocab_div = cfg.vocab % 16 == 0
    embed = P(tp, None) if vocab_div else P(None, tp)
    lm_head = P(None, tp) if vocab_div else P(tp, None)
    return {
        "embed": embed,
        "layers": layer,
        "final_norm": {"scale": P(None)},
        "lm_head": lm_head,
    }


# ----------------------------- forward ------------------------------------

def _embed(table, tokens):
    if table.dtype == torch.float32:
        return L.gather_rows(table, tokens)
    return table[tokens.long()]


def _num_layers(params) -> int:
    return leaves(params["layers"])[0].shape[0]


def _carry(cfg: TransformerConfig, x, x_new):
    """The next layer's input, or ``jax.lax.scan``'s ``TypeError`` when a
    scanned layer changed the carry's dtype."""
    if cfg.scan_layers and x_new.dtype != x.dtype:
        raise TypeError(f"scan body function carry input and carry output "
                        f"must have equal types: the layer took {x.dtype} "
                        f"and gave {x_new.dtype}")
    return x_new


def _block(cfg: TransformerConfig, x, positions, lp, kv_cache=None,
           cache_len=None, return_kv=False, causal=True,
           cache_in_place=False):
    S = x.shape[1]
    chunked = kv_cache is None and S >= cfg.chunk_threshold
    cs = cfg.cast_norm_scale
    h, kv = L.attention(lp["attn"], L.rmsnorm(lp["ln1"], x, cast_scale=cs),
                        positions,
                        n_rep=cfg.n_rep, causal=causal,
                        theta=cfg.rope_theta, kv_cache=kv_cache,
                        cache_len=cache_len, return_kv=return_kv,
                        chunked=chunked, q_block=cfg.q_block,
                        kv_block=cfg.kv_block,
                        unroll_attn=not cfg.scan_layers,
                        cache_in_place=cache_in_place)
    x = x + h
    hn = L.rmsnorm(lp["ln2"], x, cast_scale=cs)
    if cfg.moe:
        y, aux = moe_apply_batched(lp["moe"], hn, cfg.moe)
    else:
        y = L.ffn(lp["ffn"], hn)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (x + y.to(x.dtype)).to(x.dtype), kv, aux


def _remat(cfg: TransformerConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    is set and autograd records."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(params, tokens, cfg: TransformerConfig):
    """Training/prefill trunk: tokens (B, S) -> hidden (B, S, d), aux."""
    S = tokens.shape[1]
    x = _embed(params["embed"], tokens)
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, lp):
        x_new, _, a = _block(cfg, x, positions, lp)
        return x_new, a

    for lp in L.tree_unstack(params["layers"]):
        x_new, a = _remat(cfg, body, x, lp)
        x, aux = _carry(cfg, x, x_new), aux + a
    return L.rmsnorm(params["final_norm"], x), aux


def train_loss(params, tokens, labels, cfg: TransformerConfig):
    x, aux = forward(params, tokens, cfg)
    logits = L.matmul(x, params["lm_head"]).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if cfg.vocab_parallel_ce:
        onehot = torch.nn.functional.one_hot(labels.long(), cfg.vocab)
        gold = torch.sum(logits * onehot.to(logits.dtype), dim=-1)
    else:
        gold = torch.take_along_dim(logits, labels.long()[..., None],
                                    dim=-1)[..., 0]
    nll = torch.mean(logz - gold)
    zloss = 1e-4 * torch.mean(torch.square(logz))
    return nll + zloss + aux


def prefill(params, tokens, cfg: TransformerConfig):
    """Prefill: returns (logits_last, kv_caches stacked (L, 2, B, S, H, D))."""
    S = tokens.shape[1]
    x = _embed(params["embed"], tokens)
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, lp):
        x_new, kv, _ = _block(cfg, x, positions, lp, return_kv=True)
        return x_new, torch.stack(kv)           # (2, B, S, Hkv, Dh)

    caches = []
    for lp in L.tree_unstack(params["layers"]):
        x_new, kv = _remat(cfg, body, x, lp)
        x = _carry(cfg, x, x_new)
        caches.append(kv)
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.matmul(x[:, -1:], params["lm_head"]).to(torch.float32)
    return logits, torch.stack(caches)


def decode_step(params, token, caches, cache_len, cfg: TransformerConfig):
    """One token for every sequence: token (B, 1), caches (L, 2, B, T, H, D),
    cache_len an int — the new KV is written at cache_len into one copy of
    the caches, which is returned."""
    B = token.shape[0]
    x = _embed(params["embed"], token)
    positions = torch.full((B, 1), int(cache_len), dtype=torch.int32,
                           device=x.device)
    new = caches.clone()
    for i in range(_num_layers(params)):
        x_new, _, _ = _block(cfg, x, positions,
                             L.tree_index(params["layers"], i),
                             kv_cache=(new[i, 0], new[i, 1]),
                             cache_len=cache_len, causal=False,
                             cache_in_place=True)
        x = _carry(cfg, x, x_new)
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.matmul(x, params["lm_head"]).to(torch.float32)
    return logits, new


def make_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype=None, device=None):
    dtype = dtype or cfg.dtype
    return torch.zeros((cfg.n_layers, 2, batch, max_len, cfg.n_kv_heads,
                        cfg.d_head), dtype=dtype, device=device)
