"""Flash-style chunked attention, the reference's
``repro.models.attention_chunked``: an online softmax with a running
(max, denominator, accumulator) over KV blocks, for each Q block.  Keeps
the working set at (q_block x kv_block) instead of S x S, for the 32k
prefill.

The reference's two ``jax.lax.scan``s are Python loops here, over the Q
blocks and, inside, the KV blocks.  One step of the causal loop is left
out: a KV block that lies wholly after a Q block's last position.  Every
score of such a block is ``-1e30``; with the running max already finite
(block 0 holds position 0, which no query masks) its ``p`` is
``exp(-1e30 - m) = 0`` and its correction ``exp(m - m) = 1``, so the scan
step changes nothing and the loop stops before it.

Equivalent to full softmax attention (:func:`full_attention_ref`).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import einsum, softmax


def _block_attn(q, k, v, qpos, kpos, causal, m, l, acc, scale):
    """One (q_block, kv_block) tile of the online softmax."""
    s = einsum("bsgrd,btgd->bgrst", q, k) * scale         # (B,g,r,qb,kb)
    if causal:
        mask = qpos[:, None] >= kpos[None, :]             # (qb, kb)
        s = torch.where(mask, s, -1e30)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))       # (B,g,r,qb)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    pv = einsum("bgrst,btgd->bgrsd", p.to(v.dtype), v)
    acc_new = acc * corr[..., None] + pv.to(acc.dtype)
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool = True,
                      q_block: int = 1024, kv_block: int = 1024,
                      q_offset: int = 0, unroll: bool = False):
    """q: (B, S, Hq, D); k/v: (B, T, Hkv, D); GQA via Hq = g·r.

    q_offset: position of q[0] within the kv sequence (prefill: 0; decode
    with history: cache_len).  Returns (B, S, Hq, D).  ``unroll`` is
    accepted for the reference's signature: the loops are Python's
    either way.
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    r = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qb = min(q_block, S)
    kb = min(kv_block, T)
    if S % qb or T % kb:
        raise ValueError(f"blocks must divide the lengths: S={S} q_block={qb}"
                         f", T={T} kv_block={kb}")
    nq, nk = S // qb, T // kb
    dev = q.device
    out = torch.empty_like(q)
    for qi in range(nq):
        q_blk = q[:, qi * qb:(qi + 1) * qb].reshape(B, qb, Hkv, r, D)
        qpos = q_offset + qi * qb + torch.arange(qb, device=dev)
        m = torch.full((B, Hkv, r, qb), -torch.inf, device=dev)
        l = torch.zeros((B, Hkv, r, qb), device=dev)
        acc = torch.zeros((B, Hkv, r, qb, D), device=dev)
        for ki in range(nk):
            if causal and ki * kb > q_offset + (qi + 1) * qb - 1:
                break                  # every later block is masked whole
            kpos = ki * kb + torch.arange(kb, device=dev)
            m, l, acc = _block_attn(q_blk, k[:, ki * kb:(ki + 1) * kb],
                                    v[:, ki * kb:(ki + 1) * kb], qpos, kpos,
                                    causal, m, l, acc, scale)
        o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        out[:, qi * qb:(qi + 1) * qb] = o.permute(0, 3, 1, 2, 4) \
            .reshape(B, qb, Hq, D)
    return out


def full_attention_ref(q, k, v, *, causal=True, q_offset=0):
    """Oracle: materialized-scores softmax attention (small shapes only)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    r = Hq // Hkv
    qr = q.reshape(B, S, Hkv, r, D)
    s = einsum("bsgrd,btgd->bgrst", qr, k) / (D ** 0.5)
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)
        kpos = torch.arange(T, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
    p = softmax(s.to(torch.float32))
    o = einsum("bgrst,btgd->bsgrd", p.to(v.dtype), v)
    return o.reshape(B, S, Hq, D)
