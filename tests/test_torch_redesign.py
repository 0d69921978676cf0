"""The orderings of the redesigned CUDA kernels, transliterated to torch and
held here on the CPU (the kernels themselves run only on a card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them there).

- The fused kernel's reservoir splits a lane's scan into (lane, chunk)
  items that any warp of the grid may take, in any order, and merges each
  item's best into the lane's word by a 64-bit ``atomicMax`` of (the key's
  order-preserving bits, then ``0xffffffff - position``).  Applied in a
  shuffled order of items, that rule must give the index that
  ``es_chunk_score`` + ``es_merge`` give over the chunks in order (the
  port's and the reference's): ties within and across chunks, -0.0
  against +0.0, lanes whose keys are all -inf and degrees that are not a
  multiple of the chunk.
- The segment sum links each position into its segment's chain with
  atomics (so in any order), then the position at each chain's head sums
  its segment's rows in ascending position: the chain's positions sorted
  when it holds at most 32, else the ids scanned in position order.
  Built from a shuffled order, that must equal ``segment_sum_ref`` bit
  for bit.

Keys and sums are float32 on both sides: every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import samplers as ref_samplers
from repro_torch.core.samplers import es_chunk_score, es_merge
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

# ------------------------------------------------------------- reservoir


def order_bits(key: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving bits of float32 keys (int64 in
    [0, 2^32)), -0.0 taken as +0.0 first."""
    key = torch.where(key == 0, torch.zeros_like(key), key)
    bits = key.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits & 0x80000000) != 0
    return torch.where(neg, ~bits & 0xFFFFFFFF, bits | 0x80000000)


def pack(key: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The kernel's packed merge word, as an int64 whose signed order is
    the word's unsigned order (the top bit flipped)."""
    return (order_bits(key) - 2**31) * 2**32 + (0xFFFFFFFF - pos)


def chunk_parallel_pick(u, w, deg, chunk, seed):
    """The kernel's reservoir pick: every (lane, chunk) item's largest
    packed word over its valid candidates, folded into the lane's word by
    max in a shuffled order of items, from the reset word (below every
    packed word); the position it holds, clipped into [0, deg - 1]."""
    W = u.shape[0]
    key = torch.where(w > 0, torch.log(u + 1e-20) / w,
                      torch.full_like(u, -torch.inf))
    best = torch.full((W,), -2**63, dtype=torch.int64)
    items = [(lane, c) for lane in range(W)
             for c in range(-(-int(deg[lane]) // chunk))]
    for i in np.random.default_rng(seed).permutation(len(items)):
        lane, c = items[i]
        pos = torch.arange(c * chunk, min((c + 1) * chunk, int(deg[lane])))
        best[lane] = max(int(best[lane]), int(pack(key[lane, pos], pos).max()))
    pos = 0xFFFFFFFF - (best + 2**63) % 2**32
    return torch.minimum(torch.clamp(pos, min=0), torch.clamp(deg - 1, min=0))


def chunks_in_order(u, w, deg, chunk, score, merge, asarray):
    """``es_chunk_score`` + ``es_merge`` over the chunks in order, as the
    plain scan runs them (positions past deg invalid), clipped; ``u``,
    ``w``, ``deg`` numpy, handed to the functions through ``asarray``."""
    W, n = u.shape
    best_key = asarray(np.full(W, -np.inf, dtype=np.float32))
    best_idx = asarray(np.zeros(W, dtype=np.int32))
    for c in range(n // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        valid = np.arange(c * chunk, (c + 1) * chunk)[None, :] < deg[:, None]
        c_best, c_key = score(asarray(u[:, sl]), asarray(valid),
                              asarray(w[:, sl]))
        best_key, best_idx = merge(best_key, best_idx, c, chunk, c_best, c_key)
    return np.minimum(np.maximum(np.asarray(best_idx), 0),
                      np.maximum(deg - 1, 0))


def planted_lanes(chunk, seed):
    """Uniforms and weights of lanes with planted cases; returns (u, w,
    deg, n) with n positions a lane (a multiple of chunk)."""
    rng = np.random.default_rng(seed)
    deg = np.array([1, chunk - 1, chunk, chunk + 3, 3 * chunk + 5,
                    2 * chunk, 5 * chunk - 1, 7, chunk + 1, 4 * chunk])
    W, n = len(deg), 5 * chunk
    u = rng.random((W, n), dtype=np.float32)
    w = rng.random((W, n), dtype=np.float32) * 2 + 0.25
    # lane 1: an exact tie inside the chunk (same u and w twice)
    u[1, [1, chunk - 2]], w[1, [1, chunk - 2]] = 0.999, 1.5
    # lane 3: an exact tie across chunks, the later one in chunk 1
    u[3, [chunk + 1, 2]], w[3, [chunk + 1, 2]] = 0.9999, 3.0
    # lane 4: -0.0 (w = inf) in chunk 0 against +0.0 (u = 1) in chunk 2,
    # both above every other key
    u[4, 5], w[4, 5] = 0.5, np.inf
    u[4, 2 * chunk + 1], w[4, 2 * chunk + 1] = 1.0, 2.0
    # lane 5: every key -inf (w <= 0)
    w[5] = np.where(np.arange(n) % 2, 0.0, -1.0)
    # lane 6: -inf everywhere but one position, in the last chunk
    w[6, :] = 0.0
    w[6, 4 * chunk + 2] = 1.0
    # lane 7: +0.0 at position 6 ties -0.0 at position 0
    u[7, 0], w[7, 0] = 0.25, np.inf
    u[7, 6], w[7, 6] = 1.0, 1.0
    return u, w, deg, n


@pytest.mark.parametrize("chunk", [4, 7, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_parallel_merge_equals_chunks_in_order(chunk, seed):
    u, w, deg, n = planted_lanes(chunk, seed)
    got = chunk_parallel_pick(torch.from_numpy(u), torch.from_numpy(w),
                              torch.from_numpy(deg), chunk, seed)
    port = chunks_in_order(u, w, deg, chunk, es_chunk_score, es_merge,
                           lambda x: torch.as_tensor(np.ascontiguousarray(x)))
    reference = chunks_in_order(u, w, deg, chunk, ref_samplers.es_chunk_score,
                                ref_samplers.es_merge, jnp.asarray)
    np.testing.assert_array_equal(got.numpy(), port)
    np.testing.assert_array_equal(got.numpy(), reference)
    # the planted cases pick what the reference's rule says
    assert got[1] == 1 and got[3] == 2 and got[5] == 0
    assert got[4] == 5 and got[7] == 0 and got[6] == 4 * chunk + 2


def test_packed_words_order_as_the_keys():
    """The packed word orders candidates as (key, then lower position):
    -inf below every finite key, -0.0 equal to +0.0."""
    keys = torch.tensor([-torch.inf, -3.5, -1e-30, -0.0, 0.0, 2.0, torch.inf])
    bits = order_bits(keys)
    assert bool((bits[1:] >= bits[:-1]).all()) and bits[3] == bits[4]
    assert len(set(bits.tolist())) == len(keys) - 1
    pos = torch.tensor([5, 2])
    a = pack(torch.tensor([-1.0, -1.0]), pos)
    assert a[1] > a[0]       # equal keys: the lower position wins
    assert pack(torch.tensor([-0.5]), torch.tensor([9])) > a.max()


# ------------------------------------------------------------ segment sum

CHAIN_MAX = 32      # chain entries a warp walks before it scans the ids


def chained_segment_sum(data, ids, num_segments, seed):
    """The kernel's segment sum: zeros everywhere; positions linked into
    per-segment chains in a shuffled order (the atomics' order), each
    marking the position it displaces from the chain's head; then every
    position never displaced (a chain's head) sums its segment's rows
    from 0.0 in ascending position into the row: the chain sorted when it
    holds at most CHAIN_MAX entries, else the ids scanned in position
    order."""
    E, S = ids.shape[0], num_segments
    head = np.zeros(S, dtype=np.int64)          # last linked position + 1
    nxt = np.full(max(E, 1), -1, dtype=np.int64)
    linked = np.zeros(max(E, 1), dtype=bool)
    idv = ids.numpy()
    for e in np.random.default_rng(seed).permutation(E):
        if 0 <= idv[e] < S:
            prev = head[idv[e]] - 1
            head[idv[e]], nxt[e] = e + 1, prev
            if prev >= 0:
                linked[prev] = True
    out = torch.zeros((S, data.shape[1]), dtype=torch.float32)
    for e in range(E):
        s = idv[e]
        if not 0 <= s < S or linked[e]:
            continue
        chain, p = [e], nxt[e]
        while p >= 0 and len(chain) < CHAIN_MAX:
            chain.append(p)
            p = nxt[p]
        order = (sorted(chain) if p < 0
                 else np.flatnonzero(idv == s).tolist())
        acc = torch.zeros(data.shape[1], dtype=torch.float32)
        for q in order:
            acc = acc + data[q]
        out[s] = acc
    return out


@pytest.mark.parametrize("E,S,D,hub_reps", [
    (3000, 1000, 8, 1100),      # a hub id repeated more than 1,024 times
    (500, 257, 5, 40),          # a chain just past 32; S not a tile multiple
    (700, 300, 4, 0),           # short chains only
    (0, 77, 3, 0),              # no ids at all: every row zero
])
def test_chained_segment_sum_equals_plain_version(E, S, D, hub_reps):
    rng = np.random.default_rng(E + S)
    ids = rng.integers(0, S, E).astype(np.int32)
    ids[::97] = -1                      # dropped
    ids[1::101] = S                     # dropped
    ids[2::103] = 2**31 - 1             # dropped
    if hub_reps:
        ids[rng.choice(E, hub_reps, replace=False)] = S // 3
    data = rng.standard_normal((E, D)).astype(np.float32)
    data[::5, ::2] = -0.0
    data, ids = torch.from_numpy(data), torch.from_numpy(ids)
    want = segment_sum_ref(data, ids, S)
    for seed in (0, 1):
        got = chained_segment_sum(data, ids, S, seed)
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
    if hub_reps:
        assert int((ids == S // 3).sum()) >= hub_reps > CHAIN_MAX
