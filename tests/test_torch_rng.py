"""RNG parity: the torch port's Threefry derivation against ``repro.core.rng``.

Every comparison is exact (bit-equal words and float32 bit patterns): the
derivation is integer arithmetic plus one exact bit-cast, so there is no
float output to tolerate.  Inputs come from numpy seeds and go through both
packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as ref_rng
from repro_torch.core import rng as port_rng

U32 = np.iinfo(np.uint32).max


def _words(rng, n):
    return rng.integers(0, U32, n, dtype=np.uint64, endpoint=True).astype(
        np.uint32)


def _t(x):
    """numpy uint32/int32 -> torch int64 holding the same bits."""
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same_words(port, ref):
    return np.array_equal(port.numpy().astype(np.uint32),
                          np.asarray(ref).astype(np.uint32))


def test_threefry2x32_bit_equal():
    rng = np.random.default_rng(0)
    k0, k1, x0, x1 = (_words(rng, 257) for _ in range(4))
    k0[:3], x1[:3] = [0, U32, 1], [U32, 0, 0x80000000]
    ref = ref_rng.threefry2x32(k0, k1, x0, x1)
    port = port_rng.threefry2x32(_t(k0), _t(k1), _t(x0), _t(x1))
    assert all(_same_words(p, r) for p, r in zip(port, ref))


def test_fold_in_pair_bit_equal():
    rng = np.random.default_rng(1)
    k0, k1, data = (_words(rng, 129) for _ in range(3))
    ref = ref_rng.fold_in_pair(k0, k1, data)
    port = port_rng.fold_in_pair(_t(k0), _t(k1), _t(data))
    assert all(_same_words(p, r) for p, r in zip(port, ref))


@pytest.mark.parametrize("num", [1, 2, 5, 8])
def test_key_bits_bit_equal(num):
    rng = np.random.default_rng(num)
    k0, k1 = _words(rng, 33), _words(rng, 33)
    ref = ref_rng.key_bits(k0, k1, num)
    port = port_rng.key_bits(_t(k0), _t(k1), num)
    assert port.shape == (33, num)
    assert _same_words(port, ref)


def test_bits_to_uniform_bit_equal():
    bits = np.concatenate([
        np.array([0, 1, 511, 512, 0x7FFFFFFF, 0x80000000, U32 - 1, U32],
                 np.uint32), _words(np.random.default_rng(2), 500)])
    ref = np.asarray(ref_rng.bits_to_uniform(jnp.asarray(bits)))
    port = port_rng.bits_to_uniform(_t(bits)).numpy()
    assert port.dtype == np.float32
    assert np.array_equal(port.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("salt", [0, 1, 2])
@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("num", [1, 2, 3])
def test_task_uniforms_bit_equal(salt, epoch, num):
    rng = np.random.default_rng(100 * salt + 10 * epoch + num)
    W = 97
    qid = rng.integers(0, 5000, W).astype(np.int32)
    qid[::5] = -1                       # idle lanes carry query id -1
    hop = rng.integers(0, 80, W).astype(np.int32)
    ep = np.full(W, epoch, np.int32)
    ep[::4] = 0                         # epoch 0 lanes fold nothing extra
    key = ref_rng.stream_key(12345)
    ref = np.asarray(ref_rng.task_uniforms(
        key, jnp.asarray(qid), jnp.asarray(hop), num, salt,
        epoch=jnp.asarray(ep)))
    port = port_rng.task_uniforms(
        port_rng.stream_key(12345), torch.from_numpy(qid),
        torch.from_numpy(hop), num, salt, epoch=torch.from_numpy(ep)).numpy()
    assert port.dtype == np.float32 and port.shape == (W, num)
    assert np.array_equal(port.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, -1, 2**31 - 1, 2**32 + 5])
@pytest.mark.parametrize("epoch", [0, 1, 5])
def test_stream_key_bit_equal(seed, epoch):
    ref = np.asarray(ref_rng.stream_key(seed, epoch))
    port = port_rng.stream_key(seed, epoch)
    assert port.shape == (2,)
    assert _same_words(port, ref)
    # A key pair passes through as the seed of a later derivation.
    assert _same_words(port_rng.stream_key(ref, epoch),
                       ref_rng.stream_key(jnp.asarray(ref), epoch))
