"""The fanout neighbor sampler, the synthetic data pipelines and the
Cora-like dataset on the port, held against the reference on the CPU.

Everything here is integer or numpy-generated data: every comparison is
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipe
from repro.graph import datasets as ref_datasets
from repro.graph import make_dataset as ref_make_dataset
from repro.graph import sampling_service as ref_sampling
from repro_torch.core import rng
from repro_torch.data import pipeline as pipe
from repro_torch.graph import make_cora_like, make_dataset, sampling_service


@pytest.fixture(scope="module")
def graphs():
    """The WG stand-in at scale 10, built by each package."""
    return (ref_make_dataset("WG", scale_override=10),
            make_dataset("WG", scale_override=10, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10)])
def test_sample_blocks_bit_equal(graphs, seed, fanouts):
    ref_g, g = graphs
    seeds = np.random.default_rng(seed).integers(0, g.num_vertices, 64)
    want_blocks, want_nodes = ref_sampling.sample_blocks(
        ref_g, jnp.asarray(seeds), fanouts, seed=seed)
    blocks, nodes = sampling_service.sample_blocks(g, seeds, fanouts,
                                                   seed=seed)
    assert nodes.dtype == torch.int32
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(want_nodes))
    assert len(blocks) == len(want_blocks) == len(fanouts)
    for b, w in zip(blocks, want_blocks):
        assert (b.num_src, b.num_dst) == (w.num_src, w.num_dst)
        np.testing.assert_array_equal(b.edge_index.numpy(),
                                      np.asarray(w.edge_index))
    union = sampling_service.block_union_graph(blocks)
    np.testing.assert_array_equal(
        union.numpy(), np.asarray(ref_sampling.block_union_graph(want_blocks)))
    # every sampled edge is a real edge (neighbor -> frontier) or a
    # degree-0 self-loop, as tests/test_system.py checks the reference's
    rp, col = g.row_ptr.numpy(), g.col.numpy()
    for s, d in union.numpy().T:
        deg = rp[d + 1] - rp[d]
        if deg == 0:
            assert s == d
        else:
            assert s in col[rp[d]:rp[d + 1]]


def test_sampler_draws_on_the_corpus_channel(graphs):
    """The reference draws with the literal salt 3, ``SALT_CORPUS``'s
    value: the port passes the registered name, so the draws coincide."""
    assert rng.SALT_CORPUS == 3
    _, g = graphs
    nodes = torch.arange(32, dtype=torch.int32)
    key = rng.stream_key(4)
    got = sampling_service.sample_neighbors(g, nodes, 6, key, 2)
    u = rng.task_uniforms(key, nodes, torch.full_like(nodes, 2), 6, salt=3)
    deg = (g.row_ptr[1:] - g.row_ptr[:-1])[nodes.long()]
    idx = torch.minimum((u * deg[:, None]).to(torch.int32),
                        torch.clamp(deg - 1, min=0)[:, None])
    want = torch.where(deg[:, None] > 0,
                       g.col[(g.row_ptr[nodes.long()][:, None] + idx).long()
                             .clamp(0, g.num_edges - 1)], nodes[:, None])
    assert torch.equal(got, want)


def _equal_trees(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal_trees(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal_trees(a, b)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_pipelines_equal_reference(seed):
    tcfg = dict(vocab=97, seq_len=12, global_batch=5, seed=seed)
    for step in (0, 7):
        _equal_trees(pipe.lm_batch(pipe.TokenPipelineConfig(**tcfg), step),
                     ref_pipe.lm_batch(ref_pipe.TokenPipelineConfig(**tcfg),
                                       step))
    gen = pipe.lm_batches(pipe.TokenPipelineConfig(**tcfg), start_step=2)
    ref_gen = ref_pipe.lm_batches(ref_pipe.TokenPipelineConfig(**tcfg),
                                  start_step=2)
    for _ in range(2):
        _equal_trees(next(gen), next(ref_gen))
    for kw in (dict(d_edge=0), dict(d_edge=4, n_classes=5, out_dim=2)):
        _equal_trees(pipe.gnn_batch(50, 120, 9, seed=seed, **kw),
                     ref_pipe.gnn_batch(50, 120, 9, seed=seed, **kw))
    _equal_trees(pipe.molecule_batch(12, 40, 4, seed=seed),
                 ref_pipe.molecule_batch(12, 40, 4, seed=seed))
    vocabs = (50, 7, 1000)
    _equal_trees(pipe.recsys_batch(16, 13, 3, vocabs, seed=seed),
                 ref_pipe.recsys_batch(16, 13, 3, vocabs, seed=seed))


def test_to_device_keeps_the_tree():
    b = pipe.molecule_batch(6, 10, 2)
    t = pipe.to_device(b, "cpu")
    assert sorted(t) == sorted(b)
    for k, v in b.items():
        assert isinstance(t[k], torch.Tensor)
        np.testing.assert_array_equal(t[k].numpy(), v)
    toks = pipe.to_device(pipe.lm_batch(pipe.TokenPipelineConfig(9, 4, 2), 0))
    assert isinstance(toks, tuple) and toks[0].dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 2])
def test_cora_like_equals_reference(seed):
    g, feats, labels = make_cora_like(seed, device="cpu")
    ref_g, ref_feats, ref_labels = ref_datasets.make_cora_like(seed)
    np.testing.assert_array_equal(g.row_ptr.numpy(), np.asarray(ref_g.row_ptr))
    np.testing.assert_array_equal(g.col.numpy(), np.asarray(ref_g.col))
    assert (g.num_vertices, g.num_edges, g.max_degree) == \
        (ref_g.num_vertices, ref_g.num_edges, ref_g.max_degree)
    _equal_trees((feats, labels), (ref_feats, ref_labels))


def test_jax_key_is_the_stream_key():
    """``stream_key(seed)`` is ``jax.random.PRNGKey(seed)``'s key pair."""
    for seed in (0, 1, 12345):
        np.testing.assert_array_equal(
            rng.stream_key(seed).numpy().astype(np.uint32),
            np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
            .astype(np.uint32))
