"""Walk-step kernel parity: the port's wrappers (on CPU tensors they run the
plain versions) against ``repro.kernels.walk_step``'s Pallas kernels (in
interpret mode, as the reference's own tests run them) and their jnp
references.

Every comparison is exact: the outputs are int32 vertex ids and degrees.
The CUDA kernels themselves run only on a card; ``tests/test_torch_cuda.py``
holds them to these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import make_dataset as ref_make_dataset
from repro.kernels.walk_step import ops as ref_ops, ref as ref_ref
from repro_torch.graph import from_reference_arrays
from repro_torch.kernels.walk_step import LAUNCHES, ops

from test_torch_graph import reference_arrays


@pytest.fixture(scope="module")
def graphs():
    ref = ref_make_dataset("WG", weighted=True, with_alias=True,
                           scale_override=9)
    return ref, from_reference_arrays(reference_arrays(ref), device="cpu")


def lanes(g, width, seed):
    """Random lanes plus dangling vertices, the max-degree hub, idle lanes
    (-1), an out-of-range id, and the extreme uniforms 0 and 1-ulp."""
    rng = np.random.default_rng(seed)
    deg = np.diff(np.asarray(g.row_ptr))
    v = rng.integers(0, g.num_vertices, width).astype(np.int32)
    v[0::5] = rng.choice(np.flatnonzero(deg == 0), len(v[0::5]))
    v[1::9] = int(np.argmax(deg))
    v[2::11] = -1
    v[3::13] = g.num_vertices + 3
    u = rng.random((2, width), dtype=np.float32)
    u[:, 4::7] = 0.0
    u[:, 5::8] = np.nextafter(np.float32(1), np.float32(0))
    return v, u[0], u[1]


def _eq(port, ref):
    return np.array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("width", [1, 100, 256, 1000])
def test_walk_step_uniform_bit_equal(graphs, width):
    rg, pg = graphs
    v, u, _ = lanes(rg, width, width)
    want_k = ref_ops.walk_step_uniform(jnp.asarray(v), jnp.asarray(u),
                                       rg.row_ptr, rg.col)
    want_r = ref_ref.walk_step_uniform_ref(jnp.asarray(v), jnp.asarray(u),
                                           rg.row_ptr, rg.col)
    got = ops.walk_step_uniform(torch.from_numpy(v), torch.from_numpy(u),
                                pg.row_ptr, pg.col)
    assert all(t.dtype == torch.int32 for t in got)
    assert all(_eq(a, b) for a, b in zip(got, want_k))
    assert all(_eq(a, b) for a, b in zip(got, want_r))
    assert (got[0][got[1] == 0] == -1).all()     # dangling lanes give -1


@pytest.mark.parametrize("width", [1, 100, 256, 1000])
def test_walk_step_alias_bit_equal(graphs, width):
    rg, pg = graphs
    v, u, ua = lanes(rg, width, width + 1)
    ref_args = (jnp.asarray(v), jnp.asarray(u), jnp.asarray(ua), rg.row_ptr,
                rg.col, rg.alias_prob, rg.alias_idx)
    want_k = ref_ops.walk_step_alias(*ref_args)
    want_r = ref_ref.walk_step_alias_ref(*ref_args)
    got = ops.walk_step_alias(torch.from_numpy(v), torch.from_numpy(u),
                              torch.from_numpy(ua), pg.row_ptr, pg.col,
                              pg.alias_prob, pg.alias_idx)
    assert all(_eq(a, b) for a, b in zip(got, want_k))
    assert all(_eq(a, b) for a, b in zip(got, want_r))


def test_edgeless_graph_reads_no_column():
    """E == 0: every lane has degree 0 and gets -1 (no column to read)."""
    row_ptr = torch.zeros(5, dtype=torch.int32)
    empty_i = torch.zeros(0, dtype=torch.int32)
    v = torch.tensor([-1, 0, 3, 7], dtype=torch.int32)
    u = torch.full((4,), 0.5)
    vn, dg = ops.walk_step_uniform(v, u, row_ptr, empty_i)
    assert vn.tolist() == [-1] * 4 and dg.tolist() == [0] * 4
    vn, dg = ops.walk_step_alias(v, u, u, row_ptr, empty_i,
                                 torch.zeros(0), empty_i)
    assert vn.tolist() == [-1] * 4 and dg.tolist() == [0] * 4


def test_cpu_tensors_run_the_plain_version_without_counting(graphs):
    _, pg = graphs
    before = dict(LAUNCHES)
    v = torch.zeros(8, dtype=torch.int32)
    ops.walk_step_uniform(v, torch.zeros(8), pg.row_ptr, pg.col)
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "lanes", "stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(graphs, bad):
    _, pg = graphs
    v = torch.zeros(8, dtype=torch.int32)
    u = torch.zeros(8)
    if bad == "dtype":
        v = v.long()
    elif bad == "shape":
        v = v.reshape(2, 4)
    elif bad == "lanes":
        u = u[:7]
    else:
        u = torch.zeros(16)[::2]
    with pytest.raises((TypeError, ValueError)):
        ops.walk_step_uniform(v, u, pg.row_ptr, pg.col)
