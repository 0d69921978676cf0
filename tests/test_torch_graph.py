"""Graph parity: the torch port's CSR, alias tables and datasets against
``repro.graph``.

Every comparison is exact: the builders run the same numpy algorithm on the
same edges, so the integer arrays and the float32 weights and alias
probabilities must be equal element for element.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.graph import build_alias_tables as ref_alias
from repro.graph import build_csr as ref_build_csr
from repro.graph import make_dataset as ref_make_dataset
from repro.graph.generators import rmat_edges as ref_rmat
from repro_torch.graph import (CSRGraph, build_alias_tables, build_csr,
                               from_reference_arrays, make_dataset,
                               validate_csr)
from repro_torch.graph.csr import column_access, row_access
from repro_torch.graph.generators import rmat_edges

TENSORS = ("row_ptr", "col", "weights", "alias_prob", "alias_idx",
           "edge_type", "type_offsets")
SCALARS = ("num_vertices", "num_edges", "max_degree", "num_edge_types")


def reference_arrays(g) -> dict:
    """The reference graph's fields as numpy arrays and ints."""
    out = {k: None if getattr(g, k) is None else np.asarray(getattr(g, k))
           for k in TENSORS}
    out.update({k: int(getattr(g, k)) for k in SCALARS})
    return out


def assert_same_graph(port: CSRGraph, ref) -> None:
    want = reference_arrays(ref)
    for k in TENSORS:
        got = getattr(port, k)
        if want[k] is None:
            assert got is None, k
            continue
        assert got.device.type == "cpu"
        got = got.numpy()
        assert got.dtype == want[k].dtype, (k, got.dtype, want[k].dtype)
        assert np.array_equal(got, want[k]), k
    for k in SCALARS:
        assert getattr(port, k) == want[k], k


def test_rmat_edges_equal():
    for undirected in (False, True):
        e_ref, n_ref = ref_rmat(8, 5, seed=3, undirected=undirected)
        e, n = rmat_edges(8, 5, seed=3, undirected=undirected)
        assert n == n_ref and np.array_equal(e, e_ref)


def test_build_csr_equal():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 50, (400, 2))
    edges[:20] = edges[20:40]            # duplicates to dedup
    w = rng.random(400).astype(np.float32)
    types = rng.integers(0, 3, 400).astype(np.int32)
    for kw in ({}, {"weights": w},
               {"weights": w, "edge_types": types, "num_edge_types": 3},
               {"dedup": False}):
        ref = ref_build_csr(edges, 60, **kw)
        port = build_csr(edges, 60, device="cpu", **kw)
        assert_same_graph(port, ref)
        validate_csr(port)


def test_build_alias_tables_equal():
    rng = np.random.default_rng(1)
    edges = rng.integers(0, 40, (500, 2))
    edges[:30, 0] = 7                     # one high-degree row
    w = (rng.random(500) + 1e-3).astype(np.float32)
    for weights in (w, None):
        ref = ref_alias(ref_build_csr(edges, 45, weights=weights))
        port = build_alias_tables(build_csr(edges, 45, weights=weights,
                                            device="cpu"))
        assert_same_graph(port, ref)


@pytest.mark.parametrize("name,kw", [
    ("WG", {"weighted": True, "with_alias": True}),
    ("AS", {}),
    ("WG", {"weighted": True, "with_alias": True, "num_edge_types": 3}),
    ("WG", {"num_edge_types": 3}),
])
def test_make_dataset_equal(name, kw):
    ref = ref_make_dataset(name, scale_override=9, **kw)
    port = make_dataset(name, scale_override=9, device="cpu", **kw)
    assert_same_graph(port, ref)


def test_from_reference_arrays_round_trip():
    ref = ref_make_dataset("WG", weighted=True, with_alias=True,
                           scale_override=8)
    arrays = reference_arrays(ref)
    port = from_reference_arrays(arrays, device="cpu")
    assert_same_graph(port, ref)
    back = {k: None if getattr(port, k) is None else getattr(port, k).numpy()
            for k in TENSORS}
    back.update({k: getattr(port, k) for k in SCALARS})
    again = from_reference_arrays(back, device="cpu")
    for f in dataclasses.fields(CSRGraph):
        a, b = getattr(port, f.name), getattr(again, f.name)
        assert (a is None and b is None) or (
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


def test_row_and_column_access():
    g = make_dataset("WG", scale_override=8, device="cpu")
    v = torch.tensor([-1, 0, 5, g.num_vertices - 1, g.num_vertices],
                     dtype=torch.int32)
    addr, deg = row_access(g, v)
    rp = g.row_ptr.numpy()
    assert deg[0] == 0 and deg[-1] == 0   # out-of-range ids: degree 0
    for i in (1, 2, 3):
        assert addr[i] == rp[v[i]] and deg[i] == rp[v[i] + 1] - rp[v[i]]
    e = column_access(g, addr, torch.zeros_like(addr))
    assert e[1] == g.col[min(rp[0], g.num_edges - 1)]


def test_devices_default_to_cuda_and_never_fall_back(monkeypatch):
    """``device=None`` means CUDA; without a card the builders raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_dataset("WG", scale_override=6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_csr(np.zeros((1, 2), np.int64), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_reference_arrays(reference_arrays(ref_build_csr(
            np.zeros((1, 2), np.int64), 2)))
