"""On-card checks of the CUDA walk-step kernels and the ``cuda`` step.

Marked ``gpu``: each test skips, with the reason, where CUDA is not
available (the decision is made inside the fixture, never at import).
Run them on a card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_cuda.py``.

Every comparison is exact: the kernels' outputs are int32 vertex ids and
degrees, and the walker's paths, lengths and stats are integers.
"""
import numpy as np
import pytest
import torch

from repro_torch.graph import make_dataset
from repro_torch.kernels.walk_step import LAUNCHES, ops, ref
from repro_torch.walker import ExecutionConfig, WalkProgram, compile

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_dataset("WG", weighted=True, with_alias=True,
                        scale_override=10)


@pytest.mark.parametrize("width", [1, 255, 256, 1000, 4096])
def test_kernels_bit_equal_to_plain_versions(cuda_graph, width):
    g = cuda_graph
    rng = np.random.default_rng(width)
    deg = (g.row_ptr[1:] - g.row_ptr[:-1]).cpu().numpy()
    v = rng.integers(-1, g.num_vertices + 2, width).astype(np.int32)
    v[::3] = rng.choice(np.flatnonzero(deg == 0), len(v[::3]))
    v[1::5] = int(np.argmax(deg))
    v = torch.from_numpy(v).cuda()
    u = torch.from_numpy(rng.random((2, width), dtype=np.float32)).cuda()
    uc, ua = u[0].contiguous(), u[1].contiguous()
    before = dict(LAUNCHES)
    got = ops.walk_step_uniform(v, uc, g.row_ptr, g.col)
    want = ref.walk_step_uniform_ref(v, uc, g.row_ptr, g.col)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    args = (v, uc, ua, g.row_ptr, g.col, g.alias_prob, g.alias_idx)
    got = ops.walk_step_alias(*args)
    want = ref.walk_step_alias_ref(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES["walk_step_uniform"] == before["walk_step_uniform"] + 1
    assert LAUNCHES["walk_step_alias"] == before["walk_step_alias"] + 1


def test_cuda_tensor_never_falls_back_to_the_plain_version(cuda_graph):
    g = cuda_graph
    v = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="span devices"):
        ops.walk_step_uniform(v, torch.zeros(8), g.row_ptr, g.col)


@pytest.mark.parametrize("name", ["urw", "ppr", "deepwalk"])
def test_cuda_step_equals_cpu_plain_step(cuda_graph, name):
    g = cuda_graph
    g_cpu = make_dataset("WG", weighted=True, with_alias=True,
                         scale_override=10, device="cpu")
    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, 700).astype(np.int32)
    prog = getattr(WalkProgram, name)(max_hops=20)
    want = compile(prog, execution=ExecutionConfig(num_slots=256)).run(
        g_cpu, starts, seed=1)
    before = dict(LAUNCHES)
    got = compile(prog, execution=ExecutionConfig(
        num_slots=256, step_impl="cuda")).run(g, starts, seed=1)
    assert torch.equal(got.paths.cpu(), want.paths)
    assert torch.equal(got.lengths.cpu(), want.lengths)
    assert all(int(a) == int(b) for a, b in zip(got.stats, want.stats))
    kernel = "walk_step_alias" if name == "deepwalk" else "walk_step_uniform"
    assert LAUNCHES[kernel] - before[kernel] == int(got.stats.supersteps)
