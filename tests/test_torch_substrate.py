"""The LM training slice's substrate on the port (``optim.grad_compression``,
``runtime.elastic``, ``distributed.pipeline``) and the LM family of
``launch.train``, held against the reference on the CPU.

Tolerances, each with its reason:
- int8 quantization, error feedback: bit for bit.  The quantizer is the
  same float32 expression in both, and ``torch.round`` rounds half to
  even as ``jnp.round`` does.
- the cross-pod reduction: bit for bit against numpy's float32 of the
  same expression (the int32 sum is exact).
- the GPipe schedule: ``atol=1e-5`` against sequential application, the
  reference test's tolerance (the grouped schedule is held bit for bit
  in ``tests/test_torch_substrate_groups.py``).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compression as ref_gc
from repro.runtime import elastic as ref_elastic
from repro_torch.checkpoint.checkpointer import leaves
from repro_torch.distributed import mesh as port_mesh
from repro_torch.distributed import pipeline
from repro_torch.launch import train
from repro_torch.optim import grad_compression as gc
from repro_torch.runtime import elastic


def draws(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def ties():
    """Values whose quotient by the scale lands on halves: ``amax`` is
    127 (1e-12 is below its ulp), so the scale is exactly 1."""
    return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0],
                    np.float32)


# ------------------------------------------------------------ int8 + EF

@pytest.mark.parametrize("case", ["normal", "small", "ties", "zeros"])
def test_quantize_int8_bit_equal_to_reference(case):
    x = {"normal": draws((1000,), 0), "small": draws((7, 33), 1, 1e-3),
         "ties": ties(), "zeros": np.zeros(5, np.float32)}[case]
    wq, ws = ref_gc.quantize_int8(jnp.asarray(x))
    q, s = gc.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(wq))
    assert s.numpy().tobytes() == np.asarray(ws).tobytes()
    assert np.array_equal(gc.dequantize_int8(q, s).numpy(),
                          np.asarray(ref_gc.dequantize_int8(wq, ws)))
    if case == "ties":                       # half to even, as jnp.round
        assert q.tolist() == [127, 0, 2, 2, 0, -2, 126, -127]


def test_compress_with_feedback_bit_equal_to_reference():
    """Ten error-feedback steps (a bfloat16 gradient among them): the
    payload, scale, dequantized gradient and error, bit for bit."""
    e_ref = jnp.zeros((64, 9), jnp.float32)
    e = torch.zeros((64, 9))
    for step in range(10):
        g = draws((64, 9), 10 + step, 1e-2)
        gj, gt = jnp.asarray(g), torch.from_numpy(g)
        if step == 3:
            gj, gt = gj.astype(jnp.bfloat16), gt.to(torch.bfloat16)
        (wq, ws), wd, e_ref = ref_gc.compress_with_feedback(gj, e_ref)
        (q, s), d, e = gc.compress_with_feedback(gt, e)
        assert np.array_equal(q.numpy(), np.asarray(wq))
        assert s.numpy().tobytes() == np.asarray(ws).tobytes()
        assert np.array_equal(d.numpy(), np.asarray(wd))
        assert np.array_equal(e.numpy(), np.asarray(e_ref))


def test_int8_quantization_roundtrip(rng):
    """The reference's ``test_int8_quantization_roundtrip`` on the port."""
    x = torch.as_tensor(rng.standard_normal(1000), dtype=torch.float32)
    q, s = gc.quantize_int8(x)
    err = (gc.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_accumulates(rng):
    """The reference's ``test_error_feedback_accumulates`` on the port: the
    quantized-with-feedback average converges to the true gradient."""
    g = torch.as_tensor(rng.standard_normal(512) * 1e-3, dtype=torch.float32)
    e = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        _, deq, e = gc.compress_with_feedback(g, e)
        total = total + deq
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(),
                               atol=float(g.abs().max()) * 0.05)


def crosspod_numpy(g, e):
    """The reduction in numpy float32: each pod's error-feedback int8
    payload and scale, the payloads summed in int32, times the largest
    scale; every pod holds the result."""
    gp = g.astype(np.float32) + e
    amax = np.abs(gp).reshape(len(gp), -1).max(1) + np.float32(1e-12)
    scale = (amax / np.float32(127.0)).astype(np.float32)
    sb = scale.reshape(-1, *[1] * (g.ndim - 1))
    q = np.clip(np.round(gp / sb), -127, 127).astype(np.int8)
    new_e = gp - q.astype(np.float32) * sb
    total = q.astype(np.int32).sum(0).astype(np.float32) * scale.max()
    return np.broadcast_to(total, g.shape), new_e


@pytest.mark.parametrize("pods", [2, 4])
def test_crosspod_psum_compressed_equals_numpy(pods):
    """A tree of gradients with the pods on each leaf's leading axis, over
    three steps (the error carried), against numpy; ``init_error_state``
    gives float32 zeros of each leaf's shape."""
    shapes = {"w": (pods, 16, 5), "b": [(pods, 7)], "s": (pods,)}
    grads = {"w": draws(shapes["w"], 20), "b": [draws(shapes["b"][0], 21)],
             "s": draws(shapes["s"], 22, 3.0)}
    tg = {"w": torch.from_numpy(grads["w"]),
          "b": [torch.from_numpy(grads["b"][0])],
          "s": torch.from_numpy(grads["s"]).to(torch.bfloat16)}
    errors = gc.init_error_state(tg)
    assert all(x.dtype == torch.float32 and not x.any()
               for x in leaves(errors))
    want_e = [np.zeros(x.shape, np.float32) for x in leaves(tg)]
    for _ in range(3):
        red, errors = gc.crosspod_psum_compressed(tg, errors, "pod")
        for i, (g, r, e) in enumerate(zip(leaves(tg), leaves(red),
                                          leaves(errors))):
            want_r, want_e[i] = crosspod_numpy(g.float().numpy(), want_e[i])
            assert r.shape == g.shape and r.dtype == torch.float32
            assert np.array_equal(r.numpy(), want_r)
            assert np.array_equal(e.numpy(), want_e[i])
            assert all(torch.equal(r[0], r[p]) for p in range(pods))


def test_pmax_and_psum_broadcast_over_the_leading_axis():
    x = torch.tensor([[1, 5], [4, 2], [3, 3]])
    assert torch.equal(port_mesh.pmax(x), torch.tensor([[4, 5]] * 3))
    assert torch.equal(port_mesh.psum(x), torch.tensor([[8, 10]] * 3))


# --------------------------------------------------------------- elastic

def test_elastic_remesh_plan():
    """The reference's ``test_elastic_remesh_plan`` on the port, and
    ``plan_remesh`` and ``ElasticController`` equal to the reference's
    over a grid of inputs."""
    from repro_torch.runtime.elastic import ElasticController, plan_remesh
    assert plan_remesh(512)[0] == (2, 16, 16)
    assert plan_remesh(511)[0] == (1, 16, 16)
    assert plan_remesh(256)[0] == (1, 16, 16)
    assert plan_remesh(8)[0] == (8,)
    ctl = ElasticController(min_devices=4)
    assert ctl.decide(2, 100, 0) == "abort"
    assert ctl.decide(256, 100, 50) == "remesh"
    assert ctl.decide(256, 100, 0) is None
    assert elastic.SUPPORTED_MESHES == ref_elastic.SUPPORTED_MESHES
    for n in range(1, 600):
        for axes in (("pod", "data", "model"), ("a", "b", "c", "d")):
            assert plan_remesh(n, axes) == ref_elastic.plan_remesh(n, axes)
    for exc in (plan_remesh, ref_elastic.plan_remesh):
        with pytest.raises(RuntimeError, match="no devices"):
            exc(0)
    for kw in ({}, dict(min_devices=4, max_straggler_ratio=0.2)):
        port, ref = ElasticController(**kw), ref_elastic.ElasticController(
            **kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for args in [(h, t, s) for h in (0, 1, 3, 4, 256)
                     for t in (0, 1, 100) for s in (0, 1, 5, 21, 50)]:
            assert port.decide(*args) == ref.decide(*args)


def test_build_mesh_stacks_positions_on_one_device():
    """A 1-D shape is the sharded backend's ``Mesh``; more axes a
    ``GridMesh``; both on the device given (the card by default), with
    ``axis_size`` reading either."""
    m = elastic.build_mesh((4,), ("pipe",), devices=["cpu"])
    assert m == port_mesh.Mesh(4, torch.device("cpu"), "pipe")
    assert port_mesh.axis_size(m, "pipe") == 4
    shape, axes = elastic.plan_remesh(512)
    g = elastic.build_mesh(shape, axes, devices=[torch.device("cpu")])
    assert isinstance(g, port_mesh.GridMesh)
    assert (g.shape, g.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert [port_mesh.axis_size(g, a) for a in axes] == [2, 16, 16]
    assert elastic.build_mesh((2,), ("pod",)).device == torch.device("cuda")
    with pytest.raises(ValueError, match="no axis"):
        port_mesh.axis_size(g, "pipe")
    with pytest.raises(ValueError, match="length"):
        elastic.build_mesh((2, 4), ("pod",), devices=["cpu"])


# -------------------------------------------------------------- pipeline

def stage_fn_ref(w, x):
    return jnp.tanh(x @ w)


def stage_fn(w, x):
    return torch.tanh(x @ w)


@pytest.mark.parametrize("stages,micro", [(4, 8), (2, 3), (1, 5), (3, 1)])
def test_gpipe_matches_sequential(stages, micro):
    """The reference's ``test_gpipe_matches_sequential`` in-process: P
    stages stacked on one device, the same weights and microbatches
    (``jax.random``), against the stages applied one after another in the
    port and against the reference's stage function run in JAX."""
    MB, D = 4, 16
    Ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                      (stages, D, D)) * 0.3)
    xs = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (micro, MB, D)))
    mesh = elastic.build_mesh((stages,), ("pipe",), devices=["cpu"])
    out = pipeline.pipeline_apply(stage_fn, torch.from_numpy(Ws),
                                  torch.from_numpy(xs), mesh)
    assert out.shape == xs.shape
    ref, seq = jnp.asarray(xs), torch.from_numpy(xs)
    for i in range(stages):
        ref = stage_fn_ref(jnp.asarray(Ws[i]), ref)
        seq = stage_fn(torch.from_numpy(Ws[i]), seq)
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert abs(pipeline.gpipe_bubble_fraction(4, 8) - 3 / 11) < 1e-9
    assert pipeline.gpipe_bubble_fraction(stages, micro) == \
        (stages - 1) / (micro + stages - 1)


def test_pipeline_takes_trees_and_gradients():
    """Stage parameters as a tree (a dict of stacked leaves), on a
    ``GridMesh``'s ``pipe`` axis; the gradient through the schedule equals
    the sequential one's."""
    P, D = 3, 8
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(P, D, D, generator=g) * 0.3,
              "b": torch.randn(P, D, generator=g)}
    xs = torch.randn(5, 2, D, generator=g)
    mesh = elastic.build_mesh((2, P), ("data", "pipe"), devices=["cpu"])

    def fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    ws = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    pipeline.pipeline_apply(fn, ws, xs, mesh).square().sum().backward()
    seq = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y = xs
    for i in range(P):
        y = fn({k: v[i] for k, v in seq.items()}, y)
    y.square().sum().backward()
    for k in params:
        np.testing.assert_allclose(ws[k].grad.numpy(), seq[k].grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- launcher

def test_launcher_trains_an_lm_and_resumes(tmp_path, capsys):
    """``launch.train`` on ``--arch granite_moe`` (SMOKE at float32, Zipf
    tokens): 4 steps, then resumed to 6 from the step-4 checkpoint."""
    ckpt = str(tmp_path)
    train.main(["--arch", "granite_moe", "--device", "cpu", "--steps", "4",
                "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "done at step 4" in out
    train.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu",
                "--steps", "6", "--batch", "2", "--seq", "16",
                "--ckpt-dir", ckpt, "--resume"])
    out = capsys.readouterr().out
    assert "resumed at step 4" in out and "done at step 6" in out


def test_launcher_resume_is_bit_identical(tmp_path):
    """Two runs resumed to 6 steps from copies of one step-4 checkpoint end
    at the same bits in every file of their step-6 checkpoints (the data
    pipeline's state is the step, so a resumed run is a function of the
    checkpoint)."""
    args = ["--arch", "deepseek_7b", "--device", "cpu", "--batch", "2",
            "--seq", "12"]
    a, b = tmp_path / "a", tmp_path / "b"
    train.main(args + ["--steps", "4", "--ckpt-dir", str(a)])
    shutil.copytree(a, b)
    for d in (a, b):
        train.main(args + ["--steps", "6", "--ckpt-dir", str(d), "--resume"])
    files = sorted(p.name for p in (a / "step_00000006").iterdir())
    assert "manifest.json" in files and len(files) > 10
    assert files == sorted(p.name for p in (b / "step_00000006").iterdir())
    for name in files:
        assert (a / "step_00000006" / name).read_bytes() == \
            (b / "step_00000006" / name).read_bytes(), name
    assert (a / "step_00000004" / "arr_0.npy").read_bytes() != \
        (a / "step_00000006" / "arr_0.npy").read_bytes()
