"""Asynchronous checkpoint writes of the port (``checkpointer.save(...,
blocking=False)`` and ``train_loop.run``'s ``async_checkpoint``), held
against its blocking writes and the reference's on the CPU.

Tolerances: files and arrays bit for bit; the loop's losses against the
reference's within ``rtol=1e-4``, the forward's tolerance of
``tests/test_torch_train.py`` (the models' float differences); the two
port runs' losses and checkpoints bit for bit.  The reference and JAX
are imported inside the tests that use them, so that the card's case
runs where JAX is not installed (``pytest -m gpu``).
"""
import json
import os
import pathlib
import signal
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.distributed.row_blocks import RowBlocks
from repro_torch.runtime import train_loop

CPU = torch.device("cpu")


def make_tree():
    """Every kind of leaf the checkpointer takes: float32, int32 and int64
    tensors, a strided view, bfloat16, a numpy array, a scalar and a
    table in row blocks over 2 CPU groups."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(6, 5, generator=g)
    return {
        "dense": {"w": w, "wt": w.t(), "b": torch.randn(5, generator=g)},
        "half": torch.randn(4, 3, generator=g).to(torch.bfloat16),
        "ids": [torch.arange(7, dtype=torch.int32),
                torch.arange(3, dtype=torch.int64) * 5],
        "table": RowBlocks(torch.randn(8, 4, generator=g).split(4), 4),
        "host": (np.linspace(0.0, 1.0, 9, dtype=np.float32), np.int64(3)),
    }


def reference_tree(tree):
    """``tree`` as the reference holds it: jax arrays (bfloat16 kept), the
    row blocks joined into one table; int64 and host leaves as numpy
    arrays (jax holds no int64 without x64)."""
    import jax.numpy as jnp

    def leaf(x):
        if isinstance(x, RowBlocks):
            return jnp.asarray(x.whole(CPU).numpy())
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return x.numpy() if x.dtype == torch.int64 else jnp.asarray(x.numpy())
    return checkpointer.tree_map(leaf, tree)


def files_of(d):
    return sorted(p.name for p in pathlib.Path(d).iterdir())


def assert_same_files(a, b):
    assert files_of(a) == files_of(b)
    for name in files_of(a):
        assert (pathlib.Path(a, name).read_bytes()
                == pathlib.Path(b, name).read_bytes()), name


def snapshot_values(tree):
    """Independent host copies of ``tree``'s leaves, in leaf order."""
    out = []
    for leaf in checkpointer.leaves(tree):
        if isinstance(leaf, RowBlocks):
            out.append(leaf.whole(CPU).clone())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf.detach().cpu().clone())
        else:
            out.append(np.array(leaf))
    return out


def assert_restored_equal(d, step, like, want):
    back = checkpointer.restore(d, step, like)
    for got, w in zip(checkpointer.leaves(back), want):
        if isinstance(got, RowBlocks):
            got = got.whole(CPU)
        if isinstance(got, torch.Tensor):
            assert got.dtype == w.dtype and torch.equal(got.cpu(), w)
        else:
            np.testing.assert_array_equal(got, w)


@pytest.fixture
def gated_writes(monkeypatch):
    """Hold every file the writer thread writes until the returned event
    is set, so the caller's thread runs ahead of the write."""
    gate = threading.Event()
    real = np.save

    def save(path, arr, *a, **k):
        if threading.current_thread() is not threading.main_thread():
            assert gate.wait(60), "the test never opened the gate"
        return real(path, arr, *a, **k)
    monkeypatch.setattr(checkpointer.np, "save", save)
    return gate


def test_async_files_equal_blocking_and_the_reference(tmp_path):
    from repro.checkpoint import checkpointer as ref_ckpt
    tree = make_tree()
    checkpointer.save(str(tmp_path / "block"), 3, tree)
    pending = checkpointer.save(str(tmp_path / "async"), 3, tree,
                                blocking=False)
    assert isinstance(pending, checkpointer.PendingSave)
    assert pending.pinned_bytes == 0        # nothing on a card
    pending.join()
    assert not pending.is_alive()
    assert_same_files(tmp_path / "block" / "step_00000003",
                      tmp_path / "async" / "step_00000003")
    assert checkpointer.latest_step(str(tmp_path / "async")) == 3

    ref_ckpt.save(str(tmp_path / "ref"), 3, reference_tree(tree),
                  blocking=False).join()
    port_d = tmp_path / "async" / "step_00000003"
    ref_d = tmp_path / "ref" / "step_00000003"
    assert files_of(port_d) == files_of(ref_d)
    manifest = json.loads((port_d / "manifest.json").read_text())
    assert manifest == json.loads((ref_d / "manifest.json").read_text())
    dtypes = {m["path"]: m["dtype"] for m in manifest["leaves"]}
    assert dtypes["half"] == "bfloat16" and dtypes["table"] == "float32"
    for m in manifest["leaves"]:
        a, r = np.load(port_d / m["file"]), np.load(ref_d / m["file"])
        assert a.dtype == r.dtype and np.array_equal(a, r), m["path"]
    assert_restored_equal(str(tmp_path / "async"), 3, tree,
                          snapshot_values(tree))


def test_update_after_save_does_not_reach_the_checkpoint(tmp_path,
                                                          gated_writes):
    tree = make_tree()
    want = snapshot_values(tree)
    pending = checkpointer.save(str(tmp_path), 1, tree, blocking=False)
    assert pending.is_alive()               # held at its first file
    for leaf in checkpointer.leaves(tree):
        for t in (leaf.slabs if isinstance(leaf, RowBlocks) else [leaf]):
            if isinstance(t, torch.Tensor):
                t.add_(1)
            elif isinstance(t, np.ndarray) and t.ndim:
                t += 1
    gated_writes.set()
    pending.join()
    assert_restored_equal(str(tmp_path), 1, make_tree(), want)


def test_run_writes_the_same_checkpoints_async_and_blocking(tmp_path):
    from test_torch_train import _pna_setup

    from repro.runtime import train_loop as ref_loop
    (ref_step, ref_state, ref_b), _ = _pna_setup(steps=6)
    lcfg = dict(total_steps=6, ckpt_every=2, log_every=1)
    _, _, ref_hist, _ = ref_loop.run(
        ref_step, ref_state, lambda s: ref_b,
        ref_loop.TrainLoopConfig(ckpt_dir=str(tmp_path / "ref"), **lcfg))
    losses = {}
    for flag in (False, True):
        _, (step, state, b) = _pna_setup(steps=6)
        _, n, hist, _ = train_loop.run(
            step, state, lambda s: b,
            train_loop.TrainLoopConfig(ckpt_dir=str(tmp_path / str(flag)),
                                       async_checkpoint=flag, **lcfg))
        assert n == 6
        losses[flag] = [h["loss"] for h in hist]
        np.testing.assert_allclose(losses[flag],
                                   [h["loss"] for h in ref_hist], rtol=1e-4)
    assert losses[True] == losses[False]
    for s in (2, 4, 6):
        name = f"step_{s:08d}"
        assert_same_files(tmp_path / "False" / name, tmp_path / "True" / name)
    assert files_of(tmp_path / "True") == files_of(tmp_path / "ref")


def test_a_failing_writer_raises_from_join_and_from_run(tmp_path,
                                                        monkeypatch):
    real = np.save

    def save(path, arr, *a, **k):
        if threading.current_thread() is not threading.main_thread():
            raise OSError("disk full")
        return real(path, arr, *a, **k)
    monkeypatch.setattr(checkpointer.np, "save", save)
    pending = checkpointer.save(str(tmp_path / "a"), 1, make_tree(),
                                blocking=False)
    for _ in range(2):                      # on every call
        with pytest.raises(OSError, match="disk full"):
            pending.join()
    assert checkpointer.latest_step(str(tmp_path / "a")) is None

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(OSError, match="disk full"):
        train_loop.run(
            lambda st, b: ({"w": st["w"] + 1}, None), {"w": torch.zeros(2)},
            lambda s: s,
            train_loop.TrainLoopConfig(total_steps=4, ckpt_every=2,
                                       ckpt_dir=str(tmp_path / "b")))
    assert signal.getsignal(signal.SIGTERM) is before
    # The run stopped at the next save's join (step 4); its final, blocking
    # save was written all the same.
    assert checkpointer.latest_step(str(tmp_path / "b")) == 4
    back = checkpointer.restore(str(tmp_path / "b"), 4,
                                {"w": torch.zeros(2)})
    assert torch.equal(back["w"], torch.full((2,), 4.0))


def test_sigterm_while_a_save_is_pending_leaves_a_final_checkpoint(
        tmp_path, gated_writes):
    seen = []

    def step_fn(state, batch):
        state["w"].add_(1)                  # in place, as AdamW updates
        if batch == 2:
            seen.extend(t.name for t in threading.enumerate()
                        if t.name.startswith("checkpoint-"))
            os.kill(os.getpid(), signal.SIGTERM)
            threading.Timer(0.2, gated_writes.set).start()
        return state, {"loss": torch.tensor(0.5)}

    state, n, _, _ = train_loop.run(
        step_fn, {"w": torch.zeros(3)}, lambda s: s,
        train_loop.TrainLoopConfig(total_steps=10, ckpt_every=2,
                                   ckpt_dir=str(tmp_path), log_every=1))
    assert n == 3 and seen == ["checkpoint-2"]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    for s in (2, 3):
        back = checkpointer.restore(str(tmp_path), s, {"w": torch.zeros(3)})
        assert torch.equal(back["w"], torch.full((3,), float(s)))


@pytest.mark.gpu
def test_snapshot_on_the_card_keeps_the_old_bits(tmp_path):
    """A snapshot on the card, then in-place updates issued on the same
    stream right after ``save`` returns: the files hold the old bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    big = torch.randn(4096, 8192, device=dev, generator=g)   # 128 MiB
    tree = {"big": big, "t": big[:256, :512].t(),
            "half": torch.randn(512, 64, device=dev,
                                generator=g).to(torch.bfloat16),
            "table": RowBlocks(torch.randn(64, 16, device=dev,
                                           generator=g).split(32), 2),
            "cpu": torch.arange(5.0)}
    want = snapshot_values(tree)
    pending = checkpointer.save(str(tmp_path), 7, tree, blocking=False)
    for _ in range(4):
        big.mul_(-1.5).add_(1)
    tree["half"].add_(1)
    for s in tree["table"].slabs:
        s.add_(1)
    tree["cpu"].add_(1)
    pending.join()
    assert pending.pinned_bytes == sum(
        x.numel() * x.element_size() for x in
        (big, tree["t"], tree["half"], *tree["table"].slabs))
    back = checkpointer.restore(str(tmp_path), 7, tree,
                                {"big": CPU, "t": CPU, "half": CPU,
                                 "table": None, "cpu": CPU})
    for got, w in zip(checkpointer.leaves(back), want):
        got = got.whole(CPU) if isinstance(got, RowBlocks) else got
        assert torch.equal(got.cpu(), w)
