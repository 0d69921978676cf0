"""The port's examples, run on the CPU at a tiny size.

``examples/torch_train_deepwalk_embeddings.py`` is run as a script (a
subprocess, as a user runs it) overlapped and serial, and called in
process, where its two modes must give the same tables bit for bit.  No
example of the port imports JAX or the reference.
"""
import ast
import os
import pathlib
import runpy
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "torch_train_deepwalk_embeddings.py"
TINY = ["--device", "cpu", "--scale", "8", "--dim", "8", "--rounds", "3",
        "--steps-per-round", "4", "--walks-per-round", "32",
        "--walk-len", "8", "--batch", "32"]


def test_port_examples_import_neither_jax_nor_the_reference():
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert EXAMPLE in examples
    for path in examples:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "repro"), (path, name)


@pytest.mark.parametrize("mode", [[], ["--serial"]])
def test_deepwalk_example_runs_as_a_script(mode):
    r = subprocess.run([sys.executable, str(EXAMPLE), *TINY, *mode],
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr
    label = "serial" if mode else "overlapped"
    assert f"{label}: 96 walks → 12 grad steps" in r.stdout
    round_trips = "path host round-trips: " + ("15" if mode else "0")
    assert round_trips in r.stdout
    assert "tables: in_embed(256, 8)" in r.stdout


def test_deepwalk_example_modes_train_the_same_tables(tmp_path):
    main = runpy.run_path(str(EXAMPLE))["main"]
    over = main(TINY + ["--ckpt-dir", str(tmp_path / "ckpt")])
    ser = main(TINY + ["--serial"])
    for k in ("in_embed", "out_embed"):
        assert torch.equal(over["params"][k], ser["params"][k])
    assert all(torch.equal(a, b) for a, b in zip(over["ring"], ser["ring"]))


def test_every_reference_example_has_a_port_counterpart():
    ref = {p.name for p in (REPO / "examples").glob("*.py")
           if not p.name.startswith("torch_")}
    port = {p.name.removeprefix("torch_")
            for p in (REPO / "examples").glob("torch_*.py")}
    assert ref and ref <= port, sorted(ref - port)
