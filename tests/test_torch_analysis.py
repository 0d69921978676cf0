"""The static verifier (``repro_torch.analysis``) against the reference's
(``repro.analysis``), and the walk path against its wall clock.

Everything compared with the reference is an int, a string or a tuple of
them, so every comparison is exact: the salt registry, ``task_bits``'
words, the lowered phase programs and their derived facts, the draw
streams, the generated tables (text), and the findings both packages'
passes give on the same mutated inputs.  The port's own checks follow:
the package is clean, every fixture trips, the CUDA audit names the file
and line of a broken constant or call, the lint flags the wall clock and
ambient RNG outside the modules it allows, and walks and stats do not
change when the timers' clock returns random values.
"""
import dataclasses
import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO, SRC, hypothesis_or_stubs
from repro.analysis import residency as ref_residency
from repro.analysis import rng_collisions as ref_rngc
from repro.analysis import tables as ref_tables
from repro.core import corpus_ring as ref_corpus
from repro.core import phase_program as ref_pp
from repro.core import rng as ref_rng
from repro.core import walk_engine as ref_engine
from repro.core.samplers import KINDS as REF_KINDS
from repro_torch import walker
from repro_torch.analysis import (Finding, determinism, residency,
                                  rng_collisions, run_all, tables)
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.fixtures import FIXTURES, run_fixture
from repro_torch.core import clock
from repro_torch.core import corpus_ring, phase_program, walk_engine
from repro_torch.core import rng as port_rng
from repro_torch.core.phase_program import DrawStream, _default_spec, lower
from repro_torch.core.rng import SALTS, SaltRegistry
from repro_torch.core.samplers import KINDS
from repro_torch.graph import make_dataset

given, settings, st = hypothesis_or_stubs()

PKG = pathlib.Path(SRC) / "repro_torch"
WALK_COMMON = "repro_torch/kernels/csrc/walk_common.cuh"
FUSED_CU = "repro_torch/kernels/fused_superstep/csrc/fused_superstep.cu"


def _phase_facts(prog):
    return ([dataclasses.astuple(p) for p in prog.phases], prog.loop,
            prog.carry, prog.requires, prog.schedule, prog.capability,
            prog.fused, prog.cache_payloads)


def _tuples(findings):
    return sorted(tuple(f) for f in findings)


# ------------------------------------------------------ registry and RNG


def test_salts_equal_reference():
    port = [(c.name, c.value, c.family) for c in SALTS.channels()]
    ref = [(c.name, c.value, c.family) for c in ref_rng.SALTS.channels()]
    assert port == ref and len(port) == 6
    for ch in SALTS.channels():   # the module constants are the registry's
        assert getattr(port_rng, ch.name) == ch.value


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("epoch", [None, 0, 3])
@pytest.mark.parametrize("salt", [0, 2, 8, 11])
@pytest.mark.parametrize("num", [1, 5])
def test_task_bits_bit_equal(seed, epoch, salt, num):
    rng = np.random.default_rng([seed, salt, num])
    W = 41
    qid = rng.integers(0, 5000, W).astype(np.int32)
    qid[::7] = -1                       # idle lanes carry query id -1
    hop = rng.integers(0, 80, W).astype(np.int32)
    ep = None if epoch is None else np.full(W, epoch, np.int32)
    ref = np.asarray(ref_rng.task_bits(
        ref_rng.stream_key(seed), jnp.asarray(qid), jnp.asarray(hop), num,
        salt, epoch=None if ep is None else jnp.asarray(ep)))
    port = port_rng.task_bits(
        port_rng.stream_key(seed), torch.from_numpy(qid),
        torch.from_numpy(hop), num, salt,
        epoch=None if ep is None else torch.from_numpy(ep))
    assert port.dtype == torch.int64 and port.shape == (W, num)
    words = port.numpy()
    assert ((words >= 0) & (words < 2**32)).all()
    assert np.array_equal(words.astype(np.uint32), ref.astype(np.uint32))


def test_registry_rejects_duplicate_scalar():
    reg = SaltRegistry()
    reg.register("A", 0)
    with pytest.raises(ValueError):
        reg.register("B", 0)


def test_registry_rejects_scalar_inside_family():
    reg = SaltRegistry()
    reg.register("FAM", 8, family=True)
    with pytest.raises(ValueError):
        reg.register("S", 12)
    reg.register("OK", 3)  # below the family base is fine


def test_registry_rejects_second_family():
    reg = SaltRegistry()
    reg.register("FAM", 8, family=True)
    with pytest.raises(ValueError):
        reg.register("FAM2", 100, family=True)


# ------------------------------------------- programs, streams and tables


def test_kinds_equal_reference():
    assert KINDS == REF_KINDS == phase_program.KINDS


@pytest.mark.parametrize("kind", KINDS)
def test_program_equals_reference(kind):
    port = lower(_default_spec(kind))
    ref = ref_pp.lower(ref_pp._default_spec(kind))
    assert _phase_facts(port) == _phase_facts(ref)
    assert port.cuda == ref.pallas and port.fused is True


@pytest.mark.parametrize("kind", KINDS)
def test_draw_streams_equal_reference(kind):
    port = lower(_default_spec(kind))
    ref = ref_pp.lower(ref_pp._default_spec(kind))
    assert port.draw_streams() == ref.draw_streams()
    assert rng_collisions.spec_streams(_default_spec(kind)) == \
        ref_rngc.spec_streams(ref_pp._default_spec(kind))
    assert port.draw_streams()[0].salt_span() == \
        ref.draw_streams()[0].salt_span()


def test_engine_and_corpus_streams_equal_reference():
    assert walk_engine.ENGINE_DRAW_STREAMS == ref_engine.ENGINE_DRAW_STREAMS
    assert corpus_ring.CORPUS_DRAW_STREAMS == ref_corpus.CORPUS_DRAW_STREAMS


def test_support_rows_equal_reference():
    for port, ref in zip(phase_program.support_rows(),
                         ref_pp.support_rows()):
        assert port["cuda"] == ref["pallas"]
        for key in ("kind", "label", "fused", "capability", "schedule",
                    "carry", "residency", "requires", "cache_payloads"):
            assert port[key] == ref[key], key
    assert phase_program.fused_kinds() == ref_pp.fused_kinds()


def test_tables_equal_reference():
    assert phase_program.render_schedule_table() == \
        ref_pp.render_schedule_table()
    assert tables.render_salt_table() == ref_tables.render_salt_table()
    assert tables.render_stream_table() == ref_tables.render_stream_table()
    doc = (pathlib.Path(REPO) / "docs" / "architecture.md").read_text()
    for line in tables.render_table().splitlines():
        assert not line or line in doc, line


def test_all_names_cover_reference():
    assert set(ref_pp.__all__) <= set(phase_program.__all__)
    for name in ref_pp.__all__:
        assert hasattr(phase_program, name), name


def _mutated_stream_sets():
    """(port streams, reference streams) pairs: each kind's streams plus
    one more at every salt 0..11, scalar and family."""
    for kind in KINDS:
        port = rng_collisions.spec_streams(_default_spec(kind))
        ref = ref_rngc.spec_streams(ref_pp._default_spec(kind))
        for salt in range(12):
            for family in (False, True):
                extra = ("fixture.extra", salt, 3, family)
                yield (kind, port + (DrawStream(*extra),),
                       ref + (ref_pp.DrawStream(*extra),))


def test_check_streams_same_findings_as_reference():
    tripped = 0
    for kind, port, ref in _mutated_stream_sets():
        got = _tuples(rng_collisions.check_streams(port, context=kind))
        assert got == _tuples(ref_rngc.check_streams(ref, context=kind))
        tripped += bool(got)
    assert tripped > 0
    assert rng_collisions.check_kinds() == ref_rngc.check_kinds() == []


def _program_mutations(prog):
    """Each phase moved to the other residency; each carry; loop flipped;
    requires dropped."""
    for i, ph in enumerate(prog.phases):
        other = "v_curr" if ph.residency == "v_prev" else "v_prev"
        phases = list(prog.phases)
        phases[i] = dataclasses.replace(ph, residency=other)
        yield dataclasses.replace(prog, phases=tuple(phases))
    for carry in ("none", "candidates", "reservoir"):
        yield dataclasses.replace(prog, carry=carry)
    yield dataclasses.replace(prog, loop=not prog.loop)
    yield dataclasses.replace(prog, requires=())


@pytest.mark.parametrize("kind", KINDS)
def test_check_program_same_findings_as_reference(kind):
    port = list(_program_mutations(lower(_default_spec(kind))))
    ref = list(_program_mutations(ref_pp.lower(ref_pp._default_spec(kind))))
    assert len(port) == len(ref)
    tripped = 0
    for p, r in zip(port, ref):
        got = _tuples(residency.check_program(p))
        assert got == _tuples(ref_residency.check_program(r))
        tripped += bool(got)
    assert tripped > 0


# ----------------------------------------------------- the port's passes


def test_run_all_clean():
    assert run_all() == []


def test_run_all_runs_four_passes(monkeypatch):
    """Each pass's ``check_repo`` reaches ``run_all``'s findings, the dma
    pass's among them."""
    from repro_torch.analysis import dma_hazards
    passes = (rng_collisions, dma_hazards, residency, determinism)
    for mod in passes:
        monkeypatch.setattr(mod, "check_repo", lambda mod=mod: [
            Finding(mod.__name__.rsplit(".", 1)[-1], "site", "msg")])
    assert [f.pass_name for f in run_all()] == [
        "rng_collisions", "dma_hazards", "residency", "determinism"]


# The hazard class of a dma finding, read from its message.
_DMA_CLASSES = ("read-before-arrival", "overwrite-while-in-flight",
                "not in flight there", "never waited", "phantom copy",
                "non-consecutively", "first_visit set on a revisit")


def _dma_classes(findings):
    return sorted({c for f in findings for c in _DMA_CLASSES
                   if c in f.message})


@pytest.mark.parametrize("name", ["dma-missing-wait",
                                  "dma-overwrite-in-flight", "dma-undrained",
                                  "dma-cached-phantom-copy",
                                  "visit-nonconsecutive", "visit-bad-first"])
def test_dma_fixture_caught_as_the_reference_catches_it(name):
    """The port's fixture breaks its own reservoir declaration where the
    reference breaks its walk-step loop; both trip the same hazard
    classes of the dma pass."""
    from repro.analysis import fixtures as ref_fixtures
    got, want = run_fixture(name), ref_fixtures.run_fixture(name)
    assert {f.pass_name for f in got} == {f.pass_name for f in want} == {
        "dma"}
    assert _dma_classes(got) == _dma_classes(want) != []


def test_table_prints_the_schedule_table(capsys):
    assert analysis_main(["--table"]) == 0
    out = capsys.readouterr().out
    assert tables.render_table() in out
    assert tables.render_schedules() in out
    rows = tables.render_schedule_table().splitlines()
    assert rows[0] == "| kernel schedule | buffers | ops | async copies |"
    assert rows[2:] == [
        "| `fused_superstep.reservoir_n2v` | `ckcol`, `ckwgt` | 18 | 6 |",
        "| `fused_superstep.reservoir_n2v.cached` | `cache.col`, "
        "`cache.wgt` | 6 | 0 |"]


def test_check_holds_the_schedule_table_against_the_readme(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """``--check`` finds the schedule lines in README.md's section on the
    port, and reports drift where a line is missing there (the salt and
    stream tables stay checked against docs/architecture.md)."""
    from repro_torch.analysis import __main__ as cli
    readme = (pathlib.Path(REPO) / "README.md").read_text()
    section = cli._port_section(pathlib.Path(REPO) / "README.md")
    for line in tables.render_schedules().splitlines():
        assert not line or line in section, line
    (tmp_path / "docs").mkdir()
    shutil.copy(pathlib.Path(REPO) / "docs" / "architecture.md",
                tmp_path / "docs" / "architecture.md")
    row = tables.render_schedule_table().splitlines()[2]
    (tmp_path / "README.md").write_text(readme.replace(row, ""))
    monkeypatch.setattr(cli, "_ROOT", tmp_path)
    assert analysis_main(["--check"]) == 1
    assert "port section is missing 1" in capsys.readouterr().out
    (tmp_path / "README.md").write_text(readme)
    assert analysis_main(["--check"]) == 0


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_trips(name, capsys):
    findings = run_fixture(name)
    assert findings, f"fixture {name} produced no findings"
    for f in findings:
        assert f.site and f.message   # diagnostics are actionable
    assert analysis_main(["--fixture", name]) == 1
    assert "finding" in capsys.readouterr().out


def test_fixture_list_and_unknown(capsys):
    assert analysis_main(["--list-fixtures"]) == 0
    assert capsys.readouterr().out.split() == list(FIXTURES)
    assert {"cuda-literal-salt", "cuda-salt-mismatch",
            "determinism-kernel-fallback",
            "determinism-torch-random"} <= set(FIXTURES)
    assert analysis_main(["--fixture", "no-such-fixture"]) == 2


def test_phase_program_check_passes(capsys):
    assert phase_program._main(["--check"]) == 0
    assert "docs embeddings up to date" in capsys.readouterr().out


def test_cli_check_passes_without_jax():
    """``python -m repro_torch.analysis --check`` in a fresh process: exit
    0, no finding, and ``jax`` never imported (``-X importtime`` lists
    every module the process imports)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.analysis",
         "--check"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "all invariants hold" in r.stdout
    assert "docs embedding up to date" in r.stdout
    imported = {ln.rsplit("|", 1)[-1].strip()
                for ln in r.stderr.splitlines() if ln.startswith("import")}
    assert "repro_torch.analysis.rng_collisions" in imported
    assert not {m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "repro")}


# ------------------------------------------------------------ CUDA audit


def _copy_kernels(tmp_path):
    root = tmp_path / "repro_torch"
    shutil.copytree(PKG / "kernels", root / "kernels")
    return root


def test_cuda_audit_clean_and_sees_every_fold():
    """The tree is clean, and a literal put in place of the salt of any
    one of the fused kernel's fold_in calls is found at its line."""
    assert rng_collisions.check_cuda_sites() == []
    src = (PKG.parent / FUSED_CU).read_text()
    salts = list(re.finditer(r"walk::kSalt\w+(\s*\+\s*\w+)?\)", src))
    assert len(salts) == src.count("walk::fold_in(") == 6
    for m in salts:
        mutated = src[:m.start()] + "7u)" + src[m.end():]
        call = src.rindex("walk::fold_in(", 0, m.start())
        line = src[:call].count("\n") + 1
        findings = rng_collisions.check_cuda_source(mutated, FUSED_CU)
        assert [f.site for f in findings] == [f"{FUSED_CU}:{line}"]
        assert "literal salt 7u" in findings[0].message


def test_cuda_audit_flags_changed_constant(tmp_path):
    root = _copy_kernels(tmp_path)
    header = root.parent / WALK_COMMON
    text = header.read_text()
    line = text[:text.index("kSaltStop = 2")].count("\n") + 1
    header.write_text(text.replace("kSaltStop = 2", "kSaltStop = 3"))
    findings = rng_collisions.check_cuda_sites(root)
    assert [f.site for f in findings] == [f"{WALK_COMMON}:{line}"]
    assert "SALT_STOP = 2" in findings[0].message


def test_cuda_audit_flags_literal_and_unregistered(tmp_path):
    root = _copy_kernels(tmp_path)
    cu = root.parent / FUSED_CU
    text = cu.read_text()
    first = text.index("walk::kSaltStop)")
    line = text[:first].count("\n") + 1
    cu.write_text(text[:first] + "2u)" + text[first + 16:])
    header = root.parent / WALK_COMMON
    header.write_text(header.read_text().replace(
        "constexpr uint32_t kSaltStop = 2;",
        "constexpr uint32_t kSaltStop = 2;\nconstexpr uint32_t kSaltExtra "
        "= 5;"))
    sites = {f.site: f.message for f in rng_collisions.check_cuda_sites(root)}
    assert "literal salt 2u" in sites[f"{FUSED_CU}:{line}"]
    assert any(s.startswith(WALK_COMMON) and "SALT_EXTRA" in m
               for s, m in sites.items())


def test_cuda_audit_exempts_task_prefix_only_in_walk_common():
    text = (PKG.parent / WALK_COMMON).read_text()
    assert rng_collisions.check_cuda_source(text, WALK_COMMON) == []
    moved = rng_collisions.check_cuda_source(text, "repro_torch/x/y.cuh")
    assert len(moved) == 3   # the epoch, query id and hop folds


# ----------------------------------------------------------- determinism


def test_allowed_modules():
    assert determinism._ALLOWED == (
        "core/rng.py", "tune/measure.py", "core/clock.py",
        "kernels/tuning/gather_variants.py")


@pytest.mark.parametrize("sub", ["core", "kernels", "walker", "tune"])
def test_lint_flags_clock_and_rng_outside_allowed(sub):
    """Appending a clock read and each kind of ambient draw to any module
    of the linted tree trips the lint, but in the allowed modules."""
    injected = ("\nimport time\nimport numpy as np\nimport torch\n"
                "_T = time.perf_counter()\n"
                "_A = np.random.default_rng(0)\n"
                "_B = torch.randn(3)\n"
                "_C = torch.empty(3).uniform_()\n")
    for py in sorted((PKG / sub).rglob("*.py")):
        rel = str(py.relative_to(PKG.parent))
        findings = determinism.check_source(py.read_text() + injected, rel)
        allowed = any(rel.endswith(a) for a in determinism._ALLOWED)
        n = len(py.read_text().splitlines())
        late = [f for f in findings if int(f.site.rsplit(":", 1)[1]) > n]
        assert len(late) == (0 if allowed else 4), (rel, late)


def test_ops_rule_holds_and_trips():
    ops = sorted((PKG / "kernels").glob("*/ops.py"))
    assert len(ops) == 4
    for py in ops:
        rel = str(py.relative_to(PKG.parent))
        src = py.read_text()
        assert determinism.check_ops_module(src, rel) == []
        loader = determinism.check_ops_module(
            src.replace("build.load(", "ctypes.CDLL("), rel)
        assert any("build.load" in f.message for f in loader), rel
        uncond = determinism.check_ops_module(
            src.replace('== "cpu"', '== "cuda"'), rel)
        assert any("outside a branch" in f.message for f in uncond), rel


# --------------------------------------------------- property tests


@given(salt=st.integers(min_value=0, max_value=7),
       w1=st.integers(min_value=1, max_value=64),
       w2=st.integers(min_value=1, max_value=64))
@settings(max_examples=30, deadline=None)
def test_any_duplicate_salt_collides(salt, w1, w2):
    streams = (DrawStream("a", salt, w1), DrawStream("b", salt, w2))
    findings = rng_collisions.check_streams(streams)
    assert findings and findings[0].pass_name == "rng"
    assert f"[0, {min(w1, w2)})" in findings[0].message


@given(offset=st.integers(min_value=0, max_value=100))
@settings(max_examples=30, deadline=None)
def test_any_scalar_inside_chunk_family_collides(offset):
    fam = DrawStream("fam", 8, 64, family=True)
    scalar = DrawStream("scalar", 8 + offset, 1)
    assert rng_collisions.check_streams((fam, scalar))


@given(kind=st.sampled_from(["uniform", "alias", "metapath"]))
@settings(max_examples=10, deadline=None)
def test_moving_phase_to_vprev_is_caught(kind):
    prog = lower(_default_spec(kind))
    idx = next(i for i, p in enumerate(prog.phases)
               if p.op in ("draw", "gather"))
    phases = list(prog.phases)
    phases[idx] = dataclasses.replace(phases[idx], residency="v_prev")
    mutated = dataclasses.replace(prog, phases=tuple(phases))
    findings = residency.check_program(mutated)
    assert any("v_prev" in f.message for f in findings)


# ------------------------------------------- the clock leaks nothing


@pytest.fixture(scope="module")
def graph():
    return make_dataset("WG", scale_override=9, device="cpu")


def _closed(program, impl, graph):
    w = walker.compile(program, execution=walker.ExecutionConfig(
        num_slots=32, step_impl=impl, hops_per_launch=4))
    res = w.run(graph, range(200), seed=3)
    return res, w.last_drain


def _same(a, b):
    return (torch.equal(a.paths, b.paths)
            and torch.equal(a.lengths, b.lengths)
            and tuple(int(x) for x in a.stats)
            == tuple(int(x) for x in b.stats))


@pytest.mark.parametrize("impl", ["torch", "fused"])
@pytest.mark.parametrize("program", ["urw", "ppr"])
def test_clock_leaks_nothing_closed(program, impl, graph, monkeypatch):
    prog = (walker.WalkProgram.urw(12) if program == "urw"
            else walker.WalkProgram.ppr(0.15, 12))
    plain, drain = _closed(prog, impl, graph)
    rng = np.random.default_rng(1)
    reads = []
    monkeypatch.setattr(clock, "now",
                        lambda: reads.append(1) or rng.uniform(-1e6, 1e6))
    patched, patched_drain = _closed(prog, impl, graph)
    assert reads and patched_drain != drain
    assert _same(plain, patched)


def _soak(stream, starts, chunk=3):
    """Inject as slots free, advance, harvest and release every finished
    slot until all arrivals are done; the harvest keyed by (epoch, qid)."""
    pending, out = list(starts), {}
    while pending or stream.num_live:
        n = min(stream.num_free, len(pending), 12)
        if n:
            stream.inject(pending[:n])
            pending = pending[n:]
        stream.advance(chunk)
        done = np.flatnonzero(stream.done_live_mask())
        if done.size:
            paths, lengths = stream.harvest_ids(done)
            for q, e, p, ln in zip(done, stream.epoch_of(done), paths,
                                   lengths):
                out[int(e), int(q)] = (p.tolist(), int(ln))
            stream.release(done)
    return out, tuple(int(x) for x in stream.walk_stats())


@pytest.mark.parametrize("backend,impl", [("single", "torch"),
                                          ("single", "fused"),
                                          ("sharded", "torch")])
def test_clock_leaks_nothing_stream(backend, impl, graph, monkeypatch):
    execution = (walker.ExecutionConfig(num_slots=16, step_impl=impl,
                                        hops_per_launch=4)
                 if backend == "single" else walker.ExecutionConfig(
                     num_devices=2, slots_per_device=8))
    w = walker.compile(walker.WalkProgram.ppr(0.15, 10), backend=backend,
                       execution=execution)
    starts = np.random.default_rng(5).integers(0, graph.num_vertices, 90)
    s = w.stream(graph, capacity=32, seed=4)
    plain = _soak(s, starts)
    rng = np.random.default_rng(2)
    monkeypatch.setattr(clock, "now", lambda: float(rng.uniform(-9, 9)))
    s2 = w.stream(graph, capacity=32, seed=4)
    patched = _soak(s2, starts)
    assert s2.host_read_s != s.host_read_s
    assert len(plain[0]) == len(starts) and plain == patched
