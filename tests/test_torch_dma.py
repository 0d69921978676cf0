"""The DMA-schedule IR (``repro_torch.kernels.common``) and the DMA hazard
pass (``repro_torch.analysis.dma_hazards``) against the reference's
(``repro.kernels.common``, ``repro.analysis.dma_hazards``), and the fused
kernel's declared reservoir schedule (``kernels/fused_superstep/
schedule.py``).

Everything compared is strings, ints and bools, so every comparison is
exact.  A reference ``DmaOp`` becomes the port's by its fields
(:func:`_port`); the findings of both passes are compared as tuples, in
order.  The op sequences: the emitters' patterns, the reference's 14
declared kernel schedules with every one-op deletion and every swap of
adjacent ops, the inputs of the reference's six ``dma``/``visit``
fixtures, and random sequences over all op kinds (numpy-seeded here, and
hypothesis-drawn where hypothesis is installed).
"""
import numpy as np
import pytest
import torch

from conftest import hypothesis_or_stubs
from repro.analysis import dma_hazards as ref_dma
from repro.analysis import fixtures as ref_fixtures
from repro.kernels import common as ref_common
from repro_torch.analysis import dma_hazards
from repro_torch.core import walk_engine
from repro_torch.core.walk_engine import EngineConfig
from repro_torch.graph import make_dataset
from repro_torch.kernels import common
from repro_torch.kernels.fused_superstep import ops as fused_ops
from repro_torch.kernels.fused_superstep import schedule
from repro_torch.walker import WalkProgram

given, settings, st = hypothesis_or_stubs()

REF_SCHEDULES = ref_dma.kernel_schedules()
DMA_FIXTURES = ("dma-missing-wait", "dma-overwrite-in-flight",
                "dma-undrained", "dma-cached-phantom-copy",
                "visit-nonconsecutive", "visit-bad-first")
KINDS = ("start", "wait", "read", "write", "visit", "bogus")
BUFFERS = ("a", "b", "cache.c")


def _port(ops):
    """The reference's ops as the port's, field by field."""
    return [common.DmaOp(**op._asdict()) for op in ops]


def _same_findings(ref_ops, name="kernel"):
    """Both passes on the same ops; returns the port's findings."""
    got = dma_hazards.check_schedule(_port(ref_ops), name)
    want = ref_dma.check_schedule(list(ref_ops), name)
    assert [tuple(f) for f in got] == [tuple(f) for f in want]
    return got


# ------------------------------------------------------------------ the IR


def test_dmaop_fields_and_defaults_equal_reference():
    assert common.DmaOp._fields == ref_common.DmaOp._fields
    assert common.DmaOp._field_defaults == ref_common.DmaOp._field_defaults


def _emit(mod, pattern, n):
    b = mod.ScheduleBuilder()
    if pattern == "gather":
        b.gather_loop("buf", n)
    elif pattern == "pingpong":
        b.pingpong_loop(("col", "wgt"), n)
    elif pattern == "pingpong_x2":
        b.pingpong_loop(("col",), n, reads_per_chunk=2)
    elif pattern == "writeback":
        b.writeback_loop("wbuf", n)
    else:   # the primitives, in one sequence
        cid = b.start("x", 1)
        b.wait("x", 1, cid)
        b.read("x", 1)
        b.cache_read("cache.col")
        b.write("y", 0)
        for i in range(n):
            b.visit("out", i // 2, first=i % 2 == 0, live=i % 3 != 2)
    return b.ops


@pytest.mark.parametrize("n", range(7))
@pytest.mark.parametrize("pattern", ["gather", "pingpong", "pingpong_x2",
                                     "writeback", "primitives"])
def test_builder_patterns_equal_reference(pattern, n):
    got = _emit(common, pattern, n)
    assert got == _port(_emit(ref_common, pattern, n))
    assert common.schedule_buffers(got) == ref_common.schedule_buffers(
        _emit(ref_common, pattern, n))


# ---------------------------------------------------------- the hazard pass


@pytest.mark.parametrize("name", sorted(REF_SCHEDULES))
def test_reference_schedules_same_findings(name):
    assert _same_findings(REF_SCHEDULES[name], name) == []


def _mutations(ops):
    """Every one-op deletion and every swap of two adjacent ops."""
    for i in range(len(ops)):
        yield ops[:i] + ops[i + 1:]
    for i in range(len(ops) - 1):
        yield ops[:i] + [ops[i + 1], ops[i]] + ops[i + 2:]


@pytest.mark.parametrize("name", sorted(REF_SCHEDULES))
def test_mutated_reference_schedules_same_findings(name):
    ops = list(REF_SCHEDULES[name])
    tripped = sum(bool(_same_findings(m, name)) for m in _mutations(ops))
    assert tripped > 0


@pytest.mark.parametrize("fixture", DMA_FIXTURES)
def test_reference_fixture_inputs_same_findings(fixture, monkeypatch):
    """The ops each reference fixture hands its pass (caught by a spy on
    the reference's ``check_schedule``) give the same findings here."""
    seen, check = [], ref_dma.check_schedule

    def spy(ops, name="kernel"):
        seen.append((list(ops), name))
        return check(ops, name)
    monkeypatch.setattr(ref_fixtures.dma_hazards, "check_schedule", spy)
    assert ref_fixtures.run_fixture(fixture)
    ((ops, name),) = seen
    assert _same_findings(ops, name)


def _random_ops(rng, n):
    ops = []
    for _ in range(n):
        kind = KINDS[rng.integers(len(KINDS))]
        ops.append(ref_common.DmaOp(
            kind, BUFFERS[rng.integers(len(BUFFERS))], int(rng.integers(2)),
            copy=int(rng.integers(-1, 4)), first=bool(rng.integers(2)),
            live=bool(rng.integers(2)),
            tier=("hbm", "vmem")[int(rng.random() < 0.2)]))
    return ops


@pytest.mark.parametrize("seed", range(8))
def test_random_sequences_same_findings(seed):
    rng = np.random.default_rng(seed)
    tripped = 0
    for _ in range(250):
        tripped += bool(_same_findings(_random_ops(rng, int(rng.integers(
            0, 16)))))
    assert tripped > 0


_op = st.builds(
    ref_common.DmaOp, st.sampled_from(KINDS), st.sampled_from(BUFFERS),
    st.integers(0, 1), copy=st.integers(-1, 4), first=st.booleans(),
    live=st.booleans(), tier=st.sampled_from(["hbm", "vmem"]))


@settings(max_examples=300, deadline=None)
@given(st.lists(_op, max_size=16))
def test_drawn_sequences_same_findings(ops):
    _same_findings(ops)


def test_check_repo_is_clean_and_names_the_reservoir():
    assert dma_hazards.check_repo() == []
    assert list(dma_hazards.kernel_schedules()) == [
        "fused_superstep.reservoir_n2v",
        "fused_superstep.reservoir_n2v.cached"]


# ------------------------------------------- the port's declared schedule


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("chunks", range(6))
def test_reservoir_schedule_is_hazard_free(chunks, weighted, cached):
    ops = schedule.dma_schedule("reservoir_n2v", chunks=chunks,
                                cached=cached, weighted=weighted)
    assert dma_hazards.check_schedule(ops, "reservoir") == []
    bufs = (("cache.col", "cache.wgt") if cached else ("ckcol", "ckwgt"))
    assert common.schedule_buffers(ops) == (bufs if weighted
                                            else bufs[:1])[:len(ops)]
    reads = sum(op.kind == "read" for op in ops)
    starts = sum(op.kind == "start" for op in ops)
    assert reads == chunks * (2 if weighted else 1)
    assert starts == (0 if cached else reads)
    assert all(op.tier == ("vmem" if cached else "hbm") for op in ops)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("chunks", range(1, 6))
def test_reservoir_schedule_defects_are_caught(chunks, weighted):
    """Dropping any wait, or moving any read to just before its wait, is
    a finding."""
    ops = schedule.dma_schedule("reservoir_n2v", chunks=chunks,
                                weighted=weighted)
    for i, op in enumerate(ops):
        if op.kind == "wait":
            assert dma_hazards.check_schedule(ops[:i] + ops[i + 1:])
    for i, op in enumerate(ops):
        if op.kind != "read":
            continue
        w = max(j for j in range(i) if ops[j].kind == "wait"
                and ops[j].buffer == op.buffer and ops[j].slot == op.slot)
        moved = ops[:w] + [op] + ops[w:i] + ops[i + 1:]
        assert dma_hazards.check_schedule(moved)


@pytest.mark.parametrize("kind", ["uniform", "alias", "metapath",
                                  "rejection_n2v"])
def test_other_fused_kinds_stage_nothing(kind):
    assert schedule.dma_schedule(kind) == []
    assert schedule.dma_schedule(kind, cached=True) == []


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        schedule.dma_schedule("ppr")


def _encode(ops, cap, items, windows):
    """A trace buffer as the kernel writes it, holding ``ops``."""
    names = [b for b, _ in schedule.TRACE_BUFFERS]
    words = np.zeros(schedule.TRACE_HEADER + 4 * cap, np.int32)
    words[schedule.TRACE_CAP] = cap
    words[schedule.TRACE_RECORDS] = len(ops)
    words[schedule.TRACE_ITEMS] = items
    words[schedule.TRACE_WINDOWS] = windows
    for r, op in enumerate(ops[:cap]):
        words[schedule.TRACE_HEADER + 4 * r:][:4] = (
            schedule.TRACE_KINDS.index(op.kind), names.index(op.buffer),
            op.slot, op.copy)
    return words


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
def test_trace_decodes_to_the_declaration(cached, weighted):
    ops = schedule.dma_schedule("reservoir_n2v", chunks=5, cached=cached,
                                weighted=weighted)
    trace = schedule.decode_trace(_encode(ops, 64, 5, 5))
    assert trace == schedule.ScheduleTrace(ops, 5, 5)
    with pytest.raises(ValueError):
        schedule.decode_trace(_encode(ops, len(ops) - 1, 5, 5))


def test_trace_schedule_refuses_a_cpu_state_and_other_kinds():
    """The plain version stages nothing, so a trace is the card's; and
    only the reservoir kind stages."""
    g = make_dataset("WG", weighted=True, scale_override=8, device="cpu")
    cfg = EngineConfig(num_slots=16, max_hops=4, step_impl="fused")
    depth = walk_engine._stage_depth(cfg)
    for prog in (WalkProgram.node2vec(2.0, 0.5, 4, weighted=True),
                 WalkProgram.urw(4)):
        state, block = fused_ops.pack(walk_engine.init_state(
            cfg, depth, torch.arange(16, dtype=torch.int32)))
        with pytest.raises(ValueError):
            fused_ops.trace_schedule(g, prog.spec, cfg, depth, state, (3, 4),
                                     1, block)
