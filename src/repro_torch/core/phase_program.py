"""Sampler phase-program IR: one declarative sampler definition that the
engine executes.

A :class:`SamplerSpec` lowers once (:func:`lower`) into a
:class:`PhaseProgram` — a short sequence of typed :class:`Phase` records
(``draw`` / ``gather`` / ``score`` / ``commit``) with explicit operand
residency (owner of ``v_curr`` or of ``v_prev``).  The lowering is pure
data and covers every sampler kind; :func:`make_sampler` executes a
program over one superstep's lane pool: the loop-free programs phase by
phase, the looping reservoir program through :func:`reservoir_scan`.

Phase vocabulary
----------------
``draw(width, salt)``
    Consume ``width`` U[0,1) draws from the task's stateless stream.
``gather(segment, width)``
    Materialize candidate operands from the graph: ``csr`` (proposal
    columns), ``typed`` (MetaPath sub-segment bounds), ``alias`` (alias
    table probes), ``chunk`` (one reservoir chunk).
``score(reduction)``
    Reduce candidates to a decision: ``pick_uniform``, ``alias_accept``,
    ``first_accept``, ``es_reservoir``.
``commit``
    Column access on the chosen offset + hop advance (engine-owned).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import rng as task_rng
from repro_torch.core.rng import SALT_CHUNK0, SALT_COLUMN
from repro_torch.core.samplers import (SamplerSpec, _uniform_index,
                                       es_chunk_score, es_merge,
                                       es_num_chunks, n2v_bias,
                                       rejection_choose, vertex_row)

__all__ = ["Phase", "PhaseProgram", "lower", "make_sampler",
           "reservoir_scan", "chunk_gather", "chunk_score"]


@dataclasses.dataclass(frozen=True)
class Phase:
    """One typed phase of a hop.

    ``op``        — draw | gather | score | commit.
    ``variant``   — gather segment (csr/typed/alias/chunk) or score
                    reduction (pick_uniform/alias_accept/first_accept/
                    es_reservoir); "" for draw/commit.
    ``residency`` — which vertex's owner holds this phase's operands:
                    "v_curr" or "v_prev".
    ``width``     — per-lane operand fan-out (draws or candidates).
    ``salt``      — rng salt channel for ``draw``.
    """

    op: str
    variant: str = ""
    residency: str = "v_curr"
    width: int = 1
    salt: int = SALT_COLUMN

    @property
    def cacheable(self) -> bool:
        """May this phase's graph operands be served from the hot-vertex
        cache?  True exactly for ``v_curr``-resident ``gather``/``commit``
        phases: their operands are slices of the current vertex's
        adjacency payload, which is what `graph.hot_cache` packs.
        ``v_prev``-resident phases (the rejection verify and the reservoir
        bias/membership probes) address N(v_prev) and always read the
        graph in device memory."""
        return self.op in ("gather", "commit") and self.residency == "v_curr"


@dataclasses.dataclass(frozen=True)
class PhaseProgram:
    """A lowered sampler: the phase list plus the facts the engine
    dispatches on (``loop``: the gather/score pair repeats per reservoir
    chunk; ``carry``: payload threaded between owners; ``requires``: graph
    payloads the program samples from)."""

    kind: str
    phases: Tuple[Phase, ...]
    loop: bool = False
    carry: str = "none"
    requires: Tuple[str, ...] = ()

    @property
    def schedule(self) -> str:
        """Sharded execution schedule implied by the residencies:
        ``single_phase`` (whole hop at owner(v_curr)), ``two_phase``
        (propose at owner(v_curr), verify at owner(v_prev)), or
        ``chunked_loop`` (per-chunk gather/score ping-pong)."""
        if self.loop:
            return "chunked_loop"
        if any(p.residency == "v_prev" for p in self.phases):
            return "two_phase"
        return "single_phase"

    @property
    def capability(self) -> Optional[str]:
        """Sharded capability the program declares (the key
        `core.distributed` allocates the task word and routing schedule
        from); every program declares one."""
        return {"single_phase": "first_order",
                "two_phase": "two_phase",
                "chunked_loop": "chunked_reservoir"}[self.schedule]

    @property
    def cuda(self) -> bool:
        """Covered by the one-hop walk-step CUDA kernels
        (single-residency programs over the plain/alias CSR segments)."""
        return all(p.residency == "v_curr" for p in self.phases) and not (
            self.loop or "typed" in self.requires)

    @property
    def cache_payloads(self) -> Tuple[str, ...]:
        """Adjacency payload arrays the hot-vertex cache must pack for
        this program — read off the cacheable (``v_curr``-resident)
        gather/commit phases, so `graph.hot_cache.build_hot_cache` sizes
        the block from the program, not a hand-kept list.

        Every program needs ``col`` (the commit column access); the
        alias probe adds ``alias_prob``/``alias_idx``, the typed gather
        adds ``type_offsets``, and the reservoir chunk gather adds
        ``weights``.  ``v_prev``-resident phases contribute nothing —
        their operands stay in device memory.
        """
        payloads = ["col"]
        for ph in self.phases:
            if not ph.cacheable or ph.op != "gather":
                continue
            payloads += {"alias": ["alias_prob", "alias_idx"],
                         "typed": ["type_offsets"],
                         "chunk": ["weights"],
                         "csr": []}[ph.variant]
        return tuple(payloads)


@functools.lru_cache(maxsize=None)
def lower(spec: SamplerSpec) -> PhaseProgram:
    """Lower a sampler definition to its phase program (cached — specs
    are frozen and hashable)."""
    k = spec.kind
    if k == "uniform":
        return PhaseProgram(k, (
            Phase("draw", width=1),
            Phase("score", "pick_uniform"),
            Phase("commit"),
        ))
    if k == "alias":
        return PhaseProgram(k, (
            Phase("draw", width=2),
            Phase("gather", "alias"),
            Phase("score", "alias_accept"),
            Phase("commit"),
        ), requires=("alias",))
    if k == "metapath":
        return PhaseProgram(k, (
            Phase("draw", width=1),
            Phase("gather", "typed"),
            Phase("score", "pick_uniform"),
            Phase("commit"),
        ), requires=("typed",))
    if k == "rejection_n2v":
        K = spec.rejection_rounds
        return PhaseProgram(k, (
            Phase("draw", width=2 * K),
            Phase("gather", "csr", width=K),
            Phase("score", "first_accept", residency="v_prev", width=K),
            Phase("commit"),
        ), carry="candidates")
    if k == "reservoir_n2v":
        CH = spec.reservoir_chunk
        return PhaseProgram(k, (
            Phase("draw", width=CH, salt=SALT_CHUNK0),
            Phase("gather", "chunk", width=CH),
            Phase("score", "es_reservoir", residency="v_prev", width=CH),
            Phase("commit"),
        ), loop=True, carry="reservoir", requires=("weights",))
    raise ValueError(f"unknown sampler kind: {k!r}")


class _Ctx:
    """Mutable interpretation state threaded through one hop's phases."""

    __slots__ = ("spec", "g", "addr", "deg", "slots", "base_key", "u",
                 "cand_idx", "cand", "seg_base", "seg_cnt", "index", "ok")

    def __init__(self, spec, g, addr, deg, slots, base_key):
        self.spec, self.g = spec, g
        self.addr, self.deg = addr, deg
        self.slots, self.base_key = slots, base_key
        self.u = None
        self.cand_idx = None     # (W, K) neighbor offsets
        self.cand = None         # (W, K) candidate vertices
        self.seg_base = None     # typed sub-segment base offset
        self.seg_cnt = None      # typed sub-segment length
        self.index = None        # chosen neighbor offset
        self.ok = None           # lane has a valid continuation


def _exec_draw(ph: Phase, ctx: _Ctx):
    s = ctx.slots
    ctx.u = task_rng.task_uniforms(ctx.base_key, s.query_id, s.hop, ph.width,
                                   ph.salt, epoch=s.epoch)


def _exec_gather_alias(ph: Phase, ctx: _Ctx):
    # The alias tables live beside the CSR segment; the score phase probes
    # them directly.
    pass


def _exec_gather_typed(ph: Phase, ctx: _Ctx):
    """MetaPath sub-segment bounds for hop t's scheduled edge type."""
    g, s, spec = ctx.g, ctx.slots, ctx.spec
    sched = torch.tensor(spec.metapath, dtype=torch.int32, device=s.hop.device)
    t = sched[(s.hop % len(spec.metapath)).long()].long()
    row = vertex_row(g, s.v_curr).long()
    base = g.type_offsets[row, t]
    ctx.seg_base = base
    ctx.seg_cnt = g.type_offsets[row, t + 1] - base


def _exec_gather_csr(ph: Phase, ctx: _Ctx):
    """K proposal columns from N(v_curr) (rejection sampling phase A).  A
    graph with no edges has no column to read: every candidate is -1."""
    K, g = ph.width, ctx.g
    ctx.cand_idx = _uniform_index(ctx.deg[:, None], ctx.u[:, :K])
    if g.num_edges == 0:
        ctx.cand = torch.full_like(ctx.cand_idx, -1)
        return
    e = torch.clamp(ctx.addr[:, None] + ctx.cand_idx, 0, g.num_edges - 1)
    ctx.cand = g.col[e.long()]


def _exec_score_pick_uniform(ph: Phase, ctx: _Ctx):
    """index = min(floor(u·n), n-1) over the CSR segment or, when a typed
    gather ran, over the scheduled sub-segment (no match → dead lane)."""
    if ctx.seg_base is not None:
        ctx.index = ctx.seg_base + _uniform_index(ctx.seg_cnt, ctx.u[:, 0])
        ctx.ok = (ctx.seg_cnt > 0) & (ctx.deg > 0)
    else:
        ctx.index = _uniform_index(ctx.deg, ctx.u[:, 0])
        ctx.ok = ctx.deg > 0


def _exec_score_alias_accept(ph: Phase, ctx: _Ctx):
    """Walker alias method: accept the column draw with prob[e], else take
    the alias index — two uniforms, two probes."""
    g = ctx.g
    k = _uniform_index(ctx.deg, ctx.u[:, 0])
    ctx.ok = ctx.deg > 0
    if g.num_edges == 0:  # no table to probe; every lane is a dead end
        ctx.index = k
        return
    e = torch.clamp(ctx.addr + k, 0, g.num_edges - 1).long()
    accept = ctx.u[:, 1] < g.alias_prob[e]
    idx = torch.where(accept, k, g.alias_idx[e])
    ctx.index = torch.minimum(torch.clamp(idx, min=0),
                              torch.clamp(ctx.deg - 1, min=0))


def _exec_score_first_accept(ph: Phase, ctx: _Ctx):
    """Bounded-round rejection: the first proposal whose (p, q) bias
    survives the accept test wins; the last round is forced."""
    K = ph.width
    w = n2v_bias(ctx.spec, ctx.g, ctx.slots.v_prev, ctx.cand)
    first = rejection_choose(ctx.spec, ctx.u[:, K:], w)
    ctx.index = ctx.cand_idx.gather(1, first[:, None])[:, 0]
    ctx.ok = ctx.deg > 0


def _exec_commit(ph: Phase, ctx: _Ctx):
    pass  # column access + hop advance are engine-owned


_EXEC = {
    ("draw", ""): _exec_draw,
    ("gather", "alias"): _exec_gather_alias,
    ("gather", "typed"): _exec_gather_typed,
    ("gather", "csr"): _exec_gather_csr,
    ("score", "pick_uniform"): _exec_score_pick_uniform,
    ("score", "alias_accept"): _exec_score_alias_accept,
    ("score", "first_accept"): _exec_score_first_accept,
    ("commit", ""): _exec_commit,
}


def reservoir_scan(spec: SamplerSpec, g, addr, deg, slots, base_key):
    """The looping (draw, gather-chunk, score-chunk) program: the whole
    Efraimidis–Spirakis reservoir scan of N(v_curr), one chunk of
    ``reservoir_chunk`` candidates per trip, keeping the largest key
    ``log(u)/w'`` over the bias-scaled weights w' (weighted Node2Vec).

    Degree-adaptive scan (``spec.adaptive_chunks`` True): the loop runs
    ``ceil(max(live deg)/chunk)`` trips, read on the host once per
    superstep, instead of ``ceil(max_degree/chunk)``.  Chunks past a
    lane's degree contribute only -inf keys, so paths are the same
    either way.  A Walker resolves ``"auto"`` before building its engine
    (`repro_torch.tune.resolve`, by the skew gate
    `tune.model.adaptive_chunk_gate`); only an engine built directly
    still holds ``"auto"`` here, and reads it as True, as the reference's
    engine does."""
    CH = spec.reservoir_chunk
    n_chunks = es_num_chunks(g.max_degree, CH)
    W = addr.shape[0]
    if spec.adaptive_chunks:
        live_deg = int(torch.where(slots.active, deg, 0).max())
        n_chunks = min(max(-(-live_deg // CH), 1), n_chunks)
    best_key = torch.full((W,), -torch.inf, device=addr.device)
    best_idx = torch.zeros((W,), dtype=torch.int32, device=addr.device)
    for c in range(n_chunks):
        u = task_rng.task_uniforms(base_key, slots.query_id, slots.hop, CH,
                                   SALT_CHUNK0 + c, epoch=slots.epoch)
        y, w_edge = chunk_gather(g, addr, deg, torch.full_like(addr, c), CH)
        w = w_edge * n2v_bias(spec, g, slots.v_prev, y)
        c_best, c_key = es_chunk_score(u, y >= 0, w)
        best_key, best_idx = es_merge(best_key, best_idx, c, CH, c_best,
                                      c_key)
    index = torch.minimum(torch.clamp(best_idx, min=0),
                          torch.clamp(deg - 1, min=0))
    return index, deg > 0


def chunk_gather(g, addr, deg, chunk, width):
    """Chunk ``chunk`` (per lane) of (candidate vertex, edge weight) from
    the CSR segment at ``addr``; positions past the lane's degree carry
    ``(-1, 0.0)``, which the score keys to -inf.  A graph without weights
    weighs every edge 1.0."""
    pos = chunk[:, None] * width + torch.arange(
        width, dtype=torch.int32, device=addr.device)[None, :]
    valid = pos < deg[:, None]
    if g.num_edges == 0:   # every degree is 0: no column to read
        return torch.full_like(pos, -1), torch.zeros(pos.shape,
                                                     device=pos.device)
    e = torch.clamp(addr[:, None] + pos, 0, g.num_edges - 1).long()
    y = torch.where(valid, g.col[e], -1)
    w_edge = g.weights[e] if g.weights is not None else torch.ones(
        pos.shape, device=pos.device)
    return y, torch.where(valid, w_edge, 0.0)


def chunk_score(spec: SamplerSpec, g, slots, chunk, width, base_key):
    """Score one staged chunk at owner(v_prev): E-S keys under the local
    adjacency bias, folded into the carried reservoir maximum — the score
    phase of the chunked-loop program on the sharded engine.  ``chunk`` is
    the lane's chunk index (a tensor), which also salts its draws."""
    u = task_rng.task_uniforms(base_key, slots.query_id, slots.hop, width,
                               SALT_CHUNK0 + chunk, epoch=slots.epoch)
    w = slots.cand_w * n2v_bias(spec, g, slots.v_prev, slots.cand)
    c_best, c_key = es_chunk_score(u, slots.cand >= 0, w)
    return es_merge(slots.best_key, slots.best_idx, chunk, width, c_best,
                    c_key)


def make_sampler(spec: SamplerSpec):
    """Lower ``spec`` for the plain tensor superstep: returns
    ``sample(g, addr, deg, slots, base_key) -> (index, ok)``.

    A looping program runs :func:`reservoir_scan`.
    """
    prog = lower(spec)
    if prog.loop:
        return functools.partial(reservoir_scan, spec)
    execs = [(_EXEC[(p.op, p.variant)], p) for p in prog.phases]

    def sample(g, addr, deg, slots, base_key):
        """Execute the lowered phases over one superstep's lane pool."""
        ctx = _Ctx(spec, g, addr, deg, slots, base_key)
        for fn, ph in execs:
            fn(ph, ctx)
        return ctx.index, ctx.ok

    return sample
