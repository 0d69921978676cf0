"""Sharded walk engine: N asynchronous "pipelines" = N shards (paper §IV:
16 pipelines over 32 HBM channels).

The shards are stacked along a leading axis on the graph's device (the
mesh of `repro_torch.distributed.mesh`).  Per superstep each shard (a)
executes one *phase* of work for every live task homed on it, (b)
terminates finished walks and refills freed lanes from its local query
shard (zero-bubble scheduling), (c) routes every live task to the shard
that owns the data its next phase reads, with one all-to-all (the
butterfly, `router.py`).  All shards step together: every tensor of a
superstep holds every shard's lanes, and each lane reads its shard's part
of the graph through the stacked view (:class:`LocalView`).

One generic superstep serves every sampler through the phase-program IR
(`repro_torch.core.phase_program`): :class:`ProgramCapability` interprets
the lowered program's residency schedule — all-local programs (uniform,
alias, metapath over partitioned ``type_offsets``) execute a whole hop at
owner(v_curr); a score phase resident at owner(v_prev) splits the hop into
a propose/verify superstep pair (rejection Node2Vec); the looping chunk
program ping-pongs reservoir chunks between the two owners (weighted
Node2Vec).  The engine allocates the task word the program's ``carry``
declares (`WalkerSlots` / `N2VSlots` / `ReservoirSlots`) and drives the
same routing path for all.

Because tasks are stateless and their randomness derives from (seed,
query_id, hop), the sharded engine produces *bit-identical walks* to the
single-device engine (§V-A); tests assert this for first- and
second-order walks, and hold the stats and emission logs equal to the
reference's sharded engine.

Losslessness.  Refill is flow-controlled: a shard admits new queries only
up to its fair share of the *global* live-task headroom (a sum over the
shard axis), which bounds live tasks system-wide by N·W_loc; the router's
retention region is provisioned to that bound (`DistConfig.retention_cap`),
so bucket overflow can always be retained and ``drops == 0`` is a
guarantee.

Path write-back uses the paper's streaming-window scheme (§IV-B): each
shard appends (query_id, hop, vertex) records to an emission log on the
device, scattered into per-query paths after the run
(:func:`assemble_paths`).  A record past ``log_capacity`` is counted in
``drops``.

The superstep is plain torch (the reference's is plain ``jnp`` under
``shard_map``): no kernel of its own.  The host drives the loop and reads
the global done flag once per superstep, so the loop stops exactly where
the reference's ``while_loop`` stops.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import clock, rng as task_rng, router
from repro_torch.core.phase_program import (PhaseProgram, chunk_gather,
                                            chunk_score, lower, make_sampler,
                                            reservoir_scan)
from repro_torch.core.rng import SALT_COLUMN, SALT_STOP
from repro_torch.core.samplers import (SamplerSpec, _uniform_index,
                                       es_num_chunks, n2v_bias,
                                       rejection_choose, vertex_row)
from repro_torch.core.scheduler import routing_capacity
from repro_torch.core.tasks import (WalkerSlots, WalkStats, empty_n2v_slots,
                                    empty_reservoir_slots, empty_slots)
from repro_torch.core.walk_engine import Chunk
from repro_torch.distributed.mesh import Mesh, all_gather, psum
from repro_torch.graph.partition import PartitionedGraph, owner_of

__all__ = [
    "DistConfig", "LocalView", "DistLogs", "StepOut", "ProgramCapability",
    "get_capability", "local_view", "make_distributed_engine",
    "DistStreamState", "init_dist_stream_state", "inject_stream_queries",
    "make_sharded_stream_engine", "shard_starts", "run_distributed",
    "assemble_paths",
]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    slots_per_device: int = 256    # W_loc — target live tasks per shard
    max_hops: int = 80
    capacity_margin: float = 2.0   # Theorem VI.1 margin on bucket capacity
    retention_factor: float = 1.0  # × N·W_loc (global live bound); >= 1.0
                                   # guarantees drops == 0 (see module doc)
    log_capacity: int = 1 << 16    # emission-log entries per shard
    record_paths: bool = True
    max_supersteps: int = 1 << 16
    axis_name: str = "ch"

    def __post_init__(self):
        if self.slots_per_device <= 0:
            raise ValueError(
                f"slots_per_device must be a positive lane count, got "
                f"{self.slots_per_device}")
        if self.max_hops <= 0:
            raise ValueError(f"max_hops must be positive, got "
                             f"{self.max_hops}")
        if self.capacity_margin <= 0:
            raise ValueError(f"capacity_margin must be positive, got "
                             f"{self.capacity_margin}")
        if self.retention_factor <= 0:
            raise ValueError(f"retention_factor must be positive, got "
                             f"{self.retention_factor}")
        if self.log_capacity <= 0 or self.max_supersteps <= 0:
            raise ValueError(
                f"log_capacity / max_supersteps must be positive, got "
                f"{self.log_capacity} / {self.max_supersteps}")

    def bucket_cap(self, num_devices: int) -> int:
        return routing_capacity(self.slots_per_device, num_devices,
                                self.capacity_margin)

    def retention_cap(self, num_devices: int) -> int:
        """Retention region sized to the global live-task bound N·W_loc:
        every live task in the system could, worst case, pile onto one
        shard (hub skew) and must be retainable there."""
        return int(math.ceil(self.retention_factor
                             * num_devices * self.slots_per_device))

    def pool_size(self, num_devices: int) -> int:
        return (num_devices * self.bucket_cap(num_devices)
                + self.retention_cap(num_devices))


class LocalView(NamedTuple):
    """Every shard of a partitioned graph presented with the sampler
    interface: the shards' arrays laid end to end.

    ``row_ptr`` holds each shard's ``V_loc + 1`` row pointers, offset by
    ``shard · E_loc`` so that they address the flat ``col`` (and the edge
    payloads) directly; ``type_offsets`` holds each shard's rows with one
    spare row, so both per-vertex arrays share the stride
    ``rows_per_shard``.  ``num_shards`` makes the shared sampler arithmetic
    residency-aware: `samplers.vertex_row` maps a vertex id to ``(v % N) ·
    rows_per_shard + v // N``, its row in its owner's block.  A lane homed
    on the vertex's owner reads exactly what the reference's per-device
    view reads; the other lanes' reads are masked, as there."""
    row_ptr: torch.Tensor
    col: torch.Tensor
    weights: Optional[torch.Tensor]
    alias_prob: Optional[torch.Tensor]
    alias_idx: Optional[torch.Tensor]
    max_degree: int
    type_offsets: Optional[torch.Tensor] = None
    num_shards: int = 1
    rows_per_shard: int = 1
    num_edges: int = 0


def local_view(pg: PartitionedGraph) -> LocalView:
    """The stacked :class:`LocalView` of every shard of ``pg``."""
    N, E_loc = pg.num_devices, pg.col.shape[1]
    off = torch.arange(N, dtype=torch.int32,
                       device=pg.device)[:, None] * E_loc
    to = None
    if pg.type_offsets is not None:
        pad = torch.zeros((N, 1, pg.type_offsets.shape[2]),
                          dtype=pg.type_offsets.dtype, device=pg.device)
        to = torch.cat([pg.type_offsets, pad], 1).reshape(
            -1, pg.type_offsets.shape[2])

    def flat(x):
        return None if x is None else x.reshape(-1)
    return LocalView(
        row_ptr=(pg.row_ptr + off).reshape(-1), col=flat(pg.col),
        weights=flat(pg.weights), alias_prob=flat(pg.alias_prob),
        alias_idx=flat(pg.alias_idx), max_degree=pg.max_degree,
        type_offsets=to, num_shards=N,
        rows_per_shard=pg.vertices_per_device + 1, num_edges=N * E_loc)


class DistLogs(NamedTuple):
    qid: torch.Tensor     # (N, cap) int32
    hop: torch.Tensor     # (N, cap) int32
    vertex: torch.Tensor  # (N, cap) int32
    cursor: torch.Tensor  # (N,) int64


class StepOut(NamedTuple):
    """What a capability's per-phase step hands back to the generic
    superstep: the updated pool plus the hop-advance/termination masks the
    emission log and refill need.  ``query_id``/``active`` must be left
    untouched by the step — the generic code owns their lifecycle."""
    slots: Any
    adv: torch.Tensor         # lanes that advanced one hop this superstep
    terminated: torch.Tensor  # lanes whose walk ended this superstep
    v_next: torch.Tensor      # vertex to record for advanced lanes
    new_hop: torch.Tensor     # hop index of that record


def _local_row_access(view: LocalView, v: torch.Tensor):
    """{addr, deg} of ``v``'s row in its owner's block (addr indexes the
    flat ``col``)."""
    row = vertex_row(view, v).long()
    addr = view.row_ptr[row]
    return addr, view.row_ptr[row + 1] - addr


def _col(view: LocalView, e: torch.Tensor) -> torch.Tensor:
    return view.col[torch.clamp(e, 0, view.num_edges - 1).long()]


def _stop_threshold(spec: SamplerSpec) -> float:
    # The reference compares a float32 uniform with the weak-typed α.
    return float(np.float32(spec.stop_prob))


# --------------------------------------------------------------------------
# Generic capability: ONE engine adapter interpreting the lowered phase
# program — residency schedule → routing plan, `carry` → task word, phase
# bodies → the shared executors in `phase_program` / `samplers`.
# --------------------------------------------------------------------------


class ProgramCapability:
    """Sharded lowering of a :class:`~repro_torch.core.phase_program.
    PhaseProgram`.

    The program's residency schedule picks one of three execution plans:

    ``single_phase`` — every phase resident at owner(v_curr): the whole
    hop (Row Access → phase list → Column Access) executes in one
    superstep on the owner, via the same phase interpreter the
    single-device engine uses (`phase_program.make_sampler`, which is
    residency-aware through `LocalView.num_shards`).  Covers uniform,
    alias, and — with ``type_offsets`` partitioned alongside the CSR
    shards — metapath.

    ``two_phase`` — a score phase resident at owner(v_prev): phase A
    executes the program's csr-gather at owner(v_curr) and stages the
    candidate fan-out in the task word (`N2VSlots`); phase B executes the
    first-accept score at owner(v_prev) with the same (seed, qid,
    hop)-derived uniforms and the shared `rejection_choose`/`n2v_bias`
    arithmetic ⇒ bit-identical walks.  Hop 0 has no v_prev (bias ≡ 1) and
    scores locally in phase A.

    ``chunked_loop`` — the looping gather/score chunk pair: the O(deg)
    E-S reservoir scan ping-pongs `phase_program.chunk_gather` output
    (staged in `ReservoirSlots`) between owner(v_curr) and owner(v_prev)'s
    `phase_program.chunk_score` fold; phase 2·n_chunks finalizes at
    owner(v_curr) with a column access on the winning offset.  Per-lane
    early finalize: the gather phase flags the chunk covering deg(v_curr),
    and its score phase jumps straight to finalize (skipped chunks would
    contribute only -inf keys, so the argmax is unchanged).

    Hop-0 prescan (``hop0_inline=False``, closed engine, chunked loop
    only): hop 0 is the one hop whose whole scan is local (bias ≡ 1
    without v_prev), so the closed engine scans it *once* for every query
    before the superstep loop (:meth:`prescan_hop0`); refilled tasks enter
    the pool already at hop 1.  Draws still derive from ``(seed, qid,
    hop=0, chunk)``, so paths are bit-identical.  The streaming engine
    keeps the inline hop-0 path (arrivals land mid-run)."""

    def __init__(self, prog: PhaseProgram, spec: SamplerSpec,
                 cfg: DistConfig, num_devices: int, v_per_dev: int,
                 max_degree: int, hop0_inline: bool = True):
        self.prog, self.spec, self.cfg = prog, spec, cfg
        self.N, self.v_per_dev = num_devices, v_per_dev
        self.schedule = prog.schedule
        if self.schedule == "chunked_loop":
            self.CH = spec.reservoir_chunk
            self.n_chunks = es_num_chunks(max_degree, self.CH)
            self.hop0_inline = hop0_inline
            self.prescan = not hop0_inline
        else:
            self.hop0_inline = True
            self.prescan = False
        if self.schedule == "single_phase":
            self._sampler = make_sampler(spec)

    # ------------------------------------------------- task word / routing

    def empty_pool(self, size: int, device):
        carry = self.prog.carry
        if carry == "candidates":
            return empty_n2v_slots(size, self.spec.rejection_rounds, device)
        if carry == "reservoir":
            return empty_reservoir_slots(size, self.CH, device)
        return empty_slots(size, device)

    def home(self, slots) -> torch.Tensor:
        if self.schedule == "single_phase":
            return owner_of(slots.v_curr, self.N)
        v_prev = torch.clamp(slots.v_prev, min=0)
        if self.schedule == "two_phase":
            return owner_of(torch.where(slots.phase == 0, slots.v_curr,
                                        v_prev), self.N)
        # chunked loop: even phases (gather / finalize) live at
        # owner(v_curr); odd (score) at owner(v_prev).
        return owner_of(torch.where(slots.phase % 2 == 0, slots.v_curr,
                                    v_prev), self.N)

    def route_dest(self, slots) -> torch.Tensor:
        if self.schedule == "two_phase":
            return owner_of(torch.where(slots.phase == 1,
                                        torch.clamp(slots.v_prev, min=0),
                                        slots.v_curr), self.N)
        return self.home(slots)

    def reset_extras(self, slots, take):
        carry = self.prog.carry
        if carry == "candidates":
            return slots._replace(phase=torch.where(take, 0, slots.phase))
        if carry == "reservoir":
            return slots._replace(
                phase=torch.where(take, 0, slots.phase),
                best_key=torch.where(take, -torch.inf, slots.best_key),
                best_idx=torch.where(take, 0, slots.best_idx),
                last_chunk=torch.where(take, False, slots.last_chunk),
            )
        return slots

    # ------------------------------------------------------------- stepping

    def step(self, view: LocalView, slots, mine, base_key) -> StepOut:
        return {"single_phase": self._step_single,
                "two_phase": self._step_two_phase,
                "chunked_loop": self._step_chunked}[self.schedule](
                    view, slots, mine, base_key)

    def _stop(self, slots, at: torch.Tensor, base_key) -> torch.Tensor:
        """The PPR termination draw, at the top of a hop."""
        if self.spec.stop_prob > 0.0:
            u_stop = task_rng.task_uniforms(base_key, slots.query_id,
                                            slots.hop, 1, SALT_STOP,
                                            epoch=slots.epoch)[:, 0]
            return at & (u_stop < _stop_threshold(self.spec))
        return torch.zeros_like(at)

    def _advance(self, slots, adv, stop, dead, v_next):
        new_hop = torch.where(adv, slots.hop + 1, slots.hop)
        reached_max = adv & (new_hop >= self.cfg.max_hops)
        terminated = stop | dead | reached_max
        return new_hop, terminated, dict(
            v_curr=torch.where(adv, v_next, slots.v_curr),
            v_prev=torch.where(adv, slots.v_curr, slots.v_prev),
            hop=new_hop)

    def _step_single(self, view: LocalView, slots, mine,
                     base_key) -> StepOut:
        """Whole hop at owner(v_curr): Row Access → phase interpreter →
        Column Access (the sharded twin of `walk_engine._process`)."""
        stop = self._stop(slots, mine, base_key)
        addr, deg = _local_row_access(view, slots.v_curr)
        idx, ok = self._sampler(view, addr, deg, slots, base_key)
        v_next = _col(view, addr + idx)

        adv = mine & ~stop & ok
        dead = mine & ~stop & ~ok
        new_hop, terminated, upd = self._advance(slots, adv, stop, dead,
                                                 v_next)
        return StepOut(slots._replace(**upd), adv, terminated, v_next,
                       new_hop)

    def _step_two_phase(self, view: LocalView, slots, mine,
                        base_key) -> StepOut:
        """Propose @ owner(v_curr) (csr-gather phase), verify @
        owner(v_prev) (first-accept score phase)."""
        spec = self.spec
        K = spec.rejection_rounds

        do_a = mine & (slots.phase == 0)
        stop = self._stop(slots, do_a, base_key)

        # ---- phase A: the gather(csr, K) phase at owner(v_curr) ---------
        addr, deg = _local_row_access(view, slots.v_curr)
        u = task_rng.task_uniforms(base_key, slots.query_id, slots.hop,
                                   2 * K, SALT_COLUMN, epoch=slots.epoch)
        u_col, u_acc = u[:, :K], u[:, K:]
        idx = _uniform_index(deg[:, None], u_col)
        proposals = _col(view, addr[:, None] + idx)               # (S, K)
        dead = do_a & ~stop & (deg == 0)
        hop0 = do_a & ~stop & (slots.v_prev < 0) & (deg > 0)
        # Hop 0 scores locally: no v_prev ⇒ bias ≡ 1.
        first0 = rejection_choose(spec, u_acc, torch.ones_like(u_acc))
        v0 = proposals.gather(1, first0[:, None])[:, 0]
        go_b = do_a & ~stop & ~dead & ~hop0

        # ---- phase B: the score(first_accept) phase at owner(v_prev) ----
        do_b = mine & (slots.phase == 1)
        w = n2v_bias(spec, view, slots.v_prev, slots.cand)
        first = rejection_choose(spec, u_acc, w)
        vb = slots.cand.gather(1, first[:, None])[:, 0]

        adv = do_b | hop0
        v_next = torch.where(hop0, v0, vb)
        new_hop, terminated, upd = self._advance(slots, adv, stop, dead,
                                                 v_next)
        slots = slots._replace(
            phase=torch.where(go_b, 1, torch.where(adv, 0, slots.phase)),
            cand=torch.where(go_b[:, None], proposals, slots.cand), **upd)
        return StepOut(slots, adv, terminated, v_next, new_hop)

    def prescan_hop0(self, view: LocalView, starts, qids, own, base_key):
        """Batched hop-0 scan of the queries in ``own`` (chunked loop,
        closed engine), each on its start vertex's owner.

        One E-S reservoir scan over all start vertices (bias ≡ 1: no
        v_prev yet), with the exact (seed, qid, hop=0, chunk) uniforms and
        the hop-0 stop draw the inline path uses — bit-identical outcomes,
        evaluated once instead of inside every superstep.  Returns ``(v1,
        adv0, term0, enter)``: the sampled hop-1 vertex, whether the query
        advanced (a path record exists), whether it terminated at the
        prescan, and whether it should enter the slot pool (advanced and
        hop budget left).
        """
        spec, cfg = self.spec, self.cfg
        zeros = torch.zeros_like(qids)
        addr, deg = _local_row_access(view, starts)
        if spec.stop_prob > 0.0:
            u = task_rng.task_uniforms(base_key, qids, zeros, 1, SALT_STOP,
                                       epoch=zeros)[:, 0]
            stop = own & (u < _stop_threshold(spec))
        else:
            stop = torch.zeros_like(own)
        dead = own & ~stop & (deg == 0)
        adv0 = own & ~stop & ~dead
        scan_slots = WalkerSlots(
            v_curr=starts, v_prev=torch.full_like(starts, -1), query_id=qids,
            hop=zeros, active=adv0, epoch=zeros)
        idx0, _ = reservoir_scan(spec, view, addr, deg, scan_slots, base_key)
        v1 = _col(view, addr + idx0)
        reached = adv0 & (1 >= cfg.max_hops)
        term0 = stop | dead | reached
        return v1, adv0, term0, adv0 & ~reached

    def _step_chunked(self, view: LocalView, slots, mine,
                      base_key) -> StepOut:
        """One chunk phase of the looping gather/score program."""
        spec, CH, NC = self.spec, self.CH, self.n_chunks
        phase = slots.phase
        chunk = phase // 2

        is_gather = mine & (phase % 2 == 0) & (phase < 2 * NC)
        is_score = mine & (phase % 2 == 1)
        is_final = mine & (phase == 2 * NC)
        at_hop_start = is_gather & (chunk == 0)
        stop = self._stop(slots, at_hop_start, base_key)

        addr, deg = _local_row_access(view, slots.v_curr)
        dead = at_hop_start & ~stop & (deg == 0)

        # ---- hop 0: all-local scan (bias ≡ 1 without v_prev) ------------
        if self.hop0_inline:
            hop0 = at_hop_start & ~stop & (slots.v_prev < 0) & (deg > 0)
            # Only the hop-0 lanes use the scan, so only they bound its
            # degree-adaptive trip count (the others' chunks are unused).
            idx0, _ = reservoir_scan(spec, view, addr, deg,
                                     slots._replace(active=hop0), base_key)
            v0 = _col(view, addr + idx0)
        else:  # closed engine: hop 0 was batched by prescan_hop0
            hop0 = torch.zeros_like(mine)
            v0 = slots.v_curr

        # ---- gather phase: stage chunk c of (candidate, edge weight) ----
        do_gather = is_gather & ~stop & ~dead & ~hop0
        y, w_edge = chunk_gather(view, addr, deg, chunk, CH)
        cand = torch.where(do_gather[:, None], y, slots.cand)
        cand_w = torch.where(do_gather[:, None], w_edge, slots.cand_w)

        # ---- score phase: E-S fold under the local N(v_prev) bias -------
        m_key, m_idx = chunk_score(spec, view, slots, chunk, CH, base_key)

        # ---- finalize: column access on the scanned argmax --------------
        idx_f = torch.minimum(torch.clamp(slots.best_idx, min=0),
                              torch.clamp(deg - 1, min=0))
        v_f = _col(view, addr + idx_f)

        adv = is_final | hop0
        v_next = torch.where(hop0, v0, v_f)
        new_hop, terminated, upd = self._advance(slots, adv, stop, dead,
                                                 v_next)

        # Early finalize: the gather phase sees deg(v_curr) and flags the
        # chunk covering the last neighbor; its score phase then jumps to
        # the finalize phase rather than stepping through empty chunks.
        covers_deg = (chunk + 1) * CH >= deg
        next_phase = torch.where(is_score & slots.last_chunk,
                                 2 * NC, phase + 1)
        slots = slots._replace(
            phase=torch.where(do_gather | is_score, next_phase,
                              torch.where(adv, 0, phase)),
            cand=cand, cand_w=cand_w,
            best_key=torch.where(is_score, m_key,
                                 torch.where(adv, -torch.inf,
                                             slots.best_key)),
            best_idx=torch.where(is_score, m_idx,
                                 torch.where(adv, 0, slots.best_idx)),
            last_chunk=torch.where(do_gather, covers_deg,
                                   torch.where(adv, False,
                                               slots.last_chunk)),
            **upd)
        return StepOut(slots, adv, terminated, v_next, new_hop)


def get_capability(spec: SamplerSpec, cfg: DistConfig, num_devices: int,
                   v_per_dev: int, max_degree: int,
                   hop0_inline: bool = True) -> ProgramCapability:
    """Lower the sampler's phase program to the generic engine adapter.

    ``hop0_inline=False`` (closed engine) lets the chunked-loop schedule
    batch its hop-0 work into a one-time prescan instead of the
    per-superstep critical path.
    """
    prog = lower(spec)
    if prog.capability is None:  # no current program declares None
        raise NotImplementedError(
            f"sampler kind {spec.kind!r} declares no distributed "
            "capability; run it on the single-device backend")
    return ProgramCapability(prog, spec, cfg, num_devices, v_per_dev,
                             max_degree, hop0_inline=hop0_inline)


# --------------------------------------------------------------------------
# Generic superstep: phase-step → emission log → terminate → flow-controlled
# refill → butterfly route.  Identical for every capability.  Every tensor
# holds all shards: the pool's fields are (N, S[, ...]), a shard's
# counters (N,).
# --------------------------------------------------------------------------


def _flatten(slots):
    """(N, S, ...) pool → (N·S, ...) lanes, one pass of the step for all
    shards."""
    return type(slots)(*(f.reshape(-1, *f.shape[2:]) for f in slots))


def _unflatten(slots, N: int):
    return type(slots)(*(f.reshape(N, -1, *f.shape[1:]) for f in slots))


def _zero_stats(N: int, device) -> WalkStats:
    """Per-shard counters: each field an (N,) int64 tensor."""
    return WalkStats(*(torch.zeros((N,), dtype=torch.int64, device=device)
                       for _ in WalkStats._fields))


def _lane_ranks(N: int, S: int, device) -> torch.Tensor:
    """(N, S) int32: the shard each pool lane sits on."""
    return torch.arange(N, dtype=torch.int32, device=device)[:, None] \
        .expand(N, S)


def _write_log(logs, cap_log: int, cursor, adv, qid, hop, vertex):
    """Append one record per ``adv`` lane, in lane order, to each shard's
    emission log; returns the new cursor and each shard's records past
    ``cap_log`` (counted as drops).  ``logs`` are (N, cap_log + 1): the
    spare last column absorbs the lanes that record nothing."""
    pos = cursor[:, None] + torch.cumsum(adv.to(torch.int64), 1) - 1
    keep = adv & (pos < cap_log)
    p_safe = torch.where(keep, pos, cap_log)
    for log, val in zip(logs, (qid, hop, vertex)):
        log.scatter_(1, p_safe, torch.broadcast_to(val, p_safe.shape)
                     .to(log.dtype))
    n = adv.sum(1)
    return torch.clamp(cursor + n, max=cap_log), (adv & ~keep).sum(1)


def _route(cap, cfg: DistConfig, N: int, slots):
    """Butterfly all-to-all of every live task to its next home; returns
    the new pool (incoming buckets, then retention) and the route result."""
    K, R = cfg.bucket_cap(N), cfg.retention_cap(N)
    dest = cap.route_dest(slots)
    lane = torch.arange(cfg.pool_size(N), device=dest.device)
    priority = torch.where(lane >= N * K, 0, 1)  # retained tasks go first
    rr = router.pack_buckets(slots, dest, priority, N, K, R)
    incoming = router.exchange(rr.send, cfg.axis_name)
    slots = type(slots)(*(torch.cat([a, b], 1)
                          for a, b in zip(incoming, rr.retention)))
    return slots, rr


def _add_stats(stats: WalkStats, cfg: DistConfig, mine, adv, terminated,
               upstream, waits, drops) -> WalkStats:
    W_loc = cfg.slots_per_device
    idle = torch.clamp(W_loc - mine.sum(1), min=0)
    return stats._replace(
        steps=stats.steps + adv.sum(1),
        slot_steps=stats.slot_steps + W_loc,
        bubbles=stats.bubbles + idle,
        starved=stats.starved + idle * upstream,
        terminations=stats.terminations + terminated.sum(1),
        supersteps=stats.supersteps + 1,
        route_waits=stats.route_waits + waits,
        drops=stats.drops + drops,
        launches=stats.launches + 1,
    )


def _admission(cfg: DistConfig, N: int, slots, pending):
    """Flow-controlled refill ranks: each shard admits at most its fair
    share of the global headroom N·W_loc - live, so system-wide live tasks
    never exceed N·W_loc — the bound the retention region is provisioned
    for (drops == 0 by construction, not by margin).  Returns (take,
    rank among the shard's free lanes)."""
    W_loc = cfg.slots_per_device
    n_active = slots.active.sum(1)
    global_live = psum(n_active)
    slack = torch.clamp(N * W_loc - global_live, min=0)
    free = ~slots.active
    budget = torch.minimum(torch.clamp(W_loc - n_active, min=0), slack // N)
    avail = torch.minimum(torch.clamp(pending, min=0), budget)
    rank_free = torch.cumsum(free.to(torch.int64), 1) - 1
    return free & (rank_free < avail[:, None]), rank_free


def _superstep_dist(cap, cfg: DistConfig, N: int, base_key, view,
                    starts_loc, qcount, rank, seeds, carry):
    """One closed superstep over every shard.  ``rank`` is the (N, S)
    shard of each pool lane; ``starts_loc`` (N, q_loc) and ``qcount`` (N,)
    are each shard's query shard; ``seeds`` its refill seeds."""
    (slots, head, log_q, log_h, log_v, cursor, stats, done, t) = carry
    S = cfg.pool_size(N)

    # ---- process: one phase for locally-homed live tasks ----------------
    lanes = _flatten(slots)
    mine = lanes.active & (cap.home(lanes) == rank.reshape(-1))
    out = cap.step(view, lanes, mine, base_key)
    slots = _unflatten(out.slots, N)
    mine, adv, terminated = (x.view(N, S) for x in
                             (mine, out.adv, out.terminated))

    # ---- emission log (streaming write-back, paper §IV-B) ---------------
    # Runs before the terminated lanes' query_id is cleared (the final hop
    # of a walk is still a recorded visit).
    log_drop = torch.zeros_like(head)
    if cfg.record_paths:
        cursor, log_drop = _write_log(
            (log_q, log_h, log_v), cfg.log_capacity, cursor, adv,
            torch.where(adv, slots.query_id, -1), out.new_hop.view(N, S),
            out.v_next.view(N, S))

    slots = slots._replace(
        query_id=torch.where(terminated, -1, slots.query_id),
        active=slots.active & ~terminated,
    )

    # ---- zero-bubble refill, flow-controlled to the global live bound ---
    take, rank_free = _admission(cfg, N, slots, qcount - head)
    k_local = head[:, None] + rank_free
    k_safe = torch.clamp(k_local, 0, starts_loc.shape[1] - 1)
    # Refill seeds: the plain engine admits hop-0 tasks at the start
    # vertex; a hop-0 prescan capability seeds hop-1 tasks (v_prev = the
    # start) and skips queries the prescan already terminated (`enter`).
    seed_vc, seed_vp, seed_hop, seed_enter = (x.gather(1, k_safe)
                                              for x in seeds)
    adm = take & seed_enter  # admitted to the pool
    slots = slots._replace(
        v_curr=torch.where(adm, seed_vc, slots.v_curr),
        v_prev=torch.where(adm, seed_vp, slots.v_prev),
        query_id=torch.where(adm, (k_local * N + rank).to(torch.int32),
                             slots.query_id),
        hop=torch.where(adm, seed_hop, slots.hop),
        active=slots.active | adm,
        epoch=torch.where(adm, 0, slots.epoch),  # closed batch == epoch 0
    )
    slots = cap.reset_extras(slots, adm)
    head = head + take.sum(1)

    # ---- route: butterfly all-to-all to each task's next home -----------
    slots, rr = _route(cap, cfg, N, slots)

    # ---- stats + global termination -------------------------------------
    stats = _add_stats(stats, cfg, mine, adv, terminated,
                       (head < qcount).to(torch.int64), rr.waits,
                       rr.drops + log_drop)
    remaining = torch.clamp(qcount - head, min=0)
    done = (slots.active.sum(1) + remaining).sum() == 0
    return (slots, head, log_q, log_h, log_v, cursor, stats, done, t + 1)


def _run_hop0_prescan(cap, cfg: DistConfig, N: int, view: LocalView,
                      starts_sh, qcount, base_key, log_q, log_h, log_v):
    """One-time batched hop-0 pass for prescan capabilities (closed engine).

    Every query's hop-0 scan runs once, on its start vertex's owner (the
    reference gathers the global query list on every device and each scans
    the starts it owns); the owner logs the resulting (qid, 1, v1) record
    in its emission log, in global query-list order, and the hop-1 refill
    seeds go back to the shard staging each query.  Runs before the
    superstep loop — O(Q) work once instead of a full reservoir scan in
    every superstep.
    """
    q_loc = starts_sh.shape[1]
    dev = starts_sh.device
    starts_all = all_gather(starts_sh)                       # (N, q_loc)
    ks = torch.arange(q_loc, dtype=torch.int32, device=dev)
    ranks = torch.arange(N, dtype=torch.int32, device=dev)
    qid_all = (ks[None, :] * N + ranks[:, None]).reshape(-1)
    valid = (ks[None, :] < qcount[:, None]).reshape(-1)
    sflat = starts_all.reshape(-1)
    v1, adv0, term0, enter = cap.prescan_hop0(view, sflat, qid_all, valid,
                                              base_key)
    own = owner_of(sflat, N)[None, :] == ranks[:, None]      # (N, N·q_loc)

    # The owner that computed each hop-1 vertex logs its (qid, 1, v1)
    # record — same emission-log discipline as the superstep.
    log_drop = torch.zeros((N,), dtype=torch.int64, device=dev)
    cursor = torch.zeros((N,), dtype=torch.int64, device=dev)
    rec = own & adv0[None, :]
    if cfg.record_paths:
        cursor, log_drop = _write_log(
            (log_q, log_h, log_v), log_q.shape[1] - 1, cursor, rec,
            torch.where(rec, qid_all, -1), torch.ones_like(qid_all), v1)

    stats0 = _zero_stats(N, dev)._replace(
        steps=rec.sum(1), terminations=(own & term0[None, :]).sum(1),
        drops=log_drop)

    # Each query has exactly one owner, so its hop-1 seeds are the owner's
    # result (the reference's psum of owner-masked values).
    seeds = (torch.where(enter, v1, 0).view(N, q_loc), starts_sh,
             torch.ones_like(starts_sh), enter.view(N, q_loc))
    return seeds, cursor, stats0


def _check_typed(pg: PartitionedGraph, spec: SamplerSpec) -> None:
    if "typed" not in lower(spec).requires:
        return
    if pg.type_offsets is None:
        raise ValueError(
            "metapath programs need type_offsets partitioned with the "
            "graph — build the CSRGraph with num_edge_types > 0 before "
            "partition_graph")
    if max(spec.metapath) >= pg.type_offsets.shape[-1] - 1:
        raise ValueError(
            f"metapath schedule {spec.metapath} names an edge type the "
            f"graph lacks (it has {pg.type_offsets.shape[-1] - 1})")


def _check_mesh(mesh: Optional[Mesh], pg: PartitionedGraph) -> None:
    if mesh is None:
        return
    if mesh.num_shards != pg.num_devices:
        raise ValueError(f"the mesh has {mesh.num_shards} shards, the graph "
                         f"{pg.num_devices}")
    if torch.device(mesh.device) != pg.device:
        raise ValueError(f"the mesh is on {mesh.device}, the graph on "
                         f"{pg.device}")


def make_distributed_engine(pg: PartitionedGraph, spec: SamplerSpec,
                            cfg: DistConfig, mesh: Optional[Mesh] = None):
    """Build the closed sharded runner ``run(graph, starts_sharded,
    qcount, base_key) -> (log_q, log_h, log_v, cursor, stats)`` for graphs
    shaped like ``pg``: the emission logs (N, log_capacity), each shard's
    cursor (N,) and per-shard `WalkStats` (each field (N,)).

    Works for every sampler kind that declares a capability — first- and
    second-order walks share this one routing path.
    """
    N = pg.num_devices
    _check_mesh(mesh, pg)
    _check_typed(pg, spec)
    cap = get_capability(spec, cfg, N, pg.vertices_per_device,
                         pg.max_degree, hop0_inline=False)
    S = cfg.pool_size(N)

    def run(graph: PartitionedGraph, starts_sharded, qcount, base_key):
        dev = graph.device
        view = local_view(graph)
        base_key = tuple(int(x) for x in base_key)
        starts_l = torch.as_tensor(starts_sharded, dtype=torch.int32,
                                   device=dev)
        qcount_l = torch.as_tensor(qcount, device=dev).reshape(-1).to(
            torch.int64)
        cap_log = cfg.log_capacity if cfg.record_paths else 1
        log_q, log_h, log_v = (torch.full((N, cap_log + 1), -1,
                                          dtype=torch.int32, device=dev)
                               for _ in range(3))
        cursor = torch.zeros((N,), dtype=torch.int64, device=dev)
        stats = _zero_stats(N, dev)
        # Default refill seeds: hop-0 tasks at the start vertex.
        seeds = (starts_l, torch.full_like(starts_l, -1),
                 torch.zeros_like(starts_l),
                 torch.ones(starts_l.shape, dtype=torch.bool, device=dev))
        if cap.prescan:
            # ---- one-time batched hop-0 local scan (out of the
            # per-superstep critical path; see ProgramCapability) ------
            seeds, cursor, stats = _run_hop0_prescan(
                cap, cfg, N, view, starts_l, qcount_l, base_key,
                log_q, log_h, log_v)
        pool = _unflatten(cap.empty_pool(N * S, dev), N)
        carry = (pool, torch.zeros((N,), dtype=torch.int64, device=dev),
                 log_q, log_h, log_v, cursor, stats, None, 0)
        rank = _lane_ranks(N, S, dev)
        while True:   # the reference's while_loop: done or max_supersteps
            carry = _superstep_dist(cap, cfg, N, base_key, view, starts_l,
                                    qcount_l, rank, seeds, carry)
            if carry[8] >= cfg.max_supersteps or bool(carry[7]):
                break
        _, _, log_q, log_h, log_v, cursor, stats, _, _ = carry
        return (log_q[:, :cap_log], log_h[:, :cap_log], log_v[:, :cap_log],
                cursor, stats)

    return run


# --------------------------------------------------------------------------
# Open-system (streaming) sharded engine: persistent sharded state, chunked
# supersteps, host injection between chunks — the sharded realization of
# the ring-buffer slot economy (core/walk_engine.py).  The same capability
# dispatch, flow-controlled refill, and butterfly routing as the closed
# engine; only arrival/injection and harvest differ.
# --------------------------------------------------------------------------


class DistStreamState(NamedTuple):
    """Persistent sharded stream state; every field's leading axis is the
    shard (channel) axis.

    Arrivals are staged by the host into per-shard *arrival rings* —
    (start, qid, epoch) triplets appended at monotone ``tail`` counters on
    whichever shard the host round-robins them to.  Refill turns a staged
    arrival into a hop-0 task on the staging shard, and the very next
    routing phase (the same butterfly all-to-all every live task rides)
    carries it to owner(start_vertex).

    ``paths``/``lengths``/``done`` are streaming write-back windows indexed
    by global slot id: each shard scatters only the hops *it* executed and
    the host folds the shards with an elementwise max at harvest.  Every
    (qid, hop) cell is written by exactly one shard (the one that advanced
    that hop) while all others keep the -1/0 fill, so the fold is exact and
    lossless.  The three hold one spare row at index ``capacity`` that
    absorbs the writes of lanes that record nothing; it is never read.

    Rings are provisioned to the full stream ``capacity`` per shard, so
    even if every live query is staged on one shard the ring cannot
    overflow (live queries are bounded by ``capacity`` host-side).
    """

    slots: Any                  # capability task word, fields (N, S, ...)
    ring_start: torch.Tensor    # (N, cap) int32 — start vertex by arrival seq
    ring_qid: torch.Tensor      # (N, cap) int32 — slot id by arrival seq
    ring_epoch: torch.Tensor    # (N, cap) int32 — occupant epoch
    head: torch.Tensor          # (N,) int64 — monotone per-shard issue count
    tail: torch.Tensor          # (N,) int64 — monotone per-shard arrivals
    paths: torch.Tensor         # (N, cap+1, max_hops+1) int32
    lengths: torch.Tensor       # (N, cap+1) int32
    done: torch.Tensor          # (N, cap+1) bool — terminated, by slot id
    stats: WalkStats            # fields (N,)


def init_dist_stream_state(pg: PartitionedGraph, spec: SamplerSpec,
                           cfg: DistConfig, capacity: int) -> DistStreamState:
    """Empty sharded open-system state on the graph's device with room for
    ``capacity`` live queries (global slot ids 0..capacity-1, shared
    across shards)."""
    N, dev = pg.num_devices, pg.device
    cap_ = get_capability(spec, cfg, N, pg.vertices_per_device,
                          pg.max_degree)
    pool = _unflatten(cap_.empty_pool(N * cfg.pool_size(N), dev), N)

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return DistStreamState(
        slots=pool,
        ring_start=zeros((N, capacity)), ring_qid=zeros((N, capacity)),
        ring_epoch=zeros((N, capacity)),
        head=zeros((N,), torch.int64), tail=zeros((N,), torch.int64),
        paths=torch.full((N, capacity + 1, cfg.max_hops + 1), -1,
                         dtype=torch.int32, device=dev),
        lengths=zeros((N, capacity + 1)),
        done=zeros((N, capacity + 1), torch.bool),
        stats=_zero_stats(N, dev),
    )


def inject_stream_queries(state: DistStreamState, starts_blk, qid_blk,
                          epoch_blk, counts) -> DistStreamState:
    """Stage arrival blocks into the per-shard rings (host→device).

    ``starts_blk``/``qid_blk``/``epoch_blk`` are (N, B) host blocks; row
    r's first ``counts[r]`` entries are real arrivals for shard r, the
    rest padding that is never written.  Recycled slots' ``done`` bits and
    path rows are cleared on *every* shard — an old occupant's hops may
    have been recorded anywhere.  Writes the state in place; returns it.
    """
    N, cap = state.ring_qid.shape
    counts = np.asarray(counts, np.int64).reshape(N)
    B = np.asarray(qid_blk).shape[1]
    if counts.min(initial=0) < 0 or counts.max(initial=0) > B:
        raise ValueError(f"counts must lie in [0, {B}], got {counts}")
    idx = np.arange(B)[None, :]
    valid = idx < counts[:, None]
    rows, cols = np.nonzero(valid)
    block = np.stack([rows, cols] + [np.asarray(x, np.int64)[valid] for x in
                                     (starts_blk, qid_blk, epoch_blk)])
    qids = block[4]
    if qids.size and not (0 <= qids.min() and qids.max() < cap):
        raise ValueError(f"slot ids must lie in [0, {cap}), got "
                         f"[{qids.min()}, {qids.max()}]")
    dev = state.tail.device
    rows, cols, start, qid, epoch = torch.from_numpy(block).to(dev).unbind()
    pos = (state.tail[rows] + cols) % cap
    state.ring_start[rows, pos] = start.to(torch.int32)
    state.ring_qid[rows, pos] = qid.to(torch.int32)
    state.ring_epoch[rows, pos] = epoch.to(torch.int32)
    state.done[:, qid] = False
    state.paths[:, qid, :] = -1
    state.lengths[:, qid] = 0
    state.tail.add_(torch.from_numpy(counts).to(dev))
    return state


def _superstep_dist_stream(cap, cfg: DistConfig, N: int, capacity: int,
                           base_key, view, rank, st: DistStreamState):
    """One streaming superstep: phase-step → path/done scatter → terminate
    → flow-controlled ring refill → butterfly route (mirrors
    `_superstep_dist`, with the arrival ring in place of the start shard
    and scatter windows in place of the emission log).  Returns the state
    and the global work flag (a 0-dim bool tensor)."""
    S = cfg.pool_size(N)
    rows = torch.arange(N, device=rank.device)[:, None]

    # ---- process: one phase for locally-homed live tasks ----------------
    lanes = _flatten(st.slots)
    mine = lanes.active & (cap.home(lanes) == rank.reshape(-1))
    out = cap.step(view, lanes, mine, base_key)
    slots = _unflatten(out.slots, N)
    mine, adv, terminated, new_hop, v_next = (
        x.view(N, S) for x in (mine, out.adv, out.terminated, out.new_hop,
                               out.v_next))

    # ---- streaming write-back: scatter executed hops locally ------------
    sq = torch.where(adv, slots.query_id, capacity).long()  # capacity = spare
    st.paths[rows, sq, new_hop.long()] = v_next
    st.lengths[rows, sq] = new_hop + 1
    st.done[rows, torch.where(terminated, slots.query_id,
                              capacity).long()] = True

    slots = slots._replace(
        query_id=torch.where(terminated, -1, slots.query_id),
        active=slots.active & ~terminated,
    )

    # ---- zero-bubble refill from the local arrival ring, flow-controlled
    # to the global live bound N·W_loc (the closed engine's coordination,
    # so losslessness carries over to the open system) -------------------
    take, rank_free = _admission(cfg, N, slots, st.tail - st.head)
    pos = (st.head[:, None] + torch.clamp(rank_free, min=0)) % capacity
    qid = st.ring_qid.gather(1, pos)
    start = st.ring_start.gather(1, pos)
    ep = st.ring_epoch.gather(1, pos)
    slots = slots._replace(
        v_curr=torch.where(take, start, slots.v_curr),
        v_prev=torch.where(take, -1, slots.v_prev),
        query_id=torch.where(take, qid, slots.query_id),
        hop=torch.where(take, 0, slots.hop),
        active=slots.active | take,
        epoch=torch.where(take, ep, slots.epoch),
    )
    slots = cap.reset_extras(slots, take)
    head = st.head + take.sum(1)
    # Record hop 0 on the staging shard; the route below hands the task to
    # owner(start_vertex) for its first hop.
    sq = torch.where(take, qid, capacity).long()
    st.paths[rows, sq, 0] = start
    st.lengths[rows, sq] = 1

    # ---- route: butterfly all-to-all to each task's next home -----------
    slots, rr = _route(cap, cfg, N, slots)

    # ---- stats + global work flag ---------------------------------------
    stats = _add_stats(st.stats, cfg, mine, adv, terminated,
                       (head < st.tail).to(torch.int64), rr.waits, rr.drops)
    pending = torch.clamp(st.tail - head, min=0)
    work = (slots.active.sum(1) + pending).sum() > 0
    return st._replace(slots=slots, head=head, stats=stats), work


def make_sharded_stream_engine(pg: PartitionedGraph, spec: SamplerSpec,
                               cfg: DistConfig, mesh: Optional[Mesh] = None,
                               capacity: int = 4096):
    """Build ``run(graph, state, base_key, k) -> Chunk`` (the single
    engine's: the state, the supersteps run, the seconds blocked in the
    work-flag read) advancing the sharded stream by at most ``k``
    supersteps, stopping early when no work remains on any shard (the
    flag is read once before the first superstep and once after each).
    The host injects with :func:`inject_stream_queries` between chunks
    and harvests by max-folding the per-shard path windows.
    """
    N = pg.num_devices
    _check_mesh(mesh, pg)
    _check_typed(pg, spec)
    cap_ = get_capability(spec, cfg, N, pg.vertices_per_device,
                          pg.max_degree)
    S = cfg.pool_size(N)

    def run(graph: PartitionedGraph, state: DistStreamState, base_key,
            k: int) -> Chunk:
        view = local_view(graph)
        base_key = tuple(int(x) for x in base_key)
        rank = _lane_ranks(N, S, graph.device)
        t = clock.now()
        work = bool((state.slots.active.sum() + torch.clamp(
            state.tail - state.head, min=0).sum()) > 0)
        sync_s = clock.now() - t
        ran = 0
        while work and ran < k:
            state, flag = _superstep_dist_stream(cap_, cfg, N, capacity,
                                                 base_key, view, rank, state)
            ran += 1
            t = clock.now()
            work = bool(flag)   # once per superstep
            sync_s += clock.now() - t
        return Chunk(state, ran, sync_s)

    return run


def shard_starts(starts, num_devices: int):
    """Round-robin shard start vertices across shards; returns the
    (N, q_loc) padded shard matrix and the (N, 1) per-shard counts (numpy).
    Query ``k`` of shard ``r`` is global query id ``k·N + r``."""
    starts = np.asarray(starts, dtype=np.int32).reshape(-1)
    N = num_devices
    q_loc = max((starts.shape[0] + N - 1) // N, 1)
    starts_sh = np.zeros((N, q_loc), dtype=np.int32)
    qcount = np.zeros((N, 1), dtype=np.int32)
    for r in range(N):
        part = starts[r::N]
        starts_sh[r, : part.size] = part
        qcount[r, 0] = part.size
    return starts_sh, qcount


def _run_distributed(pg: PartitionedGraph, starts, spec: SamplerSpec,
                     cfg: Optional[DistConfig] = None,
                     mesh: Optional[Mesh] = None, seed=0):
    """One-shot sharded run. Returns (DistLogs, WalkStats per shard)."""
    cfg = cfg or DistConfig()
    starts_sh, qcount = shard_starts(starts, pg.num_devices)
    run = make_distributed_engine(pg, spec, cfg, mesh)
    log_q, log_h, log_v, cursor, stats = run(
        pg, starts_sh, qcount, task_rng.stream_key(seed))
    logs = DistLogs(qid=log_q, hop=log_h, vertex=log_v, cursor=cursor)
    return logs, stats


def run_distributed(pg: PartitionedGraph, starts, spec: SamplerSpec,
                    cfg: Optional[DistConfig] = None,
                    mesh: Optional[Mesh] = None, seed=0):
    """Deprecated one-shot entry — use
    ``repro_torch.walker.compile(program, backend="sharded").run(...)``."""
    warnings.warn(
        "run_distributed is deprecated; use repro_torch.walker.compile("
        "program, backend='sharded').run(graph, starts) instead",
        DeprecationWarning, stacklevel=2)
    return _run_distributed(pg, starts, spec, cfg, mesh, seed)


def assemble_paths(logs: DistLogs, starts, max_hops: int):
    """Scatter the emission logs into per-query paths, on the logs'
    device: ``(paths (Q, max_hops+1), lengths (Q,))`` int32, paths -1
    padded."""
    dev = logs.qid.device
    starts = torch.as_tensor(np.asarray(starts, np.int32)).to(dev)
    Q = starts.shape[0]
    # Row Q is a spare that absorbs the log's empty (-1) entries.
    paths = torch.full((Q + 1, max_hops + 1), -1, dtype=torch.int32,
                       device=dev)
    lengths = torch.ones((Q + 1,), dtype=torch.int32, device=dev)
    paths[:Q, 0] = starts
    q = logs.qid.reshape(-1).long()
    h = logs.hop.reshape(-1).long()
    q = torch.where(q >= 0, q, Q)
    paths[q, torch.clamp(h, min=0)] = logs.vertex.reshape(-1)
    lengths.scatter_reduce_(0, q, (h + 1).to(torch.int32), "amax")
    return paths[:Q], lengths[:Q]
