"""Sharded walk engine: N asynchronous "pipelines" = N shards (paper §IV:
16 pipelines over 32 HBM channels).

The shards lie in groups, each group's shards stacked along a leading
axis on its device (the mesh of `repro_torch.distributed.mesh`; one group
on the graph's device by default).  Per superstep each shard (a)
executes one *phase* of work for every live task homed on it, (b)
terminates finished walks and refills freed lanes from its local query
shard (zero-bubble scheduling), (c) routes every live task to the shard
that owns the data its next phase reads, with one all-to-all (the
butterfly, `router.py`).  All shards step together: one controller issues
each phase once a group (one flattened pass over the group's lanes, each
lane reading its shard's part of the graph through the group's stacked
view, :class:`LocalView`), and the collectives between phases copy
blocks between the groups' devices.  CUDA launches are asynchronous, but
the superstep is bound by the host, which issues every group's launches in
turn, and the peer copies between cards add to it: on four H100s a
superstep over 2 or 4 cards took 2-5x one card's (``PERF.md``).

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
the global done flag once per superstep (the groups' partial flags summed
on the first group's device, then read once), so the loop stops exactly
where the reference's ``while_loop`` stops.  A closed run's logs and
per-shard stats are returned on the first group's device.
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
from repro_torch.distributed.mesh import (Mesh, all_gather, check_devices,
                                          gather_first, psum, reduce_first)
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
    """One group's shards of a partitioned graph presented with the
    sampler interface: the group's arrays laid end to end.

    ``row_ptr`` holds each of the group's shards' ``V_loc + 1`` row
    pointers, offset by ``(shard - first_shard) · E_loc`` so that they
    address the flat ``col`` (and the edge payloads) directly;
    ``type_offsets`` holds each shard's rows with one spare row, so both
    per-vertex arrays share the stride ``rows_per_shard``.  ``num_shards``
    (N, every group's) makes the shared sampler arithmetic
    residency-aware: `samplers.vertex_row` maps a vertex id to ``(v % N -
    first_shard) · rows_per_shard + v // N``, its row in its owner's
    block.  A lane homed on the vertex's owner reads exactly what the
    reference's per-device view reads; the other lanes' reads are masked,
    as there, and clamped into the group's arrays."""
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
    first_shard: int = 0
    group_shards: int = 1


def local_view(pg: PartitionedGraph) -> list:
    """One stacked :class:`LocalView` a group of ``pg``, on its device."""
    views = []
    for grp in pg.groups:
        n, E_loc = grp.col.shape
        dev = grp.row_ptr.device
        off = torch.arange(n, dtype=torch.int32, device=dev)[:, None] * E_loc
        to = None
        if grp.type_offsets is not None:
            pad = torch.zeros((n, 1, grp.type_offsets.shape[2]),
                              dtype=grp.type_offsets.dtype, device=dev)
            to = torch.cat([grp.type_offsets, pad], 1).reshape(
                -1, grp.type_offsets.shape[2])

        def flat(x):
            return None if x is None else x.reshape(-1)
        views.append(LocalView(
            row_ptr=(grp.row_ptr + off).reshape(-1), col=flat(grp.col),
            weights=flat(grp.weights), alias_prob=flat(grp.alias_prob),
            alias_idx=flat(grp.alias_idx), max_degree=pg.max_degree,
            type_offsets=to, num_shards=pg.num_devices,
            rows_per_shard=pg.vertices_per_device + 1, num_edges=n * E_loc,
            first_shard=grp.first_shard, group_shards=n))
    return views


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
# holds one group's shards: the pool's fields are (n, S[, ...]), a shard's
# counters (n,); each step runs once a group, and the collectives join the
# groups.
# --------------------------------------------------------------------------


class _Group(NamedTuple):
    """What a superstep needs of one group: its view of the graph and the
    (n, S) global shard of each of its pool lanes."""
    view: LocalView
    rank: torch.Tensor


def _groups(graph: PartitionedGraph, S: int) -> list:
    out = []
    for view in local_view(graph):
        n, first = view.group_shards, view.first_shard
        rank = torch.arange(first, first + n, dtype=torch.int32,
                            device=view.row_ptr.device)[:, None].expand(n, S)
        out.append(_Group(view, rank))
    return out


def _flatten(slots):
    """(n, S, ...) pool → (n·S, ...) lanes, one pass of the step for all
    the group's shards."""
    return type(slots)(*(f.reshape(-1, *f.shape[2:]) for f in slots))


def _unflatten(slots, n: int):
    return type(slots)(*(f.reshape(n, -1, *f.shape[1:]) for f in slots))


def _zero_stats(n: int, device) -> WalkStats:
    """Per-shard counters: each field an (n,) int64 tensor."""
    return WalkStats(*(torch.zeros((n,), dtype=torch.int64, device=device)
                       for _ in WalkStats._fields))


def _step_group(cap, grp: _Group, slots, base_key):
    """Process: one phase for the group's locally-homed live tasks.
    Returns the pool and the (n, S) masks and records of the step."""
    shape = grp.rank.shape
    lanes = _flatten(slots)
    mine = lanes.active & (cap.home(lanes) == grp.rank.reshape(-1))
    out = cap.step(grp.view, lanes, mine, base_key)
    return (_unflatten(out.slots, shape[0]),
            *(x.view(shape) for x in (mine, out.adv, out.terminated,
                                      out.new_hop, out.v_next)))


def _write_log(logs, cap_log: int, cursor, adv, qid, hop, vertex):
    """Append one record per ``adv`` lane, in lane order, to each shard's
    emission log; returns the new cursor and each shard's records past
    ``cap_log`` (counted as drops).  ``logs`` are (n, cap_log + 1): the
    spare last column absorbs the lanes that record nothing."""
    pos = cursor[:, None] + torch.cumsum(adv.to(torch.int64), 1) - 1
    keep = adv & (pos < cap_log)
    p_safe = torch.where(keep, pos, cap_log)
    for log, val in zip(logs, (qid, hop, vertex)):
        log.scatter_(1, p_safe, torch.broadcast_to(val, p_safe.shape)
                     .to(log.dtype))
    n = adv.sum(1)
    return torch.clamp(cursor + n, max=cap_log), (adv & ~keep).sum(1)


def _pack(cap, cfg: DistConfig, N: int, slots):
    """Bucket every live task of a group for its next home."""
    K, R = cfg.bucket_cap(N), cfg.retention_cap(N)
    dest = cap.route_dest(slots)
    lane = torch.arange(cfg.pool_size(N), device=dest.device)
    priority = torch.where(lane >= N * K, 0, 1)  # retained tasks go first
    return router.pack_buckets(slots, dest, priority, N, K, R)


def _route(rrs: list) -> list:
    """Butterfly all-to-all of every group's buckets; each group's new
    pool is its incoming buckets, then its retention."""
    incoming = router.exchange([rr.send for rr in rrs])
    return [type(inc)(*(torch.cat([a, b], 1)
                        for a, b in zip(inc, rr.retention)))
            for inc, rr in zip(incoming, rrs)]


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


def _admission(cfg: DistConfig, N: int, slots, pending, n_active,
               global_live):
    """Flow-controlled refill ranks: each shard admits at most its fair
    share of the global headroom N·W_loc - live (``global_live``, the
    psum of every shard's ``n_active``), so system-wide live tasks never
    exceed N·W_loc — the bound the retention region is provisioned for
    (drops == 0 by construction, not by margin).  Returns (take, rank
    among the shard's free lanes)."""
    W_loc = cfg.slots_per_device
    slack = torch.clamp(N * W_loc - global_live, min=0)
    free = ~slots.active
    budget = torch.minimum(torch.clamp(W_loc - n_active, min=0), slack // N)
    avail = torch.minimum(torch.clamp(pending, min=0), budget)
    rank_free = torch.cumsum(free.to(torch.int64), 1) - 1
    return free & (rank_free < avail[:, None]), rank_free


class _Closed(NamedTuple):
    """One group's closed-run state: pool, per-shard query heads,
    emission logs and cursors, stats."""
    slots: Any
    head: torch.Tensor
    log_q: torch.Tensor
    log_h: torch.Tensor
    log_v: torch.Tensor
    cursor: torch.Tensor
    stats: WalkStats


def _superstep_dist(cap, cfg: DistConfig, N: int, base_key, groups, inputs,
                    carry):
    """One closed superstep over every shard of every group.  ``inputs``
    are each group's ``(starts_loc (n, q_loc), qcount (n,), seeds)``, its
    shards' query shards and refill seeds; ``carry`` each group's
    :class:`_Closed`.  Returns the new carry and the global done flag (a
    (1,) bool tensor on the first group's device)."""
    stepped = []
    for grp, c in zip(groups, carry):
        slots, mine, adv, terminated, new_hop, v_next = _step_group(
            cap, grp, c.slots, base_key)
        # ---- emission log (streaming write-back, paper §IV-B) -----------
        # Runs before the terminated lanes' query_id is cleared (the final
        # hop of a walk is still a recorded visit).
        cursor, log_drop = c.cursor, torch.zeros_like(c.head)
        if cfg.record_paths:
            cursor, log_drop = _write_log(
                (c.log_q, c.log_h, c.log_v), cfg.log_capacity, cursor, adv,
                torch.where(adv, slots.query_id, -1), new_hop, v_next)
        slots = slots._replace(
            query_id=torch.where(terminated, -1, slots.query_id),
            active=slots.active & ~terminated,
        )
        stepped.append((slots, mine, adv, terminated, cursor, log_drop))

    # ---- zero-bubble refill, flow-controlled to the global live bound ---
    n_active = [st[0].active.sum(1) for st in stepped]
    global_live = psum(n_active)
    refilled, rrs = [], []
    for grp, (starts_loc, qcount, seeds), c, st, n_act, live in zip(
            groups, inputs, carry, stepped, n_active, global_live):
        slots = st[0]
        take, rank_free = _admission(cfg, N, slots, qcount - c.head, n_act,
                                     live)
        k_local = c.head[:, None] + rank_free
        k_safe = torch.clamp(k_local, 0, starts_loc.shape[1] - 1)
        # Refill seeds: the plain engine admits hop-0 tasks at the start
        # vertex; a hop-0 prescan capability seeds hop-1 tasks (v_prev =
        # the start) and skips queries the prescan already terminated
        # (`enter`).
        seed_vc, seed_vp, seed_hop, seed_enter = (x.gather(1, k_safe)
                                                  for x in seeds)
        adm = take & seed_enter  # admitted to the pool
        slots = slots._replace(
            v_curr=torch.where(adm, seed_vc, slots.v_curr),
            v_prev=torch.where(adm, seed_vp, slots.v_prev),
            # Query ids are global: query k of shard r is k·N + r.
            query_id=torch.where(adm, (k_local * N + grp.rank)
                                 .to(torch.int32), slots.query_id),
            hop=torch.where(adm, seed_hop, slots.hop),
            active=slots.active | adm,
            epoch=torch.where(adm, 0, slots.epoch),  # closed batch == 0
        )
        slots = cap.reset_extras(slots, adm)
        refilled.append(c.head + take.sum(1))
        # ---- route: bucket every live task for its next home ------------
        rrs.append(_pack(cap, cfg, N, slots))

    # ---- route: butterfly all-to-all to each task's next home -----------
    pools = _route(rrs)

    # ---- stats + global termination -------------------------------------
    out, work = [], []
    for (_, qcount, _), c, st, head, slots, rr in zip(
            inputs, carry, stepped, refilled, pools, rrs):
        _, mine, adv, terminated, cursor, log_drop = st
        stats = _add_stats(c.stats, cfg, mine, adv, terminated,
                           (head < qcount).to(torch.int64), rr.waits,
                           rr.drops + log_drop)
        remaining = torch.clamp(qcount - head, min=0)
        work.append(slots.active.sum(1) + remaining)
        out.append(c._replace(slots=slots, head=head, cursor=cursor,
                              stats=stats))
    return out, reduce_first(work, torch.sum) == 0


def _run_hop0_prescan(cap, cfg: DistConfig, N: int, groups, starts,
                      qcounts, base_key, logs):
    """One-time batched hop-0 pass for prescan capabilities (closed engine).

    Every query's hop-0 scan runs once, on its start vertex's owner (the
    reference gathers the global query list on every device and each scans
    the starts it owns); the owner logs the resulting (qid, 1, v1) record
    in its emission log, in global query-list order, and the hop-1 refill
    seeds go back to the shard staging each query.  Runs before the
    superstep loop — O(Q) work once instead of a full reservoir scan in
    every superstep.  ``starts``, ``qcounts`` and ``logs`` are per group;
    returns each group's ``(seeds, cursor, stats)``.
    """
    q_loc = starts[0].shape[1]
    starts_all = all_gather(starts)                     # (N, q_loc) a group
    qcount_all = all_gather(qcounts)
    out, sums = [], []
    for grp, s_all, qc_all, (log_q, log_h, log_v) in zip(
            groups, starts_all, qcount_all, logs):
        dev = s_all.device
        first, n = grp.view.first_shard, grp.view.group_shards
        ks = torch.arange(q_loc, dtype=torch.int32, device=dev)
        ranks = torch.arange(N, dtype=torch.int32, device=dev)
        qid_all = (ks[None, :] * N + ranks[:, None]).reshape(-1)
        valid = (ks[None, :] < qc_all[:, None]).reshape(-1)
        sflat = s_all.reshape(-1)
        owner = owner_of(sflat, N)
        if n < N:   # the starts another group owns are its to scan
            valid = valid & (owner >= first) & (owner < first + n)
        v1, adv0, term0, enter = cap.prescan_hop0(grp.view, sflat, qid_all,
                                                  valid, base_key)
        own = owner[None, :] == grp.rank[:, :1]             # (n, N·q_loc)

        # The owner that computed each hop-1 vertex logs its (qid, 1, v1)
        # record — same emission-log discipline as the superstep.
        log_drop = torch.zeros((n,), dtype=torch.int64, device=dev)
        cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
        rec = own & adv0[None, :]
        if cfg.record_paths:
            cursor, log_drop = _write_log(
                (log_q, log_h, log_v), log_q.shape[1] - 1, cursor, rec,
                torch.where(rec, qid_all, -1), torch.ones_like(qid_all), v1)
        stats0 = _zero_stats(n, dev)._replace(
            steps=rec.sum(1), terminations=(own & term0[None, :]).sum(1),
            drops=log_drop)
        out.append((cursor, stats0))
        sums.append((v1, enter))

    # Each query has exactly one owner, so its hop-1 seeds are the owner's
    # result (the reference's psum of owner-masked values).
    if len(groups) > 1:
        # v1 + 1 where the owner entered it, else 0: one psum carries both.
        tot = psum([torch.where(e, v + 1, 0).view(1, N, q_loc)
                    for v, e in sums])
        sums = [(torch.where(t[0] > 0, t[0] - 1, 0), t[0] > 0) for t in tot]
    else:
        sums = [(torch.where(e, v, 0).view(N, q_loc), e.view(N, q_loc))
                for v, e in sums]
    res = []
    for grp, st, (v1, enter), (cursor, stats0) in zip(groups, starts, sums,
                                                      out):
        rows = slice(grp.view.first_shard,
                     grp.view.first_shard + grp.view.group_shards)
        seeds = (v1[rows], st, torch.ones_like(st), enter[rows])
        res.append((seeds, cursor, stats0))
    return res


def _check_typed(pg: PartitionedGraph, spec: SamplerSpec) -> None:
    if "typed" not in lower(spec).requires:
        return
    to = pg.groups[0].type_offsets
    if to is None:
        raise ValueError(
            "metapath programs need type_offsets partitioned with the "
            "graph — build the CSRGraph with num_edge_types > 0 before "
            "partition_graph")
    if max(spec.metapath) >= to.shape[-1] - 1:
        raise ValueError(
            f"metapath schedule {spec.metapath} names an edge type the "
            f"graph lacks (it has {to.shape[-1] - 1})")


def _check_mesh(mesh: Optional[Mesh], pg: PartitionedGraph) -> None:
    if mesh is None:
        return
    if mesh.num_shards != pg.num_devices:
        raise ValueError(f"the mesh has {mesh.num_shards} shards, the graph "
                         f"{pg.num_devices}")
    devices = check_devices(mesh.devices)
    if devices != pg.devices:
        raise ValueError(f"the mesh places its groups on {devices}, the "
                         f"graph on {pg.devices}")


def make_distributed_engine(pg: PartitionedGraph, spec: SamplerSpec,
                            cfg: DistConfig, mesh: Optional[Mesh] = None):
    """Build the closed sharded runner ``run(graph, starts_sharded,
    qcount, base_key) -> (log_q, log_h, log_v, cursor, stats)`` for graphs
    shaped like ``pg``: the emission logs (N, log_capacity), each shard's
    cursor (N,) and per-shard `WalkStats` (each field (N,)), all on the
    first group's device.

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
        groups = _groups(graph, S)
        base_key = tuple(int(x) for x in base_key)
        starts_all = torch.as_tensor(starts_sharded, dtype=torch.int32)
        qcount_all = torch.as_tensor(qcount).reshape(-1).to(torch.int64)
        cap_log = cfg.log_capacity if cfg.record_paths else 1
        inputs, carry, logs = [], [], []
        for grp in groups:
            dev = grp.rank.device
            n, first = grp.view.group_shards, grp.view.first_shard
            starts_l = starts_all[first:first + n].to(dev)
            qcount_l = qcount_all[first:first + n].to(dev)
            log = tuple(torch.full((n, cap_log + 1), -1, dtype=torch.int32,
                                   device=dev) for _ in range(3))
            # Default refill seeds: hop-0 tasks at the start vertex.
            seeds = (starts_l, torch.full_like(starts_l, -1),
                     torch.zeros_like(starts_l),
                     torch.ones(starts_l.shape, dtype=torch.bool,
                                device=dev))
            inputs.append((starts_l, qcount_l, seeds))
            logs.append(log)
            carry.append(_Closed(
                _unflatten(cap.empty_pool(n * S, dev), n),
                torch.zeros((n,), dtype=torch.int64, device=dev), *log,
                torch.zeros((n,), dtype=torch.int64, device=dev),
                _zero_stats(n, dev)))
        if cap.prescan:
            # ---- one-time batched hop-0 local scan (out of the
            # per-superstep critical path; see ProgramCapability) ------
            pre = _run_hop0_prescan(cap, cfg, N, groups,
                                    [x[0] for x in inputs],
                                    [x[1] for x in inputs], base_key, logs)
            inputs = [(s, q, seeds) for (s, q, _), (seeds, _, _) in
                      zip(inputs, pre)]
            carry = [c._replace(cursor=cursor, stats=stats) for c, (
                _, cursor, stats) in zip(carry, pre)]
        t = 0
        while True:   # the reference's while_loop: done or max_supersteps
            carry, done = _superstep_dist(cap, cfg, N, base_key, groups,
                                          inputs, carry)
            t += 1
            if t >= cfg.max_supersteps or bool(done):
                break
        stats = WalkStats(*(gather_first(f) for f in
                            zip(*(c.stats for c in carry))))
        return (*(gather_first([getattr(c, f)[:, :cap_log] for c in carry])
                  for f in ("log_q", "log_h", "log_v")),
                gather_first([c.cursor for c in carry]), stats)

    return run


# --------------------------------------------------------------------------
# Open-system (streaming) sharded engine: persistent sharded state, chunked
# supersteps, host injection between chunks — the sharded realization of
# the ring-buffer slot economy (core/walk_engine.py).  The same capability
# dispatch, flow-controlled refill, and butterfly routing as the closed
# engine; only arrival/injection and harvest differ.
# --------------------------------------------------------------------------


class DistStreamState(NamedTuple):
    """Persistent sharded stream state of one group; every field's
    leading axis is the group's shard (channel) axis.

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

    slots: Any                  # capability task word, fields (n, S, ...)
    ring_start: torch.Tensor    # (n, cap) int32 — start vertex by arrival seq
    ring_qid: torch.Tensor      # (n, cap) int32 — slot id by arrival seq
    ring_epoch: torch.Tensor    # (n, cap) int32 — occupant epoch
    head: torch.Tensor          # (n,) int64 — monotone per-shard issue count
    tail: torch.Tensor          # (n,) int64 — monotone per-shard arrivals
    paths: torch.Tensor         # (n, cap+1, max_hops+1) int32
    lengths: torch.Tensor       # (n, cap+1) int32
    done: torch.Tensor          # (n, cap+1) bool — terminated, by slot id
    stats: WalkStats            # fields (n,)


def init_dist_stream_state(pg: PartitionedGraph, spec: SamplerSpec,
                           cfg: DistConfig, capacity: int) -> list:
    """Empty sharded open-system state, one :class:`DistStreamState` a
    group on its device, with room for ``capacity`` live queries (global
    slot ids 0..capacity-1, shared across shards)."""
    N = pg.num_devices
    cap_ = get_capability(spec, cfg, N, pg.vertices_per_device,
                          pg.max_degree)
    states = []
    for n, dev in zip((g.row_ptr.shape[0] for g in pg.groups), pg.devices):
        def zeros(shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        states.append(DistStreamState(
            slots=_unflatten(cap_.empty_pool(n * cfg.pool_size(N), dev), n),
            ring_start=zeros((n, capacity)), ring_qid=zeros((n, capacity)),
            ring_epoch=zeros((n, capacity)),
            head=zeros((n,), torch.int64), tail=zeros((n,), torch.int64),
            paths=torch.full((n, capacity + 1, cfg.max_hops + 1), -1,
                             dtype=torch.int32, device=dev),
            lengths=zeros((n, capacity + 1)),
            done=zeros((n, capacity + 1), torch.bool),
            stats=_zero_stats(n, dev),
        ))
    return states


def inject_stream_queries(states: list, starts_blk, qid_blk, epoch_blk,
                          counts) -> list:
    """Stage arrival blocks into the per-shard rings (host→device).

    ``starts_blk``/``qid_blk``/``epoch_blk`` are (N, B) host blocks; row
    r's first ``counts[r]`` entries are real arrivals for shard r, the
    rest padding that is never written.  Recycled slots' ``done`` bits and
    path rows are cleared on *every* shard of every group — an old
    occupant's hops may have been recorded anywhere.  Writes each group's
    state in place; returns them.
    """
    N = sum(st.ring_qid.shape[0] for st in states)
    cap = states[0].ring_qid.shape[1]
    counts = np.asarray(counts, np.int64).reshape(N)
    B = np.asarray(qid_blk).shape[1]
    if counts.min(initial=0) < 0 or counts.max(initial=0) > B:
        raise ValueError(f"counts must lie in [0, {B}], got {counts}")
    idx = np.arange(B)[None, :]
    valid = idx < counts[:, None]
    rows, cols = np.nonzero(valid)
    block = np.stack([rows, cols] + [np.asarray(x, np.int64)[valid] for x in
                                     (starts_blk, qid_blk, epoch_blk)])
    qids = block[3]
    if qids.size and not (0 <= qids.min() and qids.max() < cap):
        raise ValueError(f"slot ids must lie in [0, {cap}), got "
                         f"[{qids.min()}, {qids.max()}]")
    first = 0
    for st in states:
        n, dev = st.ring_qid.shape[0], st.tail.device
        mine = (block[0] >= first) & (block[0] < first + n)
        part = block[:, mine]
        part[0] -= first
        r, c, start, qid, epoch = torch.from_numpy(part).to(dev).unbind()
        pos = (st.tail[r] + c) % cap
        st.ring_start[r, pos] = start.to(torch.int32)
        st.ring_qid[r, pos] = qid.to(torch.int32)
        st.ring_epoch[r, pos] = epoch.to(torch.int32)
        every = qid if n == N else torch.from_numpy(qids).to(dev)
        st.done[:, every] = False
        st.paths[:, every, :] = -1
        st.lengths[:, every] = 0
        st.tail.add_(torch.from_numpy(counts[first:first + n]).to(dev))
        first += n
    return states


def _superstep_dist_stream(cap, cfg: DistConfig, N: int, capacity: int,
                           base_key, groups, states):
    """One streaming superstep: phase-step → path/done scatter → terminate
    → flow-controlled ring refill → butterfly route (mirrors
    `_superstep_dist`, with the arrival ring in place of the start shard
    and scatter windows in place of the emission log).  Returns each
    group's state and the global work flag (a (1,) bool tensor on the
    first group's device)."""
    stepped = []
    for grp, st in zip(groups, states):
        rows = torch.arange(grp.rank.shape[0], device=grp.rank.device)[:, None]
        slots, mine, adv, terminated, new_hop, v_next = _step_group(
            cap, grp, st.slots, base_key)
        # ---- streaming write-back: scatter executed hops locally --------
        sq = torch.where(adv, slots.query_id, capacity).long()  # spare row
        st.paths[rows, sq, new_hop.long()] = v_next
        st.lengths[rows, sq] = new_hop + 1
        st.done[rows, torch.where(terminated, slots.query_id,
                                  capacity).long()] = True
        slots = slots._replace(
            query_id=torch.where(terminated, -1, slots.query_id),
            active=slots.active & ~terminated,
        )
        stepped.append((slots, mine, adv, terminated, rows))

    # ---- zero-bubble refill from the local arrival ring, flow-controlled
    # to the global live bound N·W_loc (the closed engine's coordination,
    # so losslessness carries over to the open system) -------------------
    n_active = [x[0].active.sum(1) for x in stepped]
    global_live = psum(n_active)
    heads, rrs = [], []
    for st, x, n_act, live in zip(states, stepped, n_active, global_live):
        slots, rows = x[0], x[4]
        take, rank_free = _admission(cfg, N, slots, st.tail - st.head,
                                     n_act, live)
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
        heads.append(st.head + take.sum(1))
        # Record hop 0 on the staging shard; the route below hands the task
        # to owner(start_vertex) for its first hop.
        sq = torch.where(take, qid, capacity).long()
        st.paths[rows, sq, 0] = start
        st.lengths[rows, sq] = 1
        rrs.append(_pack(cap, cfg, N, slots))

    # ---- route: butterfly all-to-all to each task's next home -----------
    pools = _route(rrs)

    # ---- stats + global work flag ---------------------------------------
    out, work = [], []
    for st, x, head, slots, rr in zip(states, stepped, heads, pools, rrs):
        _, mine, adv, terminated, _ = x
        stats = _add_stats(st.stats, cfg, mine, adv, terminated,
                           (head < st.tail).to(torch.int64), rr.waits,
                           rr.drops)
        work.append(slots.active.sum(1) + torch.clamp(st.tail - head, min=0))
        out.append(st._replace(slots=slots, head=head, stats=stats))
    return out, reduce_first(work, torch.sum) > 0


def make_sharded_stream_engine(pg: PartitionedGraph, spec: SamplerSpec,
                               cfg: DistConfig, mesh: Optional[Mesh] = None,
                               capacity: int = 4096):
    """Build ``run(graph, states, base_key, k) -> Chunk`` (the single
    engine's: the groups' states, the supersteps run, the seconds blocked
    in the work-flag read) advancing the sharded stream by at most ``k``
    supersteps, stopping early when no work remains on any shard (the
    flag, summed over the groups on the first group's device, is read once
    before the first superstep and once after each).  The host injects
    with :func:`inject_stream_queries` between chunks and harvests by
    max-folding the per-shard path windows.
    """
    N = pg.num_devices
    _check_mesh(mesh, pg)
    _check_typed(pg, spec)
    cap_ = get_capability(spec, cfg, N, pg.vertices_per_device,
                          pg.max_degree)
    S = cfg.pool_size(N)

    def run(graph: PartitionedGraph, states: list, base_key,
            k: int) -> Chunk:
        groups = _groups(graph, S)
        base_key = tuple(int(x) for x in base_key)
        t = clock.now()
        work = bool(reduce_first([st.slots.active.sum(1)
                                  + torch.clamp(st.tail - st.head, min=0)
                                  for st in states], torch.sum) > 0)
        sync_s = clock.now() - t
        ran = 0
        while work and ran < k:
            states, flag = _superstep_dist_stream(cap_, cfg, N, capacity,
                                                  base_key, groups, states)
            ran += 1
            t = clock.now()
            work = bool(flag)   # once per superstep
            sync_s += clock.now() - t
        return Chunk(states, ran, sync_s)

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
