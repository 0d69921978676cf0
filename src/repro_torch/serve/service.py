"""Open-system walk service on the streaming engine.

The closed-system engine drains a fixed query batch; a *service* faces
continuous arrivals from many tenants.  :class:`WalkService` wraps a
persistent walk stream (:class:`repro_torch.walker.WalkStream`; the
service only speaks the stream interface) and alternates two phases:

  admit   — pop free slots from the stream's ring and inject pending
            requests' start vertices (each walk gets an ``(epoch, qid)``
            identity: the slot id it occupies and that slot's reuse epoch
            — the multi-tenancy bookkeeping),
  run     — advance the engine a *chunk* of ``k`` supersteps, then
            harvest: any request whose every ``(epoch, qid)`` flipped
            ``done`` gets its recorded paths sliced out, its sojourn
            (submit→complete) and admission wait (submit→inject) logged,
            and its slots *released* back to the free ring with
            ``epoch + 1``.

The chunk size is the host-injection granularity: smaller chunks admit
arrivals sooner (lower sojourn) at the cost of more host↔device syncs —
the open-system analogue of the paper's §VI-A injection delay C.

Ring-buffer reclamation means the device buffer holds ``capacity`` *live*
queries and completed slots go around again immediately — there is no
drain barrier anywhere, so lanes stay busy across request boundaries
exactly as Theorem VI.1 prescribes for the closed pool.  Query ids repeat
across occupancies but ``(epoch, qid)`` is unique, and the RNG derivation
is salted with the epoch (`core.rng.task_fold`): epoch ``e`` of slot
``qid`` samples exactly the walk a closed batch run would sample for
query ``qid`` under ``rng.stream_key(seed, e)``.

Request bookkeeping (the pending queue, the in-flight map, the superstep
and wall clocks) lives on the host; the walk state lives on the stream's
device.  A harvest reads the done flags once, then copies each finished
request's paths to the host, so ``wall_completed`` is taken after the
device has produced them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.samplers import SamplerSpec
from repro_torch.core.scheduler import ServiceAnalysis, analyze_service
from repro_torch.core.tasks import WalkStats
from repro_torch.core.walk_engine import EngineConfig
from repro_torch.serve.scheduler import HopsController


@dataclasses.dataclass
class WalkRequest:
    """One tenant request: a batch of walk queries tracked as a unit."""

    request_id: int
    num_walks: int
    qids: Optional[np.ndarray] = None    # slot id per walk, once admitted
    epochs: Optional[np.ndarray] = None  # slot epoch per walk (RNG identity)
    submitted_at: int = -1     # service superstep clock at submit()
    admitted_at: int = -1      # ... at injection into the device slot ring
    completed_at: int = -1     # ... when the last walk terminated
    wall_submitted: float = 0.0
    wall_admitted: float = 0.0
    wall_completed: float = 0.0
    paths: Optional[np.ndarray] = None    # (num_walks, max_hops+1) once done
    lengths: Optional[np.ndarray] = None  # (num_walks,) once done

    @property
    def done(self) -> bool:
        return self.completed_at >= 0

    @property
    def sojourn(self) -> int:
        """Supersteps from submission to completion (open-system latency)."""
        return self.completed_at - self.submitted_at

    @property
    def admission_wait(self) -> int:
        """Supersteps from submission to slot-ring injection — the
        host-side queueing component of the sojourn (waiting for free
        slots); the rest is device time."""
        return self.admitted_at - self.submitted_at

    @property
    def wall_sojourn(self) -> float:
        return self.wall_completed - self.wall_submitted

    @property
    def wall_admission_wait(self) -> float:
        return self.wall_admitted - self.wall_submitted


class WalkService:
    """Multi-tenant streaming walk service over one graph + walk program.

    Typical use (the walker front end)::

        svc = walker.compile(WalkProgram.urw(80)).serve(graph)
        rid = svc.submit(start_vertices)        # non-blocking
        svc.step()                              # admit + run one chunk
        req = svc.poll(rid)                     # WalkRequest or None
        reqs = svc.drain()                      # run until all complete

    Construction forms:

    * ``WalkService(stream=walker.stream(g, ...), chunk=16)`` — over a
      prebuilt stream (what ``Walker.serve`` does).
    * ``WalkService(graph, program_or_spec, cfg, capacity, chunk, seed)`` —
      legacy direct form; builds a stream internally.  ``program_or_spec``
      may be a :class:`repro_torch.walker.WalkProgram` (machine knobs from
      ``execution``) or a bare :class:`~repro_torch.core.SamplerSpec` with
      an ``cfg`` :class:`~repro_torch.core.EngineConfig`.
    """

    def __init__(self, graph=None, program=None,
                 cfg: Optional[EngineConfig] = None,
                 capacity: int = 4096, chunk: int = 16, seed: int = 0,
                 execution=None, stream=None, adapt: bool = False,
                 controller=None):
        if stream is None:
            if graph is None or program is None:
                raise ValueError(
                    "WalkService needs either a prebuilt stream= or "
                    "(graph, program) to build one")
            from repro_torch.walker.compile import WalkStream
            from repro_torch.walker.execution import ExecutionConfig
            from repro_torch.walker.program import WalkProgram
            if isinstance(program, SamplerSpec):
                cfg = cfg or EngineConfig()
                execution = ExecutionConfig.from_engine_config(cfg)
                program = WalkProgram(spec=program, max_hops=cfg.max_hops)
            elif execution is None:
                execution = (ExecutionConfig() if cfg is None
                             else ExecutionConfig.from_engine_config(cfg))
            stream = WalkStream(program, execution, graph, capacity, seed)
        self.stream = stream
        self.graph = stream.graph if graph is None else graph
        self.capacity = stream.capacity
        self.chunk = int(chunk)
        self.clock = 0            # total supersteps advanced by this service
        # Online supersteps-per-launch adaptation (Theorem VI.1 loop):
        # observe the last launch's starved/bubble ratios, shrink or grow
        # self.chunk within the controller's bounds (serve.scheduler).
        if controller is not None:
            adapt = True
        self._controller = None
        if adapt:
            self._controller = controller or HopsController()
            self.chunk = self._controller.clamp(self.chunk)
        self._adaptation: List = []
        self._last_window_stats = None

        self._pending: deque[WalkRequest] = deque()   # submitted, not admitted
        self._pending_starts: Dict[int, np.ndarray] = {}
        self._inflight: Dict[int, WalkRequest] = {}
        self._completed: Dict[int, WalkRequest] = {}
        self._next_rid = 0

    # ------------------------------------------------------------ geometry

    @property
    def num_slots(self) -> int:
        """Walker lanes (service rate capacity)."""
        return self.stream.num_slots

    @property
    def max_hops(self) -> int:
        return self.stream.max_hops

    @property
    def cfg(self):
        """The stream's engine-layer config (EngineConfig)."""
        return self.stream.cfg

    # ------------------------------------------------------------- admission

    def submit(self, start_vertices) -> int:
        """Enqueue a request (a batch of walks); returns its request id."""
        sv = np.asarray(start_vertices, np.int32).reshape(-1)
        if sv.size == 0:
            raise ValueError("empty request")
        if sv.size > self.capacity:
            raise ValueError(
                f"request of {sv.size} walks exceeds slot-ring capacity "
                f"{self.capacity}; split it or raise capacity")
        rid = self._next_rid
        self._next_rid += 1
        req = WalkRequest(request_id=rid, num_walks=int(sv.size),
                          submitted_at=self.clock,
                          wall_submitted=time.perf_counter())
        self._pending.append(req)
        self._pending_starts[rid] = sv
        return rid

    def _admit(self) -> int:
        """FIFO-admit pending requests while free ring slots remain."""
        admitted = 0
        while self._pending:
            req = self._pending[0]
            if req.num_walks > self.stream.num_free:
                break  # head-of-line blocks until enough slots are released
            starts = self._pending_starts[req.request_id]
            req.qids, req.epochs = self.stream.inject(starts)
            req.admitted_at = self.clock
            req.wall_admitted = time.perf_counter()
            self._pending.popleft()
            del self._pending_starts[req.request_id]
            self._inflight[req.request_id] = req
            admitted += 1
        return admitted

    # ------------------------------------------------------------- execution

    def step(self, k: Optional[int] = None) -> int:
        """Admit pending requests, run one chunk of at most ``k``
        supersteps, harvest completions (releasing their slots back to the
        ring).  Returns the number of supersteps executed.

        With an adaptive controller attached (``adapt=True``), each
        launch's occupancy stats feed the Theorem VI.1 chunk controller,
        which may shrink/grow ``self.chunk`` for the *next* launch (an
        explicit ``k`` bypasses adaptation for this launch).
        """
        self._admit()
        if not self._inflight:
            return 0
        ran = self.stream.advance(self.chunk if k is None else int(k))
        self.clock += ran
        self._harvest()
        if self._controller is not None and k is None and ran > 0:
            self._adapt_chunk()
        return ran

    def _adapt_chunk(self) -> None:
        """Feed the last launch's occupancy window to the controller."""
        cur = self.stream.walk_stats()
        prev = self._last_window_stats
        self._last_window_stats = cur
        if prev is None:
            return
        slot_steps = cur.slot_steps - prev.slot_steps
        if slot_steps <= 0:
            return
        starved = (cur.starved - prev.starved) / slot_steps
        bubbles = (cur.bubbles - prev.bubbles) / slot_steps
        new_chunk, event = self._controller.propose(
            self.chunk, starved, bubbles, clock=self.clock)
        if event is not None:
            self._adaptation.append(event)
        self.chunk = new_chunk

    @property
    def adaptation(self) -> tuple:
        """The chunk-adaptation trace so far (AdaptationEvent tuple)."""
        return tuple(self._adaptation)

    def _harvest(self) -> None:
        done = self.stream.done_mask()
        finished: List[WalkRequest] = []
        for req in self._inflight.values():
            if done[req.qids].all():
                finished.append(req)
        for req in finished:
            req.paths, req.lengths = self.stream.harvest_ids(req.qids)
            req.completed_at = self.clock
            req.wall_completed = time.perf_counter()
            self.stream.release(req.qids)   # slots go around again (epoch+1)
            del self._inflight[req.request_id]
            self._completed[req.request_id] = req

    def drain(self) -> List[WalkRequest]:
        """Run until every submitted request has completed."""
        while self._pending or self._inflight:
            ran = self.step()
            if ran == 0 and not self._inflight and self._pending:
                # Admission made no progress with nothing in flight: the
                # ring is fully free, so the head request simply cannot fit.
                raise RuntimeError("service stalled: pending request cannot "
                                   "be admitted")
        return sorted(self._completed.values(),
                      key=lambda r: r.request_id)

    def reset_metrics(self) -> None:
        """Forget completed-request records and engine counters while
        keeping the superstep runner (and its hot-vertex cache) warm, so a
        benchmark sweep times several load points against one service.
        The stream is re-seeded so successive sweeps draw fresh walks."""
        if self._pending or self._inflight:
            raise RuntimeError("reset_metrics with requests outstanding")
        self.stream.reset(seed=self.stream.seed + 1)
        self.clock = 0
        self._completed.clear()
        self._adaptation.clear()
        self._last_window_stats = None

    # ------------------------------------------------------------ inspection

    def poll(self, request_id: int) -> Optional[WalkRequest]:
        """The completed WalkRequest, or None while still in flight."""
        return self._completed.get(request_id)

    def result(self, request_id: int) -> WalkRequest:
        """Block (stepping the engine) until ``request_id`` completes."""
        if (request_id not in self._completed
                and request_id not in self._inflight
                and all(r.request_id != request_id for r in self._pending)):
            raise KeyError(f"unknown request id {request_id}")
        while request_id not in self._completed:
            self.step()
        return self._completed[request_id]

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    @property
    def num_inflight(self) -> int:
        return len(self._inflight)

    @property
    def num_free_slots(self) -> int:
        return self.stream.num_free

    def walk_stats(self) -> WalkStats:
        """Engine counters since construction / reset (host ints)."""
        return self.stream.walk_stats()

    def sojourns(self) -> List[int]:
        return [r.sojourn for r in self._completed.values()]

    def admission_waits(self) -> List[int]:
        return [r.admission_wait for r in self._completed.values()]

    def analyze(self, offered_load: float = float("nan"),
                wall_time_s: Optional[float] = None) -> ServiceAnalysis:
        reqs = list(self._completed.values())
        mean_len = (float(np.mean([r.lengths.mean() for r in reqs]))
                    if reqs else float("nan"))
        return analyze_service(
            self.sojourns(), self.walk_stats(), self.num_slots,
            offered_load=offered_load, mean_walk_len=mean_len,
            wall_time_s=wall_time_s,
            admission_waits=self.admission_waits(),
            adaptation=self.adaptation)
