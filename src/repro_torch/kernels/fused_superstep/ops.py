"""Wrapper of the fused superstep CUDA kernel.

:func:`fused_superstep` advances the engine's :class:`StreamState` by at
most ``k`` supersteps in one launch: one cooperative grid that spans the
card, its blocks and threads (:func:`grid`) sized by the occupancy API
for the launch's kernel instantiation and shared memory, so every block is
resident and the blocks meet at one grid barrier a superstep (two for the
reservoir, one more with a cache; see ``csrc/fused_superstep.cu``).  A
launch the card refuses raises.  It checks every tensor (device,
dtype, shape, contiguity) and raises on anything the kernel does not take.
For tensors on the CPU it runs the plain version in ``ref.py``; for CUDA
tensors it launches the kernel on PyTorch's current stream or raises —
there is no fallback.

The launch updates every state tensor **in place**, on the card and on
the CPU alike.  The state's scalars (queue counters, the 12 stats, the
controller's head history) live in one int64 *control block*: a drain
calls :func:`pack` once, which moves them into a new block and returns
the state viewing it, passes the block to every launch, and reads
:func:`progress` (the block's first two words: work left, supersteps)
between launches.  A stream packs its state once, when it is made, and
keeps that block for its life: an injection writes ``tail`` in place
through its view, and :func:`rearm` sets the work word from the state
before the runner's first read, since only a launch writes it otherwise.
Only this module and the kernel's source know the block's layout.  ``LAUNCHES`` counts kernel launches (nothing else adds to
it), so a run can show that it went through the kernel.

A hot-vertex cache (`repro_torch.graph.hot_cache`) rides along as a
:class:`CacheBlock`: its packed block in one int32 tensor on the run's
device, made once by :func:`cache_block`.  The kernel stages a block that
fits in a thread block's shared memory there at the start of each launch,
and reads a larger one in place in device memory (:func:`cache_tier`
says which); the plain version adds the same three counters.

The reservoir kind stages each (lane, chunk) item's columns and weights
through a ``cp.async`` ping-pong in shared memory, which ``schedule.py``
declares for the DMA pass; :func:`trace_schedule` launches with one warp
recording what it issues, to hold the kernel to that declaration.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import walk_engine as engine
from repro_torch.core.samplers import bisect_iters, n2v_constants
from repro_torch.core.tasks import WalkStats
from repro_torch.kernels import build
from repro_torch.kernels.fused_superstep import ref
from repro_torch.kernels.fused_superstep.schedule import (
    TRACE_CAP, TRACE_HEADER, TRACE_WARP, ScheduleTrace, decode_trace)

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES = {"fused_superstep": 0}

# Control block layout (int64 words).
CTL_WORK, CTL_SUPERSTEPS = 0, 1   # written by every launch; the host's read
CTL_QUEUE = 2                     # head, staged, tail
CTL_STATS = 5                     # the WalkStats counters, in field order
CTL_HIST = CTL_STATS + len(WalkStats._fields)   # head_hist, C+1 words

#: Sampler kinds the kernel runs, and their template ids in the source.
KINDS = {"uniform": 0, "alias": 1, "metapath": 2, "rejection_n2v": 3,
         "reservoir_n2v": 4}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_ARGTYPES = ([_P] * 22 + [_L] + [_I] * 9 + [_L] + [ctypes.c_uint] * 2
             + [_F] * 4 + [_I] * 17 + [_P, _P])

#: Records a schedule trace keeps (:func:`trace_schedule`).
TRACE_CAPACITY = 4_096

#: The packed edge payloads of a cache block after ``col``, in order.
_CACHE_PAYLOADS = ("weights", "alias_prob", "alias_idx")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class CacheBlock:
    """A hot-vertex cache's packed block on one device, as the kernel reads
    it: ``words`` (int32, ``nbytes() / 4`` of them) holds hot_ids (H),
    hot_deg (H), hot_off (H + 1), col (P) from word ``3H + 1``, then the
    payloads the cache packs, each at its word offset (-1 where absent):
    ``weights``, ``alias_prob``, ``alias_idx`` (P each, floats as their
    bits) and ``type_offsets`` (H rows of ``type_stride`` = T + 1)."""

    words: torch.Tensor
    num_hot: int
    num_entries: int
    probe_trips: int
    type_stride: int
    weights: int
    alias_prob: int
    alias_idx: int
    type_offsets: int

    @property
    def hot_ids(self) -> torch.Tensor:
        return self.words[:self.num_hot]

    @property
    def col(self) -> int:
        return 3 * self.num_hot + 1

    def nbytes(self) -> int:
        return 4 * self.words.numel()


def cache_block(cache, device) -> CacheBlock:
    """The packed block of ``cache`` (a `HotVertexCache`) on ``device``:
    one host-to-device copy, made once per engine and device."""
    parts = [cache.hot_ids, cache.hot_deg, cache.hot_off, cache.col]
    offsets, at = {}, sum(p.size for p in parts)
    for name in (*_CACHE_PAYLOADS, "type_offsets"):
        arr = getattr(cache, name)
        offsets[name] = -1 if arr is None else at
        if arr is not None:
            parts.append(np.ascontiguousarray(arr).reshape(-1).view(np.int32))
            at += arr.size
    words = torch.from_numpy(np.concatenate(parts).astype(np.int32, copy=False))
    to = cache.type_offsets
    return CacheBlock(words=words.to(device), num_hot=cache.num_hot,
                      num_entries=cache.num_entries,
                      probe_trips=cache.probe_trips,
                      type_stride=0 if to is None else int(to.shape[1]),
                      **offsets)


def _usable(spec, graph, cache):
    """``cache``, or ``None`` when it lacks a payload the kind reads: the
    alias tables, the typed offsets, or a weighted graph's weights for the
    reservoir.  A cache without them is dropped, not half used."""
    if cache is None:
        return None
    needed = {"alias": ("alias_prob", "alias_idx"),
              "metapath": ("type_offsets",)}.get(spec.kind, ())
    if spec.kind == "reservoir_n2v" and graph.weights is not None:
        needed = ("weights",)
    return None if any(getattr(cache, p) < 0 for p in needed) else cache


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int, kind: int, stop: bool, record: bool,
                static_mode: bool) -> int:
    fn = build.load("fused_superstep").fused_superstep_smem_limit
    fn.argtypes, fn.restype = [_I] * 4, _I
    with torch.cuda.device(device_index):
        limit = fn(kind, int(stop), int(record), int(static_mode))
    if limit < 0:
        raise RuntimeError(f"fused_superstep_smem_limit failed: cudaError "
                           f"{-limit}")
    return limit


def smem_limit(spec, cfg, device) -> int:
    """The dynamic shared memory (bytes) that a cache's block can take in
    the kernel's instantiation for ``spec`` × ``cfg`` on CUDA ``device``:
    the device's opt-in limit per block less the instantiation's static
    shared memory and its staging slots (the reservoir kind's two
    ``cp.async`` slots a warp, 32 KiB a block, come first; the kernel's
    ``stage_bytes``)."""
    device = torch.device(device)
    return _smem_limit(device.index if device.index is not None
                       else torch.cuda.current_device(), KINDS[spec.kind],
                       spec.stop_prob > 0, cfg.record_paths,
                       cfg.mode == "static")


class Grid(NamedTuple):
    """A launch's grid: ``blocks`` of ``threads``, ``per_sm`` blocks
    resident on a multiprocessor, and the ``scratch_bytes`` it needs."""

    blocks: int
    threads: int
    per_sm: int
    scratch_bytes: int


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, kind: int, stop: bool, record: bool,
          static_mode: bool, width: int, smem: int, delay: int):
    fn = build.load("fused_superstep").fused_superstep_grid
    fn.argtypes, fn.restype = [_I] * 7 + [_P], _I
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device_index):
        rc = fn(kind, int(stop), int(record), int(static_mode), width, smem,
                delay, out)
    if rc != 0:
        raise RuntimeError(f"fused_superstep_grid failed: cudaError {rc}")
    return Grid(*out)


def grid(spec, cfg, device, cache: CacheBlock | None = None) -> Grid:
    """The grid of a launch for ``spec`` × ``cfg`` on CUDA ``device`` with
    ``cache`` (a block the kind can use, or ``None``)."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    smem = (4 * _staged_words(spec, cfg, cache) + 15) // 16 * 16
    return _grid(index, KINDS[spec.kind], spec.stop_prob > 0,
                 cfg.record_paths, cfg.mode == "static", cfg.num_slots, smem,
                 cfg.injection_delay)


def _staged_words(spec, cfg, cache) -> int:
    """The words of ``cache``'s block that each launch stages into shared
    memory, after the kind's staging slots (which the kernel adds to the
    launch's dynamic shared memory itself): all of them in the shared tier,
    none in the global tier."""
    if cache is None or cache_tier(spec, cfg, cache) != "shared":
        return 0
    return cache.words.numel()


def cache_tier(spec, cfg, cache: CacheBlock) -> str:
    """Where the kernel reads the block of ``cache`` (on a CUDA device) for
    ``spec`` × ``cfg``: ``"shared"`` when it fits in :func:`smem_limit`,
    where each launch stages it; else ``"global"``, read in place in
    device memory by the same kernel."""
    device = cache.words.device
    if device.type != "cuda":
        raise ValueError(f"a cache tier is the card's: the block is on "
                         f"{device}")
    return ("shared" if cache.nbytes() <= smem_limit(spec, cfg, device)
            else "global")


def _scalars(state):
    return (state.queue.head, state.queue.staged, state.queue.tail,
            *state.stats)


def pack(state):
    """``(state, block)``: a new control block on the state's device that
    holds the progress pair, the state's scalars and its head history,
    and ``state`` with those scalars replaced by views of the block."""
    words = [engine._work_left(state), state.stats.supersteps, *_scalars(state)]
    block = torch.cat([torch.stack([t.to(torch.int64) for t in words]),
                       state.head_hist.to(torch.int64)])
    q = state.queue
    packed = state._replace(
        queue=q._replace(head=block[CTL_QUEUE], staged=block[CTL_QUEUE + 1],
                         tail=block[CTL_QUEUE + 2]),
        stats=WalkStats(*block[CTL_STATS:CTL_HIST].unbind()),
        head_hist=block[CTL_HIST:])
    return packed, block


def rearm(state, block) -> None:
    """Set ``block``'s work word from ``state`` (on the device, with no
    read), so that arrivals injected since the last launch count as work
    left."""
    block[CTL_WORK] = engine._work_left(state)


def progress(block) -> tuple[bool, int]:
    """(work left, supersteps run): one device-to-host read of the
    block's first two words."""
    more, supersteps = block[:2].tolist()
    return bool(more), int(supersteps)


def _check(graph, spec, cfg, depth, state, key, k, block,
           cache) -> torch.device:
    """Every tensor on one device, of the kernel's dtype and shape, and
    contiguous; the state's scalars views of ``block``; the scalars in
    int32 range; a cache's block as its sizes say.  Returns the device."""
    s, q = state.slots, state.queue
    W, Q, H = cfg.num_slots, q.capacity, cfg.max_hops
    i32, i64 = torch.int32, torch.int64
    want = {f"slots.{f}": (getattr(s, f), i32, (W,))
            for f in ("v_curr", "v_prev", "query_id", "hop", "epoch")}
    want["slots.active"] = (s.active, torch.bool, (W,))
    for f in ("start_vertex", "order", "epoch"):
        want[f"queue.{f}"] = (getattr(q, f), i32, (Q,))
    for f in ("head", "staged", "tail"):
        want[f"queue.{f}"] = (getattr(q, f), i64, ())
    for f in WalkStats._fields:
        want[f"stats.{f}"] = (getattr(state.stats, f), i64, ())
    want["head_hist"] = (state.head_hist, i64, (cfg.injection_delay + 1,))
    want["block"] = (block, i64, (CTL_HIST + cfg.injection_delay + 1,))
    want["done"] = (state.done, torch.bool, (Q,))
    rec = cfg.record_paths
    want["paths"] = (state.paths, i32, (Q, H + 1) if rec else (1, 1))
    want["lengths"] = (state.lengths, i32, (Q,) if rec else (1,))
    V, E = graph.num_vertices, graph.num_edges
    want["graph.row_ptr"] = (graph.row_ptr, i32, (V + 1,))
    want["graph.col"] = (graph.col, i32, (E,))
    if spec.kind == "alias":
        if not graph.has_alias:
            raise ValueError("alias sampling needs the graph's alias tables")
        want["graph.alias_prob"] = (graph.alias_prob, torch.float32, (E,))
        want["graph.alias_idx"] = (graph.alias_idx, i32, (E,))
    if spec.kind == "metapath":
        to = graph.type_offsets
        if to is None or to.dim() != 2 or max(spec.metapath) + 2 > to.shape[1]:
            raise ValueError(
                f"metapath schedule {spec.metapath} needs type_offsets of "
                f"shape (V, T+1) with T > {max(spec.metapath)}")
        want["graph.type_offsets"] = (to, i32, (V, to.shape[1]))
    if spec.kind == "reservoir_n2v" and graph.weights is not None:
        want["graph.weights"] = (graph.weights, torch.float32, (E,))
    if cache is not None:
        if cache.num_hot < 1 or cache.num_entries < 1 or cache.probe_trips < 1:
            raise ValueError("a cache holds at least one vertex and entry")
        if spec.kind == "metapath" and cache.type_stride != to.shape[1]:
            raise ValueError(f"the cache's type_offsets rows have "
                             f"{cache.type_stride} words, the graph's "
                             f"{to.shape[1]}")
        end = max(cache.col + cache.num_entries,
                  *(getattr(cache, p) + cache.num_entries
                    for p in _CACHE_PAYLOADS),
                  cache.type_offsets + cache.num_hot * cache.type_stride)
        want["cache.words"] = (cache.words, i32, (end,))
        if cache.words.data_ptr() % 16:
            raise ValueError("cache.words must start on a 16-byte boundary")
    devices = {t.device for t, _, _ in want.values()}
    if len(devices) != 1:
        raise ValueError(f"fused-superstep inputs span devices "
                         f"{sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused-superstep inputs must be on cpu or cuda, "
                         f"got {device}")
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (q.head.data_ptr() != block.data_ptr() + 8 * CTL_QUEUE
            or state.head_hist.data_ptr() != block.data_ptr() + 8 * CTL_HIST):
        raise ValueError("the state's scalars must view the control block: "
                         "pass the pair that pack() returned")
    for name, n in (("num_slots", W), ("queue capacity", Q), ("edges", E),
                    ("vertices", V), ("k", k), ("depth", depth),
                    ("cache words", 0 if cache is None else end),
                    ("2 * rejection_rounds", 2 * spec.rejection_rounds),
                    ("reservoir_chunk", spec.reservoir_chunk),
                    ("edges + reservoir_chunk", E + spec.reservoir_chunk)):
        if not 0 <= n < 2**31:
            raise ValueError(f"{name} = {n} is outside the kernel's int32 "
                             "range")
    if spec.second_order and not np.isfinite(n2v_constants(spec)).all():
        raise ValueError(f"1/p, 1/q of p={spec.p}, q={spec.q} overflow "
                         "float32")
    if V < 1:
        raise ValueError("the graph needs at least one vertex")
    if len(key) != 2:
        raise ValueError(f"key must be a pair of 32-bit words, got {key!r}")
    return device


@functools.lru_cache(maxsize=32)
def _schedule(metapath: tuple, device: str) -> torch.Tensor:
    """The metapath schedule on ``device`` (made once per schedule)."""
    return torch.tensor(metapath, dtype=torch.int32, device=device)


def _entry():
    fn = build.load("fused_superstep").fused_superstep
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _flat(x):
    """The tensors of a (nested) NamedTuple state, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _flat(f)]


def fused_superstep(graph, spec, cfg, depth, state, key, k, block,
                    cache=None):
    """Advance ``state`` by at most ``k`` supersteps (stopping early when no
    work is left) in one launch, and count one launch in its stats.

    ``state`` and ``block`` are a pair that :func:`pack` returned (or that
    earlier launches updated).  ``key`` is the base key pair (two 32-bit
    words); ``depth`` is the Theorem VI.1 stage-ahead depth.  ``cache`` is
    a :class:`CacheBlock` on the state's device, or ``None``; one that
    lacks a payload the kind reads is dropped (see :func:`_usable`).
    Every state tensor and the block are updated in place, and ``state``
    is returned.
    """
    return _launch(graph, spec, cfg, depth, state, key, k, block, cache)


def trace_schedule(graph, spec, cfg, depth, state, key, k, block,
                   cache=None, warp: int = 0) -> ScheduleTrace:
    """:func:`fused_superstep` with the reservoir's schedule trace on: the
    same launch (counted, ``state`` and ``block`` updated in place, the same
    bits), in which lane 0 of the grid's warp ``warp`` records each copy
    start, wait and slot read it issues, in program order, up to
    :data:`TRACE_CAPACITY` records (a warp that issues more raises, after
    the launch).  Returns the decoded :class:`ScheduleTrace`, for the DMA
    pass and for ``schedule.dma_schedule``.  Weighted Node2Vec on CUDA
    tensors only: the plain version stages nothing."""
    if spec.kind != "reservoir_n2v":
        raise ValueError(f"only the reservoir kind stages its reads, not "
                         f"{spec.kind!r}")
    device = state.slots.v_curr.device
    if device.type != "cuda":
        raise ValueError(f"a schedule trace is the card's: the state is on "
                         f"{device}")
    if warp < 0:
        raise ValueError(f"warp {warp} must be >= 0")
    words = torch.zeros((TRACE_HEADER + 4 * TRACE_CAPACITY,),
                        dtype=torch.int32, device=device)
    words[TRACE_WARP], words[TRACE_CAP] = warp, TRACE_CAPACITY
    _launch(graph, spec, cfg, depth, state, key, k, block, cache, words)
    return decode_trace(words.cpu().numpy())


def _launch(graph, spec, cfg, depth, state, key, k, block, cache,
            trace=None):
    """:func:`fused_superstep`, with an optional trace buffer (int32, on the
    state's device) for :func:`trace_schedule`."""
    cache = _usable(spec, graph, cache)
    device = _check(graph, spec, cfg, depth, state, key, k, block, cache)
    if device.type == "cpu":
        new = ref.fused_superstep_ref(
            graph, spec, cfg, depth, state, key, k,
            None if cache is None else cache.hot_ids)
        for old, t in zip(_flat(state), _flat(new)):
            if t is not old:
                old.copy_(t)
        rearm(state, block)
        block[CTL_SUPERSTEPS] = state.stats.supersteps
        return state
    s, q = state.slots, state.queue
    alias, metapath = spec.kind == "alias", spec.kind == "metapath"
    sched = _schedule(spec.metapath, str(device)) if metapath else None
    weights = graph.weights if spec.kind == "reservoir_n2v" else None
    n2v = n2v_constants(spec) if spec.second_order else (1.0, 1.0, 1.0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    words = None
    lay = (0,) * 9    # H, P, trips, staged words, 5 word offsets
    if cache is not None:
        words = cache.words
        lay = (cache.num_hot, cache.num_entries, cache.probe_trips,
               _staged_words(spec, cfg, cache), cache.col, cache.weights,
               cache.alias_prob, cache.alias_idx, cache.type_offsets)
    g = grid(spec, cfg, device, cache)
    scratch = torch.empty((g.scratch_bytes,), dtype=torch.uint8,
                          device=device)

    with torch.cuda.device(device):
        rc = _entry()(
            ptr(s.v_curr), ptr(s.v_prev), ptr(s.query_id), ptr(s.hop),
            ptr(s.active), ptr(s.epoch),
            ptr(q.start_vertex), ptr(q.order), ptr(q.epoch),
            ptr(state.done), ptr(state.lengths), ptr(state.paths), ptr(block),
            ptr(graph.row_ptr), ptr(graph.col),
            ptr(graph.alias_prob) if alias else None,
            ptr(graph.alias_idx) if alias else None,
            ptr(graph.type_offsets) if metapath else None, ptr(sched),
            ptr(weights), ptr(words), ptr(scratch), g.scratch_bytes,
            cfg.num_slots, q.capacity, cfg.max_hops, graph.num_vertices,
            graph.num_edges,
            graph.type_offsets.shape[1] if metapath else 0,
            len(spec.metapath) if metapath else 0,
            cfg.injection_delay, int(k), int(depth),
            int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF,
            float(np.float32(spec.stop_prob)), *n2v,
            spec.rejection_rounds, spec.reservoir_chunk,
            bisect_iters(graph.max_degree), *lay,
            KINDS[spec.kind], int(cfg.record_paths),
            int(cfg.mode == "static"), g.blocks, g.threads, ptr(trace),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_superstep kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["fused_superstep"] += 1
    return state
