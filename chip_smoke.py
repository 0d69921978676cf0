#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA walker (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure raises and
the script exits non-zero (no phase catches another's error).  Each prints
its seconds.

1. Build the CUDA kernels (walk_step, fused_superstep, embedding_bag,
   segment_sum) from the checkout's sources with nvcc, one process each,
   started together; print the build times, the four ptxas reports, the
   card's name and power limit, and the cooperative grid of each of the
   fused kernel's 40 instantiations at W = 4,096 (blocks, threads a block,
   blocks a multiprocessor; without a cache and with the largest block
   staged in shared memory).  The main path's graphs are made while the
   fused kernel builds.  Every command-line check runs meanwhile in a
   process of its own, and all have exited before phase 2 starts
   (:func:`cli_chains`): ``python -m repro_torch.analysis --check``,
   ``python -m repro_torch.core.phase_program --check`` and the dry-run's
   sweep (``python -m repro_torch.launch.dryrun --all --mesh both``, all
   80 cells on ``meta`` tensors, no card; every record's roofline must be
   finite and positive, :func:`check_dryrun`) then one ``python -m
   repro_torch.launch.perf`` line, from the start;
   once the other three kernels are built, ``python -m
   repro_torch.launch.train`` on the card for PNA and DCN-v2 for 6 steps,
   then PNA resumed to 8, ``python -m repro_torch.launch.serve --arch
   deepseek_7b`` and ``python -m repro_torch.launch.train --arch
   granite_moe --device cuda --steps 4``; and the port's examples as
   scripts at the reference's default sizes, in two chains:
   ``examples/torch_gnn_neighbor_sampling.py``,
   ``torch_serve_continuous_batching.py`` and ``torch_quickstart.py
   --step-impl cuda``, then, once the fused kernel is built,
   ``torch_quickstart.py``, ``torch_serve_walk_requests.py`` and
   ``torch_distributed_walks.py`` with ``--step-impl fused`` and
   ``torch_cached_superstep_smoke.py``.  Each must exit 0 and print what
   it must: an example its own checks (the sharded run bit-identical to
   the single one, cache hits above 0) and a nonzero launch count of each
   kernel it reaches.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit.  First the launch floor: a 4-byte ``zero_()`` timed warm and cold
   as the kernels are, printed beside each kernel's time.  The one-hop
   walk-step kernels at W = 4096, 1, 31, 33, 1000 and 12288 lanes over
   the main path's graph (lanes include dangling vertices, the max-degree
   hub and idle lanes), and at W = 4096 right after the kernels that
   wrote v and the uniforms on the same stream, with no sync between (the
   dependent launch's ordering); timed at W = 4096 with CUDA events around
   CUDA-graph replays (median of 60 replays of 10 calls each: device time
   per call) and cold (each call after 256 MiB of writes, median of
   30).  The
   fused superstep kernel for URW, PPR, DeepWalk, MetaPath and Node2Vec
   (rejection and reservoir): one launch of k = 16 (k = 1 for the
   reservoir, whose plain launch is slow) through the kernel and through
   its plain version, on copies of one state, must leave every state
   tensor equal.  The states: the main path's batch one superstep in
   (W = 4096, every lane live and the queue full, so every superstep
   refills), the drain's tail at W = 4096, 1000 and 12288 (live, idle and
   just-refilled lanes; weighted Node2Vec, whose grid is the same at every
   W, at 4096 alone; plus PPR in static mode with an injection delay),
   and for Node2Vec a tail state with lanes placed on the max-degree hub
   (after a hop, and at hop 0) and on a vertex whose degree is not a
   multiple of the reservoir chunk, and for weighted Node2Vec a tail state
   whose every live lane sits on the hub (its chunks spread over the
   grid's warps).  The launch is timed with CUDA events
   (median of 30, 10 for Node2Vec, the state restored outside the timed
   region, host enqueue hidden behind a device sleep); the plain version
   (median of 5) and the bound from the main-path state.  At W = 4096 (main path, tail,
   hub) each launch is repeated with the hot-vertex cache at 229,376 B
   (163,840 B for weighted Node2Vec, whose staging slots take 32 KiB of
   the block's shared memory), which lands in shared memory, and for URW
   and DeepWalk from the main-path state at 1 MiB, which is read from
   device memory: every state tensor, the three cache counters
   included, equal to the plain version with the cache; the cached
   launch timed next to the uncached one, with its bound from the
   main-path state.  The embedding-bag and
   segment-sum kernels over the ids of a real SGNS batch (phase 4's
   first, sampled from round 0's walks) and at general shapes (the
   embedding bag at ragged B, H = 2 and 7, D = 100 and 102 and from an
   unaligned table;
   :func:`check_embedding_bag`, :func:`check_segment_sum`): bit-equal to
   their plain versions, the segment sum identical over two launches and
   equal to its plain version after a call with other ids (a hub id over
   1,024 times); timed with their plain versions, bounds and library
   calls, the segment sum also split into its fill, link and rows.
   Weighted Node2Vec's launches print the busiest warp's reservoir chunks
   a superstep and the microseconds a chunk.  Last, from a stream's
   state: for URW, PPR, DeepWalk, MetaPath and Node2Vec a fused stream
   (W = 4,096, capacity 65,536) is driven until its ring has wrapped and
   its live lanes hold two epochs, and one launch of k = 16 from there
   through the kernel and through its plain version, on copies, must
   leave every state tensor equal (:func:`check_fused_stream_state`).
3. Drive the main path: ``compile(program).run(graph, starts)`` for URW,
   PPR and DeepWalk on the WG stand-in at its Table II size (scale 20,
   weighted, alias tables) under ``step_impl`` torch, cuda, fused,
   fused; MetaPath (0, 1, 2) on the typed WG stand-in (scale 20, 3 edge
   types) and Node2Vec (p = 2, q = 0.5, K = 12) under torch, fused,
   fused; weighted Node2Vec (CH = 64) under fused, fused, and torch on
   the first 1,024 starts at 2 hops; 65,536 starts, 4,096
   slots, 80 hops, 16 supersteps per fused launch.  Every run zeroes the
   kernels' launch counts before it and reads them after: the impls must
   agree bit for bit in paths, lengths and the 11 stats other than
   ``launches``; ``launches == supersteps`` per hop; a fused run's
   ``launches`` equals its kernel's count and is below ``supersteps``;
   every recorded hop is an edge of the graph (of the scheduled type for
   MetaPath).  ``torch.profiler`` over a one-batch run of each program and
   impl prints where the time goes.  A small batch on the card (cuda;
   fused, also static with a delay and without path records) equals the
   same batch on the CPU, whose plain path the CPU tests hold to the JAX
   reference; the small batch also runs fused with an 8 KiB cache.  The
   cached main path, after the main path: each program fused with the
   cache at 229,376 B (weighted Node2Vec 163,840 B) against the same
   without it, in turns, must equal it in paths, lengths and every stat
   but ``launches`` and the three cache counters, with the walks/s, hit
   rate and coalesced share printed; URW at 16 KiB and 64 KiB builds no
   cache and counts nothing.
4. Walks → embeddings: ``Walker.train_embeddings`` for DeepWalk (fused)
   on the main path's graph at full width (EMB: 4 rounds of 65,536
   80-hop walks, 4 × 24 SGNS steps of batch 4,096, dim 128, window 10,
   5 negatives), overlapped, serial and overlapped again, each run with
   the launch counts zeroed before it and read after (3 embedding-bag
   and 3 segment-sum launches a step): all three equal, no recorded host
   copy when overlapped (:func:`run_embeddings`); each run's wall, its
   producer's and consumer's walls a round and its waits for the
   producer (timers the script wraps around the loop), and the share of
   the producer's time the overlapped runs hid; a device trace of one
   overlapped round (how many fused launches ran at the same time as an
   SGNS kernel, and on which streams); each run under a 300 s limit
   (:func:`phase_limit`); walks/s of the
   producer, SGNS steps/s and each part of a step's wall and device busy
   time; a checkpointed run resumed after step 48 equal to the
   uninterrupted one (WG scale 16); a small run on the card against the
   same run on the CPU.
5. The open system (:func:`run_streams`): ``compile(program).stream(
   graph, capacity, seed)`` at W = 4,096 and 80 hops on the main path's
   graphs, fed 3 x capacity arrivals in blocks of 8,192 as slots free,
   advanced in chunks of 16 supersteps, every finished slot harvested
   and released, so the ring wraps at least twice and slots of two
   epochs are live at once.  Fused for URW, PPR, DeepWalk, MetaPath and
   Node2Vec at capacity 65,536, every harvested (epoch, qid) equal to
   the row of the closed batch ``Walker.run(graph, starts_e,
   seed=stream_key(seed, e))``; DeepWalk fused with the 229,376-byte
   cache equal to it without; URW and DeepWalk at capacity 8,192 under
   fused (equal to their closed batches), cuda and torch, all three
   equal in every harvested walk and every stat but ``launches``.  Each
   stream zeroes the launch counts before it and reads them after, and
   prints its walks/s (harvested walks / wall), launches, supersteps and
   the share of wall spent blocked in host reads (progress, done flags).
6. The request service (:func:`run_service`): ``compile(program).serve(
   graph, capacity, chunk, seed)`` (``WalkService`` over a stream) at
   W = 4,096 and 80 hops on the main path's graph, driven by
   ``run_open_load`` with Poisson arrivals of 64-walk requests, steps of
   8 supersteps.  URW and DeepWalk fused at capacity 65,536 for offered
   loads rho = 0.5, 0.9 and 2.5 (2,048 requests a point, so the ring
   wraps; ``reset_metrics()`` between points); URW fused with the
   chunk controller from chunk 2 (1 to 256, patience 2) under rho = 2.5
   (1,024 requests); URW and DeepWalk at capacity 8,192 under fused,
   cuda and torch (128 requests, rho = 0.9).  Every point zeroes the
   launch counts before it and reads them after; its requests complete
   with disjoint (epoch, qid) identities, paths that begin at their
   starts and hops that are edges; fused points equal their closed
   batches under ``stream_key(seed, epoch)``; the three impls equal in
   every request, every stat but ``launches`` and every analysis field
   but ``msteps_per_s``; the adaptive run's trace grows and stays in
   bounds.  Each point prints offered load and utilization, sojourn
   (supersteps and wall ms) and admission-wait percentiles, walks/s,
   MStep/s, bubble and starved ratios, launches, supersteps, the
   host-read share and the wall split into the stream's calls (inject,
   advance, the harvest's done read, harvest_ids, release, the rest;
   timed by wrappers this script installs), beside the card line.
7. The autotuner (:func:`run_tune`, ``repro_torch.tune``) on the main
   path's graph (W = 4,096 default, 80 hops, 65,536 queries): the
   measured ``autotune`` of URW and weighted Node2Vec (CH = 64) under
   ``fused`` (``WalkMeasurer``, min of 3 interleaved; 6 pruned
   candidates) into a cache file, printing every measured candidate's
   seconds beside the fitted model's prediction, the fitted coefficients
   and the choice against the default (never slower); the
   ``hops_per_launch`` sweep 2..64 for URW and PPR (walks/s, launches);
   the cost model fitted over every URW run of the phase (the card's
   coefficients, ``tune.model.DEFAULT_COEFFS``);
   ``ExecutionConfig`` with every tunable knob ``"auto"`` and
   ``tune_cache`` set to that file, which must resolve to the tuned choice
   and give the default config's paths and lengths and a fixed run of the
   choice's stats (weighted Node2Vec's ``adaptive_chunks`` takes the
   cached choice, and the skew gate where no entry exists); cuda DeepWalk
   on 4,096 starts with ``num_slots="auto"`` (the model's argmin) equal
   to W = 4,096 in paths; model-only ``autotune`` on a CPU and a card copy
   of WG scale 9 choosing the same candidate under keys that differ in
   the device field alone.  The launch counts are zeroed before the phase
   and read after it.
8. The sharded backend (:func:`run_sharded`, ``compile(program,
   backend="sharded")``: N shards in groups, one group by default on one
   card, the plain torch superstep) on the main path's graphs at W =
   4,096: every program's
   closed batch (the first 4,096 of the 65,536 starts, 80 hops) at 4
   shards of 1,024 lanes, and
   URW also at the paper's 16 pipelines of 256, each equal in paths and
   lengths to the single backend's fused run of the same batch, with no
   drop, every hop an edge and no kernel launched by the sharded run;
   weighted Node2Vec cut in depth to 1,024 starts and 1 hop (the cut is
   printed); a sharded URW stream (capacity 8,192, 3
   x capacity arrivals) and a sharded service point (rho 0.9, 256
   requests of 64 walks), each (epoch, qid) equal to its closed batch;
   ``train_embeddings`` (DeepWalk at phase 4's width, 2 rounds of 8,192
   walks and 8 steps), overlapped and serial, equal to the single
   backend's in ring, tables and moments, with phase 4's walls and
   hidden share; and
   ``torch.profiler`` over one sharded drain (the device's busy share).
   Each run prints walks/s and MSteps/s beside the single backend's
   (phase 3's torch and fused), supersteps, route waits and the bubble
   ratio of each shard.  Then the shards in groups (a mesh naming cuda:0
   2 and 4 times, and one group a card where the machine has the cards,
   else a line saying why not): URW (4,096 starts cut to 16 hops) in 1,
   2 and 4 groups, each timed and traced (ms, device launches and busy
   share a superstep), and weighted Node2Vec at its cut in 2 and 4
   groups, each equal in paths, lengths and every stat to one group and
   to the single backend; the URW stream in 2 groups (its first capacity
   of arrivals) equal to the one-group stream; ``train_embeddings`` in
   2 and 4 groups, its tables and moments in row blocks (each group's
   slab on its device, checked there against one group's rows; the ring
   whole on the first), equal to one group's, no step clipped, with each
   run's wall and each device's peak memory.
   ``python3 chip_smoke.py --across-cards``, on a machine with
   2 or more cards, runs these grouped runs with one group a card
   instead (:func:`run_across_cards`); with no argument the script needs
   one card.
9. The static verifier (:func:`run_verifier`): ``repro_torch.analysis.
   run_all()`` with its four passes on this checkout (any finding raises;
   its two ``--check`` CLIs ran in phase 1), and each ``--fixture`` of the
   ``dma`` pass (``dma-*``, ``visit-*``) exiting non-zero in a fresh
   process; the reservoir's staged schedule on the card
   (:func:`verifier_traces`): a weighted Node2Vec launch (k = 1) from the
   main-path state traced by ``ops.trace_schedule``, equal to the
   untraced launch and the plain version, its trace free of findings and
   equal to ``dma_schedule("reservoir_n2v", chunks=n)`` op for op, and a
   traced launch with the hub's row cached in shared memory (every live
   lane on the hub) equal to the plain version, with no copy on a cache
   buffer and equal to the cached declaration; then, with the timers' clock
   (``repro_torch.core.clock.now``) replaced by one that returns random
   values, URW and PPR fused closed batches at the main path's width
   (65,536 starts, W = 4,096, 80 hops, k = 16), each equal to phase 3's
   fused run in paths, lengths and every stat but ``launches``, and a
   fused URW stream at capacity 8,192 equal to the same stream under the
   real clock in every harvested walk and every stat but ``launches``.
   The launch counts are zeroed before each run and read after it.
10. The graph-learning zoo (:func:`run_zoo`, ``repro_torch.models``) at
    full width on the reference's shape cells: PNA on ``full_graph_sm``
    (``make_cora_like(0)``: 2,708 nodes, 1,433 features, 7 classes) and on
    ``minibatch_lg`` (``sample_blocks`` of 1,024 seeds, fanouts (15, 10)
    on the main path's WG graph, bit-equal to the same call on a CPU copy;
    the union graph relabelled with ``torch.unique``; 602 features a node
    gathered each step from a (V x 602) table on the card; 47 classes),
    MeshGraphNet on ``full_graph_sm`` (``gnn_batch`` with 4 edge
    features), SchNet and MACE on ``molecule`` (``molecule_batch(30, 64,
    128)``), DCN-v2 on ``train_batch`` (65,536; 26 tables of 1,000,000 x
    16), ``serve_p99`` / ``serve_bulk`` (``predict`` at 512 and 262,144)
    and ``retrieval_cand`` (one query against 1,000,000 x 64 candidates).
    First both kernels at every row width the zoo gives them (1, 3, 75,
    602, 1,152, 1,433) over Cora's edges, bit-equal to their plain
    versions.  Each training cell: one forward, the loss and every
    gradient on the card against the same code on the CPU (DCN at batch
    512), each output and gradient leaf within a relative norm error of
    the CPU tests' rtol (PNA 10x; ``ZOO_NORM``); two 8-step runs of
    ``runtime.train_loop.run`` from the same parameters under
    ``torch.use_deterministic_algorithms`` (``CUBLAS_WORKSPACE_CONFIG``
    is set at the top of this script), whose losses and final parameters
    must be bit-identical; the median step time of steps 3-8, peak memory,
    the longest segment and both kernels' launches; then a step's wall
    with and without deterministic algorithms and a ``torch.profiler``
    trace of 3 steps (device busy time, device launches, top kernels).
    The serving cells run 8 calls each, bit-identical, timed (the
    launcher's runs are in phase 1).  The launch counts are zeroed before
    each run and read after it; the comparisons' launches do not count.
    A mismatch in any cell raises at the end of the phase.
11. The language-model serving slice (:func:`run_lm`,
    ``repro_torch.models.transformer``, ``launch.serve``) at full width in
    float32 (the reference's serving dtype), under
    ``torch.use_deterministic_algorithms``.  First both kernels at the
    LM path's shapes (the token embedding's tables; the MoE's dispatch
    gather, combine gather and sum at decode and at a 128-token prefill),
    bit-equal to their plain versions.  (a) granite_moe and
    deepseek_7b FULL cut to 2 layers, the same weights (drawn on the CPU)
    on the card and the CPU: prefill logits and caches and 4 decode
    steps' logits within a relative norm error of 1e-4, greedy tokens
    equal wherever the CPU's top-2 margin exceeds 1e-3.  (b) granite_moe
    FULL (32 layers, drawn on the card): ``continuous_batching_loop`` with
    16 requests of 128-token prompts, 8 slots, 16 new tokens, twice,
    tokens and ``ServeStats`` bit-identical; prefill ms a request, decode
    ms a step and tokens/s beside their bounds, bubble ratio, peak memory,
    both kernels' launches; a ``torch.profiler`` trace of 3 decode steps.
    (c) two requests of 4,096-token prompts served (the chunked prefill
    at 1,024 blocks), then a decode step after a prefill of 4,096 tokens
    against the forward of 4,097 (plain attention) at a capacity that
    drops no token.  (d) one prefill of ``prefill_32k``'s 32,768 tokens at
    1,024 and at 2,048 blocks, equal within tolerance, each timed.  (e)
    deepseek_7b FULL (30 layers, 27.6 GB): (b)'s serve once and (c)'s
    check at 128 tokens.  (f) a line saying why phi35_moe FULL is
    not run (167.5 GB at float32).  The launch counts are zeroed before
    each serve run and 32k prefill and read after it; the comparisons'
    launches do not count.  A mismatch in any step raises at the end of
    the phase.
12. The language-model training slice (:func:`run_lm_train`,
    ``launch.train.make_lm_step``: the gradient of
    ``transformer.train_loss`` with each layer rematerialised, then AdamW)
    at full width in float32 under ``torch.use_deterministic_algorithms``.
    granite_moe FULL cut to 2 layers and one 512-token sequence, the same
    weights (drawn on the CPU) on the card and the CPU: the loss within
    1e-5 and every gradient leaf within a relative norm error of 1e-3,
    every token routed to the same experts, and remat on and off
    bit-identical on the card.  granite_moe FULL (32 layers, 3.37 B
    parameters) on ``train_4k``'s 4,096-token Zipf sequences at the
    first batch of (3, 2, 1) that fits (the cell's 256 cut to one card and
    to the script's time limit):
    two runs of 4 steps from the seed, losses and final parameters
    bit-identical; ms a step beside the operations bound, tokens/s, peak
    memory, the kernels' launches, and a ``torch.profiler`` trace of one
    more step (device busy share, top kernels).  Both kernels at every
    shape those steps give them, bit-equal to their plain versions.
    deepseek_7b at full width with its depth cut to 12 of 30 layers (30
    do not fit), one run of 4 steps at batch 1.  ``pipeline_apply`` at 4
    stages and 8 microbatches of a small ``tanh`` stage against the
    stages in turn (atol 1e-5).  The substrate in device groups:
    granite_moe FULL (drawn on the card) with its 32 layers as 4 GPipe
    stages of 8 (``transformer._block`` in turn), forward only over 8
    microbatches of 1 x 512 Zipf tokens' hidden states after the token
    embedding (train_4k's 4,096 tokens cut in depth), the stages in 1, 2
    and 4 groups on cuda:0 (``place_stages`` once), each output bit-equal
    to the stages applied in turn on cuda:0, with ms a tick, both
    kernels' launches and the bubble 3/11; ``crosspod_psum_compressed``
    over 2 pods of one FULL layer's 10 leaves, 3 steps of error feedback,
    stacked on the CPU and on the card and in 2 groups on cuda:0, bit for
    bit (the launcher's run is in phase 1).  The launch counts are zeroed
    before each FULL run and each grouped pipeline run and read after it;
    the comparisons' launches do not count.  ``--across-cards`` ends with
    the same pipeline one group a card (2 and 4 cards) and the pods on 2
    cards, each equal to its one-group run on cuda:0.
13. The dry-run against the card (:func:`run_dryrun_vs_card`): phase
    1's granite_moe ``train_4k`` FLOPs of matrix products, scaled from
    the global batch 256 to phase 12's batch, against ``lmt_step_ops``
    (within 2 %), and the dry-run of phase 12's step itself (float32, a
    one-device mesh) against it exactly; its parameter and AdamW bytes
    against ``torch.cuda.memory_allocated()``'s growth over phase 12's
    setup (within 512 bytes a leaf); its roofline beside the measured
    step, with the card's name and power limit.  Nothing is launched.
14. Asynchronous checkpoint writes (:func:`run_async_checkpoint`):
    granite_moe FULL cut to 2 layers (0.35 B parameters, 4.2 GB of
    parameters and AdamW moments in float32), drawn on the card from seed
    0; ``runtime.train_loop.run`` of 8 steps of ``make_lm_step`` at batch
    1 x 4,096 tokens with a checkpoint every 4 steps, from those
    parameters, once with ``async_checkpoint=False`` and once with
    ``True``, under ``torch.use_deterministic_algorithms``.  Every file of
    the checkpoints at steps 4 and 8 and of the final save byte-equal
    between the runs (a snapshot that read a tensor after the next step's
    in-place update would differ), the losses and the final parameters
    and moments bit-equal, the snapshot's pinned bytes those of the state.
    Each run prints its wall, the median step, the step just after a
    checkpoint, how long each save and join held the caller and the
    pinned bytes.  The checkpoints lie under ``build/`` and are deleted.
    The launch counts are zeroed before each run and read after it.
15. Print the kernels' JSON summary (five rows), the card line, and last
    the result line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is unavailable or when the
script is run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
# cuBLAS is deterministic only with a fixed workspace, which must be set
# before CUDA starts; phase 10 runs under torch.use_deterministic_algorithms.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

NUM_STARTS = 65_536
NUM_SLOTS = 4_096
MAX_HOPS = 80
WG_SCALE = 20
HOPS_PER_LAUNCH = 16
METAPATH = (0, 1, 2)
N2V = ("node2vec", "node2vec_w")  # the Node2Vec programs (p = 2, q = 0.5)
N2V_TORCH_STARTS = 1_024         # node2vec_w's torch run: starts and slots,
N2V_TORCH_HOPS = 2               # and hops (its plain scan is slow: 16
                                 # hops took 67.7 s on an H100, 8 took
                                 # 29.2 s; cut for the time limit)
# The walk-step kernels' widths: the main path's W first, then ragged ones
# (one lane; either side of a warp; not a multiple of a block; 3 x 4,096).
KERNEL_WIDTHS = (4_096, 1, 31, 33, 1_000, 12_288)
FUSED_WIDTHS = (4_096, 1_000, 12_288)
TIMED_REPS = 60                  # graph replays timed per function
GRAPH_CALLS = 10                 # calls captured per graph (600 timed)
FUSED_TIMED_REPS = 30            # fused launches timed per version
N2V_KERNEL_REPS = 10             # ... of the Node2Vec kinds (the plain
                                 # version's time is its one checked launch)
FUSED_PLAIN_REPS = 5             # plain launches timed (host-driven, ~0.2 s
                                 # each)
# Phase 2's supersteps per launch: 16, but 1 for node2vec_w, whose plain
# launch from the main-path state took 60 s on an H100 at k = 16, 17 s
# at k = 4 and 7 s at k = 2, twice a state (its plain superstep scans
# every chunk of the live lanes' largest degree).
PHASE2_K = {"node2vec_w": 1}
PROFILE_SUPERSTEPS = 2           # per-hop impls: supersteps profiled
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
CUDA_CORE_OPS_PER_S = 67e12      # H100 SXM float32 outside tensor cores
# int32 rate of the whole card: 132 SMs x 64 int32 lanes per SM per clock
# at the 1,980 MHz maximum boost clock (Hopper white paper) = 16.7 Tops/s.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
THREEFRY_OPS = 80                # int32 ops per Threefry-2x32 block
LANE_OPS = 40                    # other int32 ops per live lane-superstep
BISECT_OPS = 4                   # int32 ops per bisection halving
SECTOR = 32                      # bytes the memory system moves per gather
L2_FLUSH_BYTES = 256 << 20       # written ahead of a cold-L2 launch
# Each per-hop impl runs once, the fused twice (the time limit).
RUN_ORDER = {"urw": ("torch", "cuda", "fused", "fused"),
             "ppr": ("torch", "cuda", "fused", "fused"),
             "deepwalk": ("torch", "cuda", "fused", "fused"),
             "metapath": ("torch", "fused", "fused"),
             "node2vec": ("torch", "fused", "fused"),
             # plus a torch run of 1,024 starts at 2 hops (run_main_path)
             "node2vec_w": ("fused", "fused")}

KERNELS = {
    "walk_step_uniform": {
        "replaces": "src/repro/kernels/walk_step/walk_step.py:227",
        "ops_per_lane": 16,   # clamps, address adds, cvt, mul, floor, pick
    },
    "walk_step_alias": {
        "replaces": "src/repro/kernels/walk_step/walk_step.py:249",
        "ops_per_lane": 22,   # the uniform ops plus the accept test
    },
}
CU_SOURCE = "src/repro_torch/kernels/walk_step/csrc/walk_step.cu"
FUSED_SOURCE = ("src/repro_torch/kernels/fused_superstep/csrc/"
                "fused_superstep.cu")
FUSED_REPLACES = "src/repro/kernels/fused_superstep/fused_superstep.py:805"
FUSED_TIMED = "ppr"              # the program whose launch the JSON row times
# The hot-vertex cache: the most that fits in one block's shared memory
# (224 KiB of the H100's 227 KiB opt-in limit), and 1 MiB, which does not.
CACHE_SHARED = 229_376
# The reservoir's 32 KiB of cp.async staging slots come first in its shared
# memory, so CACHE_SHARED's weighted block (204,428 B on WG 20) no longer
# fits beside them; 163,840 B holds the hub's weighted row alone (148,072
# B), which does.  Every cached run of node2vec_w at "the shared budget"
# takes it (shared_budget).
CACHE_SHARED_BY = {"node2vec_w": 163_840}
CACHE_GLOBAL = 1_048_576
CACHE_OFF = (16_384, 65_536)     # budgets that admit no vertex on WG 20
# Phase 2's cached launches beside the uncached ones (W = NUM_SLOTS,
# zero-bubble): every program from the main-path and tail states, the
# Node2Vec kinds from the hub state too, all at shared_budget; URW and
# DeepWalk also from the main-path state at CACHE_GLOBAL, and URW at
# 80 KiB, which holds the hub alone (74,052 B of shared memory against
# CACHE_SHARED's 213,752 B), to show how the launch's time follows the
# shared memory the block takes from the SM's L1.
CACHE_EXTRA = {("urw", "main"): (81_920, CACHE_GLOBAL),
               ("deepwalk", "main"): (CACHE_GLOBAL,)}
CACHE_LANE_OPS = 4               # tag fill + leader test, per lane-superstep


def shared_budget(name) -> int:
    """The cache budget whose block program ``name`` stages in shared
    memory: CACHE_SHARED, less for the reservoir (CACHE_SHARED_BY)."""
    return CACHE_SHARED_BY.get(name, CACHE_SHARED)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


@contextlib.contextmanager
def timed(label):
    """Print the seconds the block took, as ``  {label} time ... s``."""
    t = time.perf_counter()
    yield
    print(f"  {label} time {time.perf_counter() - t:.1f} s")


def ptxas_report(log: str):
    """The register report of an nvcc ``-Xptxas -v`` log: each kernel's
    ``Compiling entry function`` line (mangled name), its spill line and
    its ``Used ...`` line."""
    for line in log.splitlines():
        if ("Compiling entry function" in line or "spill" in line
                or "Used" in line):
            yield "  " + line.strip()


def print_grids() -> None:
    """Phase 1: the grid of every instantiation of the fused kernel at the
    main path's W, without a cache and with the largest block staged in
    shared memory (blocks, threads a block, blocks a multiprocessor)."""
    import torch

    from repro_torch.kernels.fused_superstep import ops
    dev = torch.cuda.current_device()
    for kind, code in ops.KINDS.items():
        for stop in (False, True):
            for record in (False, True):
                for static in (False, True):
                    flags = (code, stop, record, static)
                    smem = ops._smem_limit(dev, *flags) // 16 * 16
                    text = []
                    for staged in (0, smem):
                        gr = ops._grid(dev, *flags, NUM_SLOTS, staged, 0)
                        text.append(f"{staged} B staged: {gr.blocks} blocks x "
                                    f"{gr.threads} threads, {gr.per_sm} a "
                                    "multiprocessor")
                    print(f"grid {kind} stop={int(stop)} record={int(record)} "
                          f"static={int(static)} W={NUM_SLOTS}: "
                          + "; ".join(text))


def programs():
    from repro_torch.walker import WalkProgram
    return {"urw": WalkProgram.urw(MAX_HOPS),
            "ppr": WalkProgram.ppr(0.15, MAX_HOPS),
            "deepwalk": WalkProgram.deepwalk(MAX_HOPS),
            "metapath": WalkProgram.metapath(METAPATH, MAX_HOPS),
            "node2vec": WalkProgram.node2vec(2.0, 0.5, MAX_HOPS),
            "node2vec_w": WalkProgram.node2vec(2.0, 0.5, MAX_HOPS,
                                               weighted=True)}


def kernel_inputs(g, width: int, seed: int):
    """Lanes over ``g`` at ``width``: random vertices plus dangling
    vertices, the max-degree hub and idle lanes (-1); uniforms include 0
    and the largest float32 below 1."""
    import torch
    rng = np.random.default_rng(seed)
    deg = (g.row_ptr[1:] - g.row_ptr[:-1]).cpu().numpy()
    v = rng.integers(0, g.num_vertices, width).astype(np.int32)
    dangling = np.flatnonzero(deg == 0)
    v[0:width:7] = rng.choice(dangling, len(v[0:width:7]))
    v[1:width:11] = int(np.argmax(deg))
    v[2:width:13] = -1
    u = rng.random((2, width), dtype=np.float32)
    u[:, 3:width:17] = 0.0
    u[:, 4:width:19] = np.nextafter(np.float32(1), np.float32(0))
    dev = g.device
    return (torch.from_numpy(v).to(dev), torch.from_numpy(u[0]).to(dev),
            torch.from_numpy(u[1]).to(dev))


def kernel_args(name, g, v, u_col, u_acc):
    if name == "walk_step_uniform":
        return (v, u_col, g.row_ptr, g.col)
    return (v, u_col, u_acc, g.row_ptr, g.col, g.alias_prob, g.alias_idx)


def bytes_needed(name, g, v, u_col, u_acc) -> int:
    """Bytes this call must move: lane I/O once, plus each distinct 32-byte
    sector its gathers touch (the row_ptr pair of every lane; the alias
    probes and the column read of every lane with degree > 0)."""
    import torch

    from repro_torch.core.samplers import _uniform_index
    lane_io = v.shape[0] * 4 * (4 if name == "walk_step_uniform" else 5)
    vc = torch.clamp(v, 0, g.num_vertices - 1).long()
    addr, deg = g.row_ptr[vc], g.row_ptr[vc + 1] - g.row_ptr[vc]

    def sectors(word_index):
        return SECTOR * int(torch.unique(word_index * 4 // SECTOR).numel())
    total = lane_io + sectors(torch.cat([vc, vc + 1]))
    live = deg > 0
    idx = _uniform_index(deg, u_col)
    if name == "walk_step_alias":
        ek = (addr + idx)[live].long()
        total += 2 * sectors(ek)            # prob and alias, same offsets
        idx = idx.clone()
        idx[live] = torch.where(u_acc[live] < g.alias_prob[ek], idx[live],
                                g.alias_idx[ek])
    return total + sectors((addr + idx)[live].long())   # the column read


def time_launches(fn, reps=TIMED_REPS, calls=GRAPH_CALLS) -> float:
    """Median device time of one call of ``fn`` in ms.

    ``calls`` calls are captured in a CUDA graph and the graph is replayed
    ``reps`` times between CUDA events, so each sample is back-to-back
    device work (host launch overhead excluded), divided by ``calls``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return float(np.median(samples))


def time_cold(fn, reps=FUSED_TIMED_REPS) -> float:
    """Median device time of one call of ``fn`` in ms with a cold L2: each
    sample first writes L2_FLUSH_BYTES (evicting the 50 MB L2), behind a
    device sleep that hides the host's enqueue, then times the call alone
    between CUDA events."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    samples = []
    for _ in range(reps + 2):                 # the first two warm up
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples[2:]))


def launch_floor() -> dict:
    """Phase 2: a 4-byte ``zero_()`` timed warm and cold with the kernels'
    own helpers: what any launch pays, printed beside each kernel's time
    (never used as a bound)."""
    import torch
    x = torch.empty(1, dtype=torch.int32, device="cuda")
    floor = {"warm": time_launches(x.zero_), "cold": time_cold(x.zero_)}
    print(f"launch floor (a 4-byte zero_(), timed as the kernels are): "
          f"warm {floor['warm']:.7f} ms, cold {floor['cold']:.7f} ms")
    return floor


def floor_text(floor) -> str:
    return (f"launch floor warm {floor['warm']:.7f} ms, cold "
            f"{floor['cold']:.7f} ms")


def check_kernels(g, floor) -> dict:
    """Phase 2: each walk-step kernel bit-equal to its plain version at
    every width of KERNEL_WIDTHS and right after the kernels that wrote
    its inputs, timed warm and cold at the main path's W."""
    import torch

    from repro_torch.kernels.walk_step import ops, ref
    plain = {"walk_step_uniform": ref.walk_step_uniform_ref,
             "walk_step_alias": ref.walk_step_alias_ref}
    rows = {}
    for name, spec in KERNELS.items():
        kernel = getattr(ops, name)
        max_err = 0
        for width in KERNEL_WIDTHS:
            v, u_col, u_acc = kernel_inputs(g, width, seed=width)
            args = kernel_args(name, g, v, u_col, u_acc)
            got, want = kernel(*args), plain[name](*args)
            for a, b in zip(got, want):
                err = int((a.long() - b.long()).abs().max())
                max_err = max(max_err, err)
                if err != 0 or a.dtype != b.dtype:
                    raise AssertionError(
                        f"{name} disagrees with its plain version at W={width}"
                        f" (max abs err {err})")
            print(f"{name} W={width}: bit-equal to the plain version "
                  f"(tolerance 0: integer outputs)")
        # The dependent launch's ordering: v and both uniforms written by
        # kernels just before it on the same stream, with no sync between.
        v, u_col, u_acc = kernel_inputs(g, KERNEL_WIDTHS[0], seed=5)
        want = plain[name](*kernel_args(name, g, v, u_col, u_acc))
        torch.cuda.synchronize()
        u2 = torch.stack([u_col, u_acc], 1) * 1.0
        got = kernel(*kernel_args(name, g, v + 0, u2[:, 0].contiguous(),
                                  u2[:, 1].contiguous()))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 "right after the kernels that wrote its "
                                 "inputs")
        print(f"{name} W={KERNEL_WIDTHS[0]}: bit-equal right after the "
              "kernels that wrote v and the uniforms (no sync between)")
        width = KERNEL_WIDTHS[0]
        v, u_col, u_acc = kernel_inputs(g, width, seed=width)
        args = kernel_args(name, g, v, u_col, u_acc)
        ms = time_launches(lambda: kernel(*args))
        cold_ms = time_cold(lambda: kernel(*args))
        plain_ms = time_launches(lambda: plain[name](*args))
        nbytes = bytes_needed(name, g, v, u_col, u_acc)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = width * spec["ops_per_lane"] / CUDA_CORE_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": spec["replaces"], "launches": None,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        print(f"{name} W={width}: kernel warm {ms:.7f} ms, cold "
              f"{cold_ms:.7f} ms ({floor_text(floor)}), plain warm "
              f"{plain_ms:.6f} ms, bound {max(t_bytes, t_ops):.7f} ms "
              f"({nbytes} bytes)")
    return rows


def clone_state(x):
    """A deep copy of a (nested) NamedTuple of tensors."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(clone_state(f) for f in x))


def state_tensors(state, prefix=""):
    """(name, tensor) for every tensor of a (nested) NamedTuple state."""
    import torch
    for name, f in zip(state._fields, state):
        if isinstance(f, torch.Tensor):
            yield prefix + name, f
        else:
            yield from state_tensors(f, prefix + name + ".")


def state_err(a, b) -> int:
    """Max abs difference over every tensor of two engine states (slots,
    queue counters, head_hist, all 12 stats, done, lengths, paths)."""
    err = 0
    for (name, x), (_, y) in zip(state_tensors(a), state_tensors(b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{name}: {x.dtype}{tuple(x.shape)} vs "
                                 f"{y.dtype}{tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def mid_drain_state(g, prog, cfg, key, seed):
    """A state some plain supersteps into a batch of W + W/16 starts: they
    run until the queue has run dry and lanes start to idle, so the state
    holds live, idle and just-refilled lanes (the drain's tail)."""
    import torch

    from repro_torch.core import walk_engine
    from repro_torch.kernels.fused_superstep import ref
    depth = walk_engine._stage_depth(cfg)
    W = cfg.num_slots
    starts = np.random.default_rng(seed).integers(
        0, g.num_vertices, W + W // 16).astype(np.int32)
    state = walk_engine.init_state(cfg, depth,
                                   torch.from_numpy(starts).to(g.device))
    for _ in range(60):
        state = ref.fused_superstep_ref(g, prog.spec, cfg, depth, state, key, 1)
        if not bool(state.slots.active.all()):
            break
    return state, depth


def main_path_state(g, prog, cfg, key, starts_np):
    """The main path's state one plain superstep into its batch (the same
    starts and key): every lane live, the queue holding more than one
    launch can take, lanes that ended refilled."""
    import torch

    from repro_torch.core import walk_engine
    from repro_torch.kernels.fused_superstep import ref
    depth = walk_engine._stage_depth(cfg)
    state = walk_engine.init_state(cfg, depth,
                                   torch.from_numpy(starts_np).to(g.device))
    return ref.fused_superstep_ref(g, prog.spec, cfg, depth, state, key, 1), depth


def fused_bound(prog, cfg, before, after, gather_work=None, cache=None):
    """(bound ms, bound_by, int32 ops, bytes) of one fused launch, counted
    from what this launch's data needed: its live lane-supersteps,
    advancing hops, terminations and refills.  For a Node2Vec kind,
    ``gather_work`` is :func:`n2v_work`'s (int32 ops, gather bytes) of the
    launch, in place of the per-lane draws and gathers.  With ``cache`` (a
    cache block) the launch also reads the block once (its staging) and
    every lane, idle or not, does the tag fill, the leader test and the
    probe each superstep: ``probe_trips`` + 4 int32 ops (CACHE_LANE_OPS).
    Cached reads replace graph reads one for one, so the gathers' bytes
    stay as they are."""
    def d(field):
        return int(getattr(after.stats, field)) - int(getattr(before.stats,
                                                              field))
    from repro_torch.kernels.fused_superstep import ops
    live = d("slot_steps") - d("bubbles")
    refills = int(after.queue.head) - int(before.queue.head)
    if gather_work is None:
        # Threefry blocks per live lane: 2 fold query id and hop (epoch 0
        # throughout a closed batch), shared by the draws; each draw then
        # folds its salt and runs its block.  PPR draws twice.
        blocks = 2 + 2 * (2 if prog.spec.stop_prob > 0 else 1)
        ops_count = live * (blocks * THREEFRY_OPS + LANE_OPS)
        gather = {"uniform": 12, "alias": 20, "metapath": 24}[prog.spec.kind]
        gather_bytes = live * gather           # row_ptr pair, column, probes
    else:
        ops_count, gather_bytes = gather_work
        ops_count += live * LANE_OPS
    if cache is not None:
        ops_count += (cfg.num_slots * d("supersteps")
                      * (cache.probe_trips + CACHE_LANE_OPS))
    nbytes = (2 * cfg.num_slots * 21           # lane state in and out
              + gather_bytes
              + d("steps") * 8                 # path record + length
              + d("terminations")              # done bytes
              + refills * 20                   # order/start/epoch, path, length
              + 2 * 8 * (ops.CTL_HIST + cfg.injection_delay + 1)
              + (0 if cache is None else cache.nbytes()))   # staging
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            ops_count, nbytes)


def bisect_trace(g, vp, y):
    """(probe offsets, halvings) of ``samplers.edge_exists``'s bisection of
    each ``y`` in N(``vp``) (``vp >= 0``): every halving with lo < hi reads
    col[mid], and the membership test reads col[lo] where lo < hi0."""
    import torch

    from repro_torch.core.samplers import bisect_iters
    lo = g.row_ptr[vp.long()]
    hi0 = g.row_ptr[vp.long() + 1]
    hi, probes, steps = hi0, [], 0
    for _ in range(bisect_iters(g.max_degree)):
        active = lo < hi
        n = int(active.sum())
        if n == 0:
            break
        steps += n
        mid = (lo + hi) // 2
        probes.append(mid[active])
        go = g.col[mid.clamp(0, g.num_edges - 1).long()] < y
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    probes.append(lo[lo < hi0])
    return torch.cat(probes), steps


def n2v_work(g, spec, key, slots_seq):
    """(int32 ops, gather bytes) that one launch of a Node2Vec kind needs,
    from the slots at the start of each of its supersteps: the live lanes
    with a neighbor to take.  Ops: 80 per Threefry block (2 fold query id
    and hop, one folds each salt; rejection: one block per round up to the
    first accept; reservoir: one per pair of candidates) and BISECT_OPS
    per bisection halving (rejection: each round before the last, where
    v_prev >= 0 and the candidate is not v_prev; reservoir: every
    candidate, where v_prev >= 0).  Bytes: the distinct 32-byte sectors of
    row_ptr (v_curr's and v_prev's pairs), col (proposals or candidates,
    probes, membership reads) and weights (the reservoir's candidates)
    that the launch touches."""
    import torch

    from repro_torch.core import rng
    from repro_torch.core.rng import SALT_COLUMN
    from repro_torch.core.samplers import (_uniform_index, n2v_bias,
                                           rejection_choose)
    from repro_torch.graph.csr import row_access
    ops_count = 0
    touched = {"row_ptr": [], "col": [], "weights": []}
    for s in slots_seq:
        addr, deg = row_access(g, s.v_curr)
        run = s.active.bool() & (deg > 0)
        addr, deg, vp = addr[run], deg[run], s.v_prev[run]
        vc = s.v_curr[run]
        touched["row_ptr"] += [vc, vc + 1, vp[vp >= 0], vp[vp >= 0] + 1]
        lanes = int(run.sum())
        if spec.kind == "rejection_n2v":
            K = spec.rejection_rounds
            u = rng.task_uniforms(key, s.query_id[run], s.hop[run], 2 * K,
                                  SALT_COLUMN, epoch=s.epoch[run])
            idx = _uniform_index(deg[:, None], u[:, :K])
            e = torch.clamp(addr[:, None] + idx, 0, g.num_edges - 1)
            cand = g.col[e.long()]
            first = rejection_choose(spec, u[:, K:],
                                     n2v_bias(spec, g, vp, cand))
            j = torch.arange(K, device=cand.device)[None, :]
            used = j <= first[:, None]
            touched["col"].append(e[used])
            need = used & (j < K - 1) & (vp[:, None] >= 0) & (
                cand != vp[:, None])
            blocks = 3 * lanes + int(used.sum())
            vp_b, y_b = vp[:, None].expand_as(cand)[need], cand[need]
        else:
            CH = spec.reservoir_chunk
            pairs = (CH + 1) // 2
            n_chunks = (deg + CH - 1) // CH
            last = deg - (n_chunks - 1) * CH
            blocks = (2 * lanes + int(n_chunks.sum())
                      + int(((n_chunks - 1) * pairs
                             + torch.clamp(last, max=pairs)).sum()))
            lane = torch.repeat_interleave(
                torch.arange(lanes, device=deg.device), deg.long())
            start = torch.cumsum(deg, 0) - deg
            pos = torch.arange(lane.numel(), device=deg.device) - start[lane]
            e = addr[lane] + pos
            touched["col"].append(e)
            touched["weights"].append(e)
            need = vp[lane] >= 0
            vp_b, y_b = vp[lane][need], g.col[e[need].long()]
        probes, steps = bisect_trace(g, vp_b, y_b)
        touched["col"].append(probes)
        ops_count += blocks * THREEFRY_OPS + steps * BISECT_OPS
    sectors = 0
    for name, words in touched.items():
        if words and (name != "weights" or g.weights is not None):
            word = torch.cat([w.reshape(-1).long() for w in words])
            sectors += int(torch.unique(word * 4 // SECTOR).numel())
    return ops_count, SECTOR * sectors


def busiest_warp(g, spec, warps, slots_seq):
    """(mean, max) over a launch's supersteps of the reservoir chunks that
    the kernel's busiest warp takes in one superstep: every live lane with
    a neighbor list brings ceil(deg / CH) (lane, chunk) items, and warp w
    of the grid's ``warps`` takes items [w * per, (w + 1) * per), per =
    ceil(items / warps)."""
    import torch

    from repro_torch.graph.csr import row_access
    CH = spec.reservoir_chunk
    loads = []
    for s in slots_seq:
        deg = torch.where(s.active.bool(), row_access(g, s.v_curr)[1], 0)
        items = int(((deg + CH - 1) // CH).sum())
        loads.append(-(-items // warps))
    return float(np.mean(loads)), max(loads)


def in_neighbor(g, v):
    """A vertex other than v with an edge to v."""
    import torch
    rows = torch.searchsorted(g.row_ptr, torch.nonzero(g.col == v)[:, 0],
                              right=True) - 1
    return int(rows[rows != v][0])


def hub_state(g, state, chunk):
    """Place the first three live lanes of ``state`` (in place): on the
    max-degree hub after a hop from one of its in-neighbors, on the hub at
    hop 0, and on a vertex of degree above ``chunk`` and not a multiple of
    it, after a hop from an in-neighbor."""
    import torch
    deg = g.row_ptr[1:] - g.row_ptr[:-1]
    hub = int(torch.argmax(deg))
    ragged = (deg > chunk) & (deg % chunk != 0)
    ragged[hub] = False
    ragged = int(torch.nonzero(ragged)[0])
    s = state.slots
    lanes = torch.nonzero(s.active)[:3, 0].tolist()
    for lane, (v, vp, hop) in zip(lanes, ((hub, in_neighbor(g, hub), 3),
                                          (hub, -1, 0),
                                          (ragged, in_neighbor(g, ragged),
                                           2))):
        s.v_curr[lane], s.v_prev[lane], s.hop[lane] = v, vp, hop
    return [(hub, int(deg[hub])), (ragged, int(deg[ragged]))]


def all_hub_state(g, state):
    """Place every live lane of ``state`` (in place) on the max-degree hub:
    even lanes after a hop from one of its in-neighbors, odd ones at hop 0.
    So each live lane brings the hub's ceil(deg / CH) reservoir chunks."""
    import torch
    deg = g.row_ptr[1:] - g.row_ptr[:-1]
    hub = int(torch.argmax(deg))
    s = state.slots
    even = torch.arange(s.v_curr.shape[0], device=g.device) % 2 == 0
    live = s.active.bool()
    s.v_curr[live] = hub
    s.v_prev[live] = torch.where(even, in_neighbor(g, hub), -1).int()[live]
    s.hop[live] = torch.where(even, 3, 0).int()[live]
    return [(hub, int(deg[hub]))]


def time_fused(launch, pristine, device_only, reps=FUSED_TIMED_REPS) -> float:
    """Median ms of ``launch(state)`` between CUDA events, each on a fresh
    copy of ``pristine`` made outside the timed region.  With
    ``device_only`` the copy is packed beforehand (``launch(state, block)``
    is called) and a device sleep runs
    ahead of the start event, so the host's enqueue is hidden and the time
    is the kernel's; otherwise it includes the host (the plain version is
    host-driven, with a device sync per superstep)."""
    import torch

    from repro_torch.kernels.fused_superstep import ops
    samples = []
    for _ in range(reps + 2):                 # the first two warm up
        work = clone_state(pristine)
        if device_only:
            work = ops.pack(work)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if device_only:
            torch.cuda._sleep(2_000_000)      # ~1 ms of device time
        start.record()
        if device_only:
            launch(*work)
        else:
            launch(work)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples[2:]))


def launch_slots(kernel, pristine, k):
    """The slots at the start of each superstep of one k-superstep launch
    from ``pristine``, replayed as k one-superstep kernel launches (which
    phase 2 has just held equal to the plain version)."""
    from repro_torch.kernels.fused_superstep import ops
    work, block = ops.pack(clone_state(pristine))
    seq = []
    for _ in range(k):
        if not ops.progress(block)[0]:
            break
        seq.append(clone_state(work.slots))
        kernel(work, block, 1)
    return seq


def check_cached(name, g, cfg, depth, key, state, k, budget, where,
                 uncached_ms, gather_work=None) -> dict:
    """Phase 2, cached: one launch of k supersteps with the hot-vertex cache
    of ``budget`` bytes, from ``state``, through the kernel and through the
    plain version (``ref.py`` with the cache's hot ids): every state tensor
    equal, the three cache counters included, and each live lane-superstep
    counted once (a leader's hit or miss, or a follower).  The launch is
    timed as the uncached one (``uncached_ms``, the same state, just
    before); from the main-path state, with its bound.  Returns the
    numbers."""
    import dataclasses

    import torch

    from repro_torch.core.walk_engine import maybe_build_cache
    from repro_torch.kernels.fused_superstep import LAUNCHES, ops, ref
    prog = programs()[name]
    ccfg = dataclasses.replace(cfg, cache_budget=budget)
    t0 = time.perf_counter()
    host = maybe_build_cache(prog.spec, ccfg, g)
    block = ops.cache_block(host, g.device)
    build_s = time.perf_counter() - t0
    tier = ops.cache_tier(prog.spec, ccfg, block)
    limit = ops.smem_limit(prog.spec, ccfg, g.device)

    def plain(st):
        return ref.fused_superstep_ref(g, prog.spec, ccfg, depth, st, key, k,
                                       block.hot_ids)

    def kernel(st, blk):
        return ops.fused_superstep(g, prog.spec, ccfg, depth, st, key, k, blk,
                                   cache=block)
    t0 = time.perf_counter()
    want = plain(clone_state(state))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    work, blk = ops.pack(clone_state(state))
    n0 = LAUNCHES["fused_superstep"]
    got = kernel(work, blk)
    torch.cuda.synchronize()
    if LAUNCHES["fused_superstep"] != n0 + 1:
        raise AssertionError("cached fused launch not counted once")
    err = state_err(got, want)
    if err != 0:
        raise AssertionError(f"cached fused_superstep {name} {where} budget "
                             f"{budget} ({tier}) disagrees with its plain "
                             f"version (max abs err {err})")

    def d(f):
        return int(getattr(got.stats, f)) - int(getattr(state.stats, f))
    hits, misses, coal = (d("cache_hits"), d("cache_misses"),
                          d("cache_coalesced"))
    live = d("slot_steps") - d("bubbles")
    if hits + misses + coal != live or hits <= 0:
        raise AssertionError(f"cached {name} {where}: {hits} hits + {misses} "
                             f"misses + {coal} coalesced for {live} live "
                             f"lane-supersteps")
    ms = time_fused(kernel, state, device_only=True,
                    reps=N2V_KERNEL_REPS if name in N2V else FUSED_TIMED_REPS)
    out = {"budget": budget, "tier": tier, "H": host.num_hot,
           "P": host.num_entries, "nbytes": host.nbytes(), "ms": ms,
           "uncached_ms": uncached_ms, "plain_ms": plain_s * 1e3,
           "hits": hits, "misses": misses, "coalesced": coal}
    text = ""
    if where == "main":
        out["bound_ms"], out["bound_by"], n_ops, nbytes = fused_bound(
            prog, ccfg, state, got, gather_work, cache=block)
        text = (f"; bound {out['bound_ms']:.6f} ms by {out['bound_by']} "
                f"({n_ops} int32 ops, {nbytes} bytes)")
    print(f"fused_superstep {name} W={cfg.num_slots} k={k} {where} cache "
          f"{budget} B: H={host.num_hot} P={host.num_entries} "
          f"nbytes={host.nbytes()} tier={tier} (shared-memory limit "
          f"{limit} B; built in {build_s:.2f} s): "
          f"bit-equal to the plain version in every state tensor, counters "
          f"included; hits={hits} misses={misses} coalesced={coal} "
          f"(hit rate {hits / max(hits + misses, 1):.6f}); kernel cached "
          f"{ms:.6f} ms vs uncached {uncached_ms:.6f} ms a launch; plain "
          f"{plain_s * 1e3:.3f} ms{text}")
    return out


def check_fused(graphs, starts_np) -> dict:
    """Phase 2, fused: one launch of the kernel (k = 16; ``PHASE2_K`` for
    node2vec_w) equals its plain version in every state tensor, per
    program, from three kinds of state:
    the main path's batch one superstep in (W = 4,096, the queue full:
    timed against the plain version and the bound; PPR's is the JSON
    row, every program's in its ``per_kind``), the drain's tail (W =
    4,096, 1,000 and 12,288, plus PPR in static mode with a delay; the
    kernel timed, to show its scaling), and for the Node2Vec kinds a tail
    state whose first live lanes sit on the max-degree hub (after a hop,
    and at hop 0) and on a vertex of degree not a multiple of the chunk.
    At W = 4,096 in zero-bubble mode each launch is also run with the
    hot-vertex cache (:func:`check_cached`), in its ``cached`` list."""
    import torch

    from repro_torch.core.rng import stream_key
    from repro_torch.core.walk_engine import EngineConfig
    from repro_torch.kernels.fused_superstep import LAUNCHES, ops, ref
    cases = [(name, NUM_SLOTS, "zero_bubble", 0, "main") for name in graphs]
    # The reservoir kind's grid is 132 x 1,024 at every W (its lanes'
    # chunks are the grid's items), so its tail runs at W = 4,096 alone.
    cases += [(name, W, "zero_bubble", 0, "tail") for name in graphs
              for W in FUSED_WIDTHS
              if W == NUM_SLOTS or name != "node2vec_w"]
    cases.append(("ppr", 1_000, "static", 2, "tail"))
    cases += [(name, NUM_SLOTS, "zero_bubble", 0, "hub") for name in N2V]
    cases.append(("node2vec_w", NUM_SLOTS, "zero_bubble", 0, "all hub"))
    max_err, row, per_kind, cached = 0, None, {}, []
    for name, W, mode, delay, where in cases:
        t_case = time.perf_counter()
        prog, g = programs()[name], graphs[name]
        K = PHASE2_K.get(name, HOPS_PER_LAUNCH)
        cfg = EngineConfig(num_slots=W, max_hops=MAX_HOPS, mode=mode,
                           injection_delay=delay, step_impl="fused",
                           hops_per_launch=HOPS_PER_LAUNCH)
        placed = ""
        if where == "main":
            key = tuple(int(k) for k in stream_key(0))   # the main path's
            state, depth = main_path_state(g, prog, cfg, key, starts_np)
        else:
            key = tuple(int(k) for k in stream_key(7))
            state, depth = mid_drain_state(g, prog, cfg, key, seed=W)
        if where == "hub":
            placed = (" (lanes placed on (vertex, degree) "
                      f"{hub_state(g, state, prog.spec.reservoir_chunk)})")
        if where == "all hub":
            placed = (" (every live lane placed on (vertex, degree) "
                      f"{all_hub_state(g, state)})")
        grid = ops.grid(prog.spec, cfg, g.device)
        placed += (f" [grid {grid.blocks} blocks x {grid.threads} threads, "
                   f"{grid.per_sm} a multiprocessor]")
        live = int(state.slots.active.sum())
        fresh = int((state.slots.active & (state.slots.hop == 0)).sum())
        if not (live == W if where == "main" else 0 < live < W):
            raise AssertionError(f"fused {name} W={W} {where}: the state "
                                 f"has {live} live lanes of {W}")

        def plain(st, prog=prog, g=g, cfg=cfg, depth=depth, key=key, k=K):
            return ref.fused_superstep_ref(g, prog.spec, cfg, depth, st, key,
                                           k)

        def kernel(st, block, k=K, prog=prog, g=g, cfg=cfg, depth=depth,
                   key=key):
            return ops.fused_superstep(g, prog.spec, cfg, depth, st, key, k,
                                       block)
        t0 = time.perf_counter()
        want = plain(clone_state(state))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        work, block = ops.pack(clone_state(state))
        n0 = LAUNCHES["fused_superstep"]
        got = kernel(work, block)
        torch.cuda.synchronize()
        if LAUNCHES["fused_superstep"] != n0 + 1:
            raise AssertionError("fused launch not counted once")
        if got is not work:
            raise AssertionError("the fused launch did not update in place")
        err = state_err(got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"fused_superstep {name} W={W} {mode} C={delay}"
                                 f" {where} disagrees with its plain version "
                                 f"(max abs err {err})")
        ran = int(got.stats.supersteps) - int(state.stats.supersteps)
        idle = int(got.stats.bubbles) - int(state.stats.bubbles)
        refills = int(got.queue.head) - int(state.queue.head)
        if where == "main" and (idle != 0 or ran != K
                                or int(got.queue.head) >= int(got.queue.tail)):
            raise AssertionError(f"fused {name}: the main-path launch was not "
                                 f"full ({idle} idle lane-supersteps)")
        print(f"fused_superstep {name} W={W} mode={mode} delay={delay} "
              f"{where}{placed}: bit-equal to the plain version in every "
              f"state tensor (tolerance 0: integer state) over {ran} "
              f"supersteps from {live} live / {W - live} idle / {fresh} "
              f"just-refilled lanes; {refills} refills, {idle} idle "
              f"lane-supersteps; plain launch {plain_s:.2f} s")
        n2v = name in N2V
        gather_work = None
        if mode == "zero_bubble":
            ms = time_fused(kernel, state, device_only=True,
                            reps=N2V_KERNEL_REPS if n2v else FUSED_TIMED_REPS)
            seq = launch_slots(kernel, state, K) if n2v else None
            if name == "node2vec_w":
                warps = grid.blocks * grid.threads // 32
                mean, top = busiest_warp(g, prog.spec, warps, seq)
                print(f"fused_superstep {name} W={W} {where}: the busiest "
                      f"of {warps} warps takes {mean:.1f} chunks a superstep "
                      f"(mean over the launch, most {top}): "
                      f"{ms / len(seq) / mean * 1e3:.3f} us per chunk, "
                      f"{ms / len(seq) * 1e3:.3f} us per superstep")
            if where == "main":
                plain_ms = (plain_s * 1e3 if n2v else
                            time_fused(plain, state, device_only=False,
                                       reps=FUSED_PLAIN_REPS))
                gather_work = n2v_work(g, prog.spec, key, seq) if n2v else None
                bound_ms, bound_by, n_ops, nbytes = fused_bound(
                    prog, cfg, state, got, gather_work)
                print(f"fused_superstep {name} W={W} k={K} "
                      f"main: kernel {ms:.6f} ms/launch "
                      f"({ms / max(ran, 1) * 1e3:.3f} us per superstep), "
                      f"plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms by "
                      f"{bound_by} ({n_ops} int32 ops at "
                      f"{INT32_OPS_PER_S / 1e12:.2f} Tops/s, {nbytes} bytes "
                      f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
                per_kind[name] = {"k": K, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by}
                if name == FUSED_TIMED:
                    row = {"name": "fused_superstep", "route": "cuda",
                           "source": FUSED_SOURCE, "replaces": FUSED_REPLACES,
                           "launches": None, "max_abs_err": None, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": None}
            else:    # the kernel's scaling with W; no plain time
                print(f"fused_superstep {name} W={W} k={K} "
                      f"{where}: kernel {ms:.6f} ms/launch "
                      f"({ms / max(ran, 1) * 1e3:.3f} us per superstep)")
            if W == NUM_SLOTS:
                for budget in (shared_budget(name),
                               *CACHE_EXTRA.get((name, where), ())):
                    cached.append({"name": name, "where": where, **check_cached(
                        name, g, cfg, depth, key, state, K, budget, where, ms,
                        gather_work)})
        print(f"  case time {time.perf_counter() - t_case:.1f} s")
    row["max_abs_err"] = max_err
    row["per_kind"] = per_kind
    tiers = sorted({c["tier"] for c in cached})
    if tiers != ["global", "shared"]:
        raise AssertionError(f"cached launches ran in tiers {tiers}")
    row["cached"] = [c for c in cached if c["where"] == "main"]
    row["checked"] = ("branches uniform, ppr, alias, metapath, rejection, "
                      "reservoir; cache tiers " + ", ".join(
                          sorted({f"{c['tier']} ({c['budget']} B)"
                                  for c in cached})))
    return row


def check_paths(g, starts, res, schedule=None, max_hops=MAX_HOPS) -> None:
    """Every recorded walk starts at its start vertex and every recorded hop
    is an edge of the graph (with ``schedule``: of the type scheduled for
    that hop); lengths and steps agree."""
    import torch
    paths, lengths = res.paths, res.lengths
    q = paths.shape[0]
    if paths.shape != (q, max_hops + 1) or lengths.shape != (q,):
        raise AssertionError(f"result shapes {tuple(paths.shape)}, "
                             f"{tuple(lengths.shape)}")
    if not torch.equal(paths[:, 0], starts):
        raise AssertionError("paths do not begin at their start vertices")
    if int(lengths.min()) < 1 or int(lengths.max()) > max_hops + 1:
        raise AssertionError("lengths out of [1, max_hops + 1]")
    if int(res.stats.steps) != int((lengths - 1).sum()):
        raise AssertionError("stats.steps != recorded hops")
    if int(res.stats.terminations) != q:
        raise AssertionError("not every query terminated")
    t = torch.arange(max_hops, device=paths.device)
    hop = t[None, :] < (lengths[:, None] - 1)
    src, dst = paths[:, :-1][hop].long(), paths[:, 1:][hop].long()
    n = g.num_vertices
    rows = torch.repeat_interleave(
        torch.arange(n, device=paths.device),
        (g.row_ptr[1:] - g.row_ptr[:-1]).long())
    keys = rows * n + g.col.long()
    probe = src * n + dst
    if schedule is not None:
        types = g.num_edge_types
        keys = keys * types + g.edge_type.long()
        sched = torch.tensor(schedule, device=paths.device)
        hop_type = sched[t % len(schedule)][None, :].expand_as(hop)[hop]
        probe = probe * types + hop_type
    keys = torch.sort(keys).values
    pos = torch.searchsorted(keys, probe).clamp(max=keys.numel() - 1)
    if not bool((keys[pos] == probe).all()):
        raise AssertionError("a recorded hop is not an edge of the graph"
                             + (" of its scheduled type" if schedule else ""))
    if bool((paths[~torch.cat([torch.ones_like(hop[:, :1]), hop], 1)]
             != -1).any()):
        raise AssertionError("path entries past a walk's length are not -1")


def same_walks(a, b) -> bool:
    """Paths, lengths and every stat but ``launches`` equal."""
    import torch
    return (torch.equal(a.paths, b.paths) and torch.equal(a.lengths, b.lengths)
            and all(int(x) == int(y) for f, x, y in
                    zip(a.stats._fields, a.stats, b.stats) if f != "launches"))


def run_main_path(graphs, starts_np) -> dict:
    """Phase 3: each program under each of its impls, in turns, through
    the Walker, and node2vec_w's reduced torch run (:func:`run_n2vw_torch`).
    Every run zeroes the launch counts just before it and reads them just
    after; returns each kernel's launches summed over the runs of its
    path."""
    import torch

    from repro_torch.core.scheduler import analyze_run
    from repro_torch.kernels.fused_superstep import ops as fused_ops
    from repro_torch.kernels.walk_step import ops as step_ops
    from repro_torch.walker import ExecutionConfig, compile
    kernel_of = {"urw": "walk_step_uniform", "ppr": "walk_step_uniform",
                 "deepwalk": "walk_step_alias"}
    totals = {**step_ops.LAUNCHES, **fused_ops.LAUNCHES}
    totals = {k: 0 for k in totals}
    for name, prog in programs().items():
        t_prog = time.perf_counter()
        g = graphs[name]
        starts = torch.from_numpy(starts_np).to(g.device)
        walkers = {impl: compile(prog, execution=ExecutionConfig(
            num_slots=NUM_SLOTS, record_paths=True, step_impl=impl,
            hops_per_launch=HOPS_PER_LAUNCH))
            for impl in RUN_ORDER[name]}
        for w in walkers.values():   # warm-up: one batch's worth of starts
            w.run(g, starts[:NUM_SLOTS], seed=0)
        torch.cuda.synchronize()
        results = []
        for impl in RUN_ORDER[name]:   # in turns, so drift in the host's
            step_ops.reset_launches()  # speed shows as spread, not as a gap
            fused_ops.reset_launches()
            t0 = time.perf_counter()
            res = walkers[impl].run(g, starts, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {**step_ops.LAUNCHES, **fused_ops.LAUNCHES}
            drain = walkers[impl].last_drain
            a = analyze_run(res.stats, wall)
            want = {k: 0 for k in launched}
            if impl == "cuda":
                want[kernel_of[name]] = a.supersteps
            if impl == "fused":
                want["fused_superstep"] = a.launches
            if launched != want:
                raise AssertionError(f"{name}/{impl}: kernel launches "
                                     f"{launched}, expected {want}")
            if impl == "fused" and not 0 < a.launches < a.supersteps:
                raise AssertionError(f"{name}/fused: {a.launches} launches "
                                     f"for {a.supersteps} supersteps")
            if impl != "fused" and a.launches != a.supersteps:
                raise AssertionError(f"{name}/{impl}: launches != supersteps")
            check_paths(g, starts, res,
                        prog.spec.metapath if name == "metapath" else None)
            for k in totals:
                totals[k] += launched[k]
            results.append(res)
            RATES[name, impl] = NUM_STARTS / wall   # phase 8 prints it
            if impl == "fused" and name in VERIFIER_PROGRAMS:
                MAIN_FUSED.setdefault(name, res)    # phase 9 compares
            print(f"main {name} step_impl={impl}: "
                  f"walks/s={NUM_STARTS / wall:.1f} "
                  f"MSteps/s={a.msteps_per_s:.4f} supersteps={a.supersteps} "
                  f"launches={a.launches} "
                  f"supersteps_per_launch={a.supersteps_per_launch:.3f} "
                  f"steps={a.steps} bubble_ratio={a.bubble_ratio:.6f} "
                  f"host_sync_share={drain.sync_s / drain.wall_s:.4f} "
                  f"wall_ms_per_superstep={wall / a.supersteps * 1e3:.4f} "
                  f"wall_s={wall:.4f} kernel_launches={launched}")
        for impl, res in zip(RUN_ORDER[name][1:], results[1:]):
            if not same_walks(results[0], res):
                raise AssertionError(f"{name}: {impl} differs from "
                                     f"{RUN_ORDER[name][0]}")
        print(f"main {name}: {' == '.join(dict.fromkeys(RUN_ORDER[name]))} "
              f"in paths, lengths and the {len(res.stats) - 1} stats other "
              f"than launches")
        if name == "node2vec_w":
            run_n2vw_torch(g, starts, results[0])
        print(f"  {name} time {time.perf_counter() - t_prog:.1f} s")
    return totals


def run_cached_main_path(graphs, starts_np) -> int:
    """Phase 3, cached: each program fused through the Walker with the
    hot-vertex cache at shared_budget against the same without it, in turns
    (off, on, on, off; node2vec_w, whose drain takes seconds: on, off), on
    the main path's batch.  Every run zeroes the launch counts just before
    it and reads them just after.  A cached run must equal the uncached one
    in paths, lengths and the 8 stats other than ``launches`` and the
    three cache counters; its cache must be in the shared tier, and every
    live lane-superstep counted once.  URW also runs at the CACHE_OFF
    budgets, which admit no vertex: no cache is built and the counters stay
    0.  Returns the fused kernel's launches over these runs."""
    import dataclasses

    import torch

    from repro_torch.core.scheduler import analyze_run
    from repro_torch.core.walk_engine import maybe_build_cache
    from repro_torch.kernels.fused_superstep import ops as fused_ops
    from repro_torch.kernels.walk_step import ops as step_ops
    from repro_torch.walker import ExecutionConfig, compile
    cache_only = ("launches", "cache_hits", "cache_misses", "cache_coalesced")
    total = 0
    for name, prog in programs().items():
        t_prog = time.perf_counter()
        g = graphs[name]
        starts = torch.from_numpy(starts_np).to(g.device)
        base = ExecutionConfig(num_slots=NUM_SLOTS, record_paths=True,
                               step_impl="fused",
                               hops_per_launch=HOPS_PER_LAUNCH)
        budgets = {"off": 0, "on": shared_budget(name)}
        if name == "urw":
            budgets.update({f"{b} B": b for b in CACHE_OFF})
        walkers = {k: compile(prog, execution=dataclasses.replace(
            base, cache_budget=b)) for k, b in budgets.items()}
        for w in walkers.values():   # warm-up: builds each engine's cache
            w.run(g, starts[:NUM_SLOTS], seed=0)
        cfg = base.engine_config(prog)
        for label, b in budgets.items():
            host = maybe_build_cache(prog.spec, dataclasses.replace(
                cfg, cache_budget=b), g)
            if (host is None) != (label != "on"):
                raise AssertionError(f"{name}: budget {b} built cache {host}")
            if host is not None:
                tier = fused_ops.cache_tier(prog.spec, cfg, fused_ops.cache_block(
                    host, g.device))
                if tier != "shared":
                    raise AssertionError(f"{name}: {b} B cache in tier {tier}")
                print(f"main {name} cache {b} B: H={host.num_hot} "
                      f"P={host.num_entries} nbytes={host.nbytes()} "
                      f"tier={tier}")
        order = (["on", "off"] if name == "node2vec_w"
                 else ["off", "on", "on", "off"]) + [
            k for k in budgets if k not in ("on", "off")]
        results = {}
        torch.cuda.synchronize()
        for label in order:
            step_ops.reset_launches()
            fused_ops.reset_launches()
            t0 = time.perf_counter()
            res = walkers[label].run(g, starts, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {**step_ops.LAUNCHES, **fused_ops.LAUNCHES}
            a = analyze_run(res.stats, wall)
            want = {k: 0 for k in launched}
            want["fused_superstep"] = a.launches
            if launched != want:
                raise AssertionError(f"{name}/cache {label}: kernel launches "
                                     f"{launched}, expected {want}")
            total += launched["fused_superstep"]
            st = res.stats
            hits, misses, coal = (int(st.cache_hits), int(st.cache_misses),
                                  int(st.cache_coalesced))
            live = int(st.slot_steps) - int(st.bubbles)
            if label == "on" and hits + misses + coal != live:
                raise AssertionError(f"{name}: cache counters {hits} + "
                                     f"{misses} + {coal} != {live} live")
            if label != "on" and hits + misses + coal != 0:
                raise AssertionError(f"{name}/cache {label}: counters "
                                     f"{hits}, {misses}, {coal} without a "
                                     f"cache")
            results.setdefault(label, res)
            print(f"main {name} fused cache={label}: "
                  f"walks/s={NUM_STARTS / wall:.1f} "
                  f"MSteps/s={a.msteps_per_s:.4f} supersteps={a.supersteps} "
                  f"launches={a.launches} hits={hits} misses={misses} "
                  f"coalesced={coal} "
                  f"hit_rate={float(st.cache_hit_rate()):.6f} "
                  f"coalesced_share={coal / max(live, 1):.6f} "
                  f"host_sync_share={walkers[label].last_drain.sync_s / walkers[label].last_drain.wall_s:.4f} "
                  f"wall_s={wall:.4f}")
        off = results["off"]
        for label, res in results.items():
            same = (torch.equal(res.paths, off.paths)
                    and torch.equal(res.lengths, off.lengths)
                    and all(int(x) == int(y) for f, x, y in zip(
                        off.stats._fields, off.stats, res.stats)
                        if f not in cache_only))
            if not same:
                raise AssertionError(f"{name}: cached ({label}) differs from "
                                     f"uncached")
        print(f"main {name}: fused with the cache == without it in paths, "
              f"lengths and the {len(off.stats) - 4} stats other than "
              f"launches and the cache counters; "
              f"{time.perf_counter() - t_prog:.1f} s")
    return total


def run_n2vw_torch(g, starts, fused):
    """node2vec_w's torch run, cut to the first 1,024 starts at 1,024 slots
    and N2V_TORCH_HOPS hops (its plain scan repeats the chunk loop's
    tensor ops for every chunk of the live lanes' largest degree): paths
    and lengths equal the full fused run's first 1,024 rows cut to
    N2V_TORCH_HOPS + 1 columns, since a walk is a function of (seed, query
    id, hop) alone."""
    import torch

    from repro_torch.core.scheduler import analyze_run
    from repro_torch.kernels.fused_superstep import ops as fused_ops
    from repro_torch.kernels.walk_step import ops as step_ops
    from repro_torch.walker import ExecutionConfig, WalkProgram, compile
    prog = WalkProgram.node2vec(2.0, 0.5, N2V_TORCH_HOPS, weighted=True)
    w = compile(prog, execution=ExecutionConfig(
        num_slots=N2V_TORCH_STARTS, record_paths=True, step_impl="torch"))
    sv = starts[:N2V_TORCH_STARTS]
    step_ops.reset_launches()
    fused_ops.reset_launches()
    t0 = time.perf_counter()
    res = w.run(g, sv, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {**step_ops.LAUNCHES, **fused_ops.LAUNCHES}
    if any(launched.values()):
        raise AssertionError(f"node2vec_w/torch launched kernels {launched}")
    check_paths(g, sv, res, max_hops=N2V_TORCH_HOPS)
    cols = N2V_TORCH_HOPS + 1
    if not (torch.equal(res.paths, fused.paths[:N2V_TORCH_STARTS, :cols])
            and torch.equal(res.lengths, torch.clamp(
                fused.lengths[:N2V_TORCH_STARTS], max=cols))):
        raise AssertionError(f"node2vec_w: torch ({N2V_TORCH_STARTS} starts, "
                             f"{N2V_TORCH_HOPS} hops) differs from the fused "
                             "run's first rows")
    a = analyze_run(res.stats, wall)
    RATES["node2vec_w", "torch"] = N2V_TORCH_STARTS / wall   # phase 8's cut
    print(f"main node2vec_w step_impl=torch starts={N2V_TORCH_STARTS} "
          f"slots={N2V_TORCH_STARTS} hops={N2V_TORCH_HOPS}: "
          f"walks/s={N2V_TORCH_STARTS / wall:.1f} "
          f"MSteps/s={a.msteps_per_s:.4f} supersteps={a.supersteps} "
          f"steps={a.steps} wall_ms_per_superstep="
          f"{wall / a.supersteps * 1e3:.4f} wall_s={wall:.4f}; paths and "
          f"lengths == the fused run's first {N2V_TORCH_STARTS} rows cut to "
          f"{cols} columns")


def device_trace():
    """A ``torch.profiler`` context that records the device's activities
    only (kernels, copies): recording the host's ops as well slows the
    traced run and multiplies the events to read."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_rows(prof):
    """(device µs, count, name) of each device activity (kernels, copies;
    not the ops that launched them) in a :func:`device_trace`, summed by
    name, largest first.  Read from the trace's raw events, not through
    ``key_averages()``, which builds a Python object an event and took
    longer than a traced LM training step to read it (phase 12)."""
    from torch.autograd import DeviceType
    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us, n = agg.get(e.name(), (0.0, 0))
            agg[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((us, n, k) for k, (us, n) in agg.items()), reverse=True)


def profile_supersteps(graphs, starts_np) -> None:
    """Where the time goes: ``torch.profiler`` over a one-batch run of each
    program under each step impl (the per-hop impls' first 2 supersteps
    only: with their ~1,000 device launches per superstep, whole batches
    made this phase take about 7 minutes on an H100) — device busy time
    (the sum of the device activities' times) against the run's wall time,
    device launches per superstep, and the top kernels.  The profiler's
    own overhead inflates the wall time, so the busy share printed is a
    lower bound."""
    import torch

    from repro_torch.walker import ExecutionConfig, compile
    for name, prog in programs().items():
        t_prog = time.perf_counter()
        g = graphs[name]
        starts = torch.from_numpy(starts_np[:NUM_SLOTS]).to(g.device)
        for impl in dict.fromkeys(RUN_ORDER[name]):
            cap = {} if impl == "fused" else {
                "max_supersteps": PROFILE_SUPERSTEPS}
            w = compile(prog, execution=ExecutionConfig(
                num_slots=NUM_SLOTS, step_impl=impl,
                hops_per_launch=HOPS_PER_LAUNCH, **cap))
            w.run(g, starts[:NUM_SLOTS // 4], seed=0)
            torch.cuda.synchronize()
            with device_trace() as prof:
                res = w.run(g, starts, seed=0)
                torch.cuda.synchronize()
            rows = device_rows(prof)
            supersteps = int(res.stats.supersteps)
            busy_ms = sum(r[0] for r in rows) / 1e3
            wall_ms = w.last_drain.wall_s * 1e3
            if busy_ms == 0:
                print(f"profile {name}/{impl}: device time not measured "
                      f"(the profiler recorded no device activity)")
                continue
            top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{n}"
                            for us, n, k in rows[:5])
            print(f"profile {name}/{impl}: supersteps={supersteps} "
                  f"launches={int(res.stats.launches)} "
                  f"wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
                  f"device_busy_share={busy_ms / wall_ms:.4f} "
                  f"device_launches_per_superstep="
                  f"{sum(r[1] for r in rows) / supersteps:.2f} "
                  f"wall_ms_per_superstep={wall_ms / supersteps:.4f} "
                  f"top: {top}")
        print(f"  profile {name} time {time.perf_counter() - t_prog:.1f} s")


SMALL_HOPS = 8                   # the small batch's hops (2 launches of 4)


def check_small_against_cpu() -> None:
    """A small batch on the card (cuda and fused steps; fused also in
    static mode with a delay, whose drained pool reloads in bulk, and
    without path records) equals the same batch on the CPU (the plain
    per-hop step, and the fused kernel's plain version, whose launches
    must match too)."""
    import torch

    from repro_torch.graph import make_dataset
    from repro_torch.walker import ExecutionConfig, WalkProgram, compile
    starts = np.random.default_rng(1).integers(0, 512, 300).astype(np.int32)
    graphs = {dev: make_dataset("WG", weighted=True, with_alias=True,
                                num_edge_types=3, scale_override=9,
                                device=dev)
              for dev in ("cpu", "cuda")}
    variants = {"cuda": dict(step_impl="cuda"),
                "fused": dict(step_impl="fused"),
                "fused cache 8 KiB": dict(step_impl="fused",
                                          cache_budget=1 << 13),
                "fused static C=2": dict(step_impl="fused", mode="static",
                                         injection_delay=2),
                "fused no paths": dict(step_impl="fused", record_paths=False)}
    h = SMALL_HOPS
    for prog in (WalkProgram.urw(h), WalkProgram.ppr(0.15, h),
                 WalkProgram.deepwalk(h), WalkProgram.metapath(METAPATH, h),
                 WalkProgram.node2vec(2.0, 0.5, h),
                 WalkProgram.node2vec(2.0, 0.5, h, weighted=True)):
        for label, knobs in variants.items():
            def run(dev, knobs=knobs, prog=prog):
                return compile(prog, execution=ExecutionConfig(
                    num_slots=64, hops_per_launch=4, **knobs)).run(
                    graphs[dev], starts, seed=3)
            want, got = run("cpu"), run("cuda")
            rows = torch.nonzero((want.paths != got.paths.cpu()).any(1)
                                 | (want.lengths != got.lengths.cpu()))
            if len(rows) or not all(int(x) == int(y)
                                    for x, y in zip(want.stats, got.stats)):
                q = int(rows[0]) if len(rows) else None
                raise AssertionError(
                    f"{prog.name}/{label}: card differs from the CPU"
                    + (f" first at query {q}: CPU {want.paths[q].tolist()}, "
                       f"card {got.paths[q].tolist()}" if q is not None
                       else " in the stats"))
    print("small batch: card == CPU in paths, lengths and all 12 stats for "
          "urw, ppr, deepwalk, metapath, node2vec, node2vec_w x "
          f"{{{', '.join(variants)}}}")


# ------------------------------------------------------------ the open system

STREAM_CAPACITY = 65_536         # the fused streams' ring of query slots
STREAM_SMALL_CAPACITY = 8_192    # the per-hop impls' ring (for time: they
                                 # take 14-29 ms a superstep)
STREAM_CHUNK = 16                # supersteps an advance
STREAM_BLOCK = 8_192             # arrivals an injection
STREAM_ROUNDS = 3                # arrivals = 3 x capacity: the ring wraps
                                 # at least twice (epochs 0, 1 and 2)
STREAM_SEED = 5
STREAM_PROGRAMS = ("urw", "ppr", "deepwalk", "metapath", "node2vec")
STREAM_PER_HOP = ("urw", "deepwalk")


def stream_walker(name, impl, budget=0):
    from repro_torch.walker import ExecutionConfig, compile
    return compile(programs()[name], execution=ExecutionConfig(
        num_slots=NUM_SLOTS, step_impl=impl, hops_per_launch=HOPS_PER_LAUNCH,
        cache_budget=budget))


def stream_starts(g, capacity):
    return np.random.default_rng(capacity).integers(
        0, g.num_vertices, STREAM_ROUNDS * capacity).astype(np.int32)


def soak(stream, starts, until=None) -> dict:
    """Drive ``stream`` through the arrivals ``starts``, in order: before
    each advance of STREAM_CHUNK supersteps, inject blocks of at most
    STREAM_BLOCK arrivals into every free slot; after it, harvest every
    finished live slot on the device and release it.  Returns the
    harvest (epochs, slot ids, starts, paths, lengths; sorted by (epoch,
    qid)), the loop's wall seconds and their split (``split``: inject,
    advance, the done mask, harvest, release, the rest), its chunks and
    the most epochs live at once.  With ``until``, returns None as soon as
    ``until(stream)`` holds after an advance, leaving the stream
    mid-soak."""
    import torch
    at, chunks, mixed, live = 0, 0, 1, {}
    parts = []
    split = dict.fromkeys(("inject", "advance", "done", "harvest",
                           "release"), 0.0)
    t0 = time.perf_counter()
    while at < len(starts) or stream.num_live:
        while at < len(starts) and stream.num_free:
            n = min(STREAM_BLOCK, stream.num_free, len(starts) - at)
            t = time.perf_counter()
            qids, epochs = stream.inject(starts[at:at + n])
            split["inject"] += time.perf_counter() - t
            parts.append(("in", epochs, qids, starts[at:at + n]))
            for e, c in zip(*np.unique(epochs, return_counts=True)):
                live[int(e)] = live.get(int(e), 0) + int(c)
            mixed = max(mixed, sum(c > 0 for c in live.values()))
            at += n
        t = time.perf_counter()
        if stream.advance(STREAM_CHUNK) == 0 and not (
                at < len(starts) and stream.num_free):
            if not stream.done_live_mask().any():
                raise RuntimeError("stream stalled: live slots, no work")
        split["advance"] += time.perf_counter() - t
        chunks += 1
        if until is not None and until(stream):
            return None
        t = time.perf_counter()
        ready = np.flatnonzero(stream.done_live_mask())
        split["done"] += time.perf_counter() - t
        if ready.size:
            epochs = stream.epoch_of(ready)
            t = time.perf_counter()
            parts.append(("out", epochs, ready, stream.harvest_device(ready)))
            split["harvest"] += time.perf_counter() - t
            for e, c in zip(*np.unique(epochs, return_counts=True)):
                live[int(e)] -= int(c)
            t = time.perf_counter()
            stream.release(ready)
            split["release"] += time.perf_counter() - t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split["rest"] = wall - sum(split.values())
    start_of = {}
    for kind, epochs, qids, x in parts:
        if kind == "in":
            start_of.update(zip(zip(epochs.tolist(), qids.tolist()),
                                x.tolist()))
    outs = [p for p in parts if p[0] == "out"]
    epochs = np.concatenate([p[1] for p in outs]).astype(np.int64)
    qids = np.concatenate([p[2] for p in outs]).astype(np.int64)
    order = np.lexsort((qids, epochs))
    paths = torch.cat([p[3][0] for p in outs])
    lengths = torch.cat([p[3][1] for p in outs])
    idx = torch.from_numpy(order).to(paths.device)
    paths, lengths = paths[idx], lengths[idx]
    epochs, qids = epochs[order], qids[order]
    return {"epochs": epochs, "qids": qids,
            "starts": np.array([start_of[e, q] for e, q in
                                zip(epochs.tolist(), qids.tolist())],
                               np.int32),
            "paths": paths, "lengths": lengths, "wall": wall,
            "split": split, "chunks": chunks, "mixed": mixed}


def harvest_rows(h, sel) -> dict:
    """The rows ``sel`` (a bool mask) of a :func:`soak` harvest."""
    import torch
    pick = torch.from_numpy(np.flatnonzero(sel)).to(h["paths"].device)
    return {"epochs": h["epochs"][sel], "qids": h["qids"][sel],
            "starts": h["starts"][sel], "paths": h["paths"][pick],
            "lengths": h["lengths"][pick]}


def same_harvest(a, b) -> bool:
    return (np.array_equal(a["epochs"], b["epochs"])
            and np.array_equal(a["qids"], b["qids"])
            and np.array_equal(a["starts"], b["starts"])
            and bool((a["paths"] == b["paths"]).all())
            and bool((a["lengths"] == b["lengths"]).all()))


def check_against_closed(name, impl, g, h, capacity, budget=0,
                         seed=STREAM_SEED) -> None:
    """Every harvested (epoch, qid) equals row qid of the closed batch
    ``Walker.run(g, starts_e, seed=stream_key(seed, e))`` under the same
    impl, where starts_e holds each epoch's harvested starts."""
    import torch

    from repro_torch.core.rng import stream_key
    w = stream_walker(name, impl, budget)
    for e in np.unique(h["epochs"]):
        sel = np.flatnonzero(h["epochs"] == e)
        starts_e = np.zeros((capacity,), np.int32)
        starts_e[h["qids"][sel]] = h["starts"][sel]
        res = w.run(g, starts_e, seed=stream_key(seed, int(e)))
        rows = torch.from_numpy(h["qids"][sel]).to(g.device)
        pick = torch.from_numpy(sel).to(g.device)
        if not (torch.equal(res.paths[rows], h["paths"][pick])
                and torch.equal(res.lengths[rows], h["lengths"][pick])):
            raise AssertionError(f"stream {name}/{impl}: epoch {e} differs "
                                 "from its closed batch")


def mixed_wrapped(stream) -> bool:
    """The ring has wrapped (arrivals issued past its capacity) and the
    live lanes hold occupants of at least two epochs."""
    s = stream.state
    return (int(s.queue.head) > stream.capacity
            and int(s.slots.epoch[s.slots.active].unique().numel()) >= 2)


def check_fused_stream_state(graphs) -> None:
    """Phase 2, from a stream's state: for each stream program, a fused
    stream at W = 4,096 and capacity 65,536 driven until its ring has
    wrapped and its live lanes hold two epochs (:func:`mixed_wrapped`);
    one launch of k = 16 from that state through the kernel and through
    its plain version, on copies of it, must leave every state tensor
    equal."""
    import torch

    from repro_torch.core import walk_engine
    from repro_torch.core.rng import stream_key
    from repro_torch.kernels.fused_superstep import LAUNCHES, ops, ref
    key = tuple(int(k) for k in stream_key(STREAM_SEED))
    for name in STREAM_PROGRAMS:
        g = graphs[name]
        stream = stream_walker(name, "fused").stream(
            g, capacity=STREAM_CAPACITY, seed=STREAM_SEED)
        if soak(stream, stream_starts(g, STREAM_CAPACITY),
                until=mixed_wrapped) is not None:
            raise AssertionError(f"stream {name}: the ring never wrapped "
                                 "with mixed epochs live")
        state, cfg = stream.state, stream.cfg
        depth = walk_engine._stage_depth(cfg)
        want = ref.fused_superstep_ref(g, programs()[name].spec, cfg, depth,
                                       clone_state(state), key,
                                       HOPS_PER_LAUNCH)
        work, block = ops.pack(clone_state(state))
        n0 = LAUNCHES["fused_superstep"]
        got = ops.fused_superstep(g, programs()[name].spec, cfg, depth, work,
                                  key, HOPS_PER_LAUNCH, block)
        torch.cuda.synchronize()
        if LAUNCHES["fused_superstep"] != n0 + 1:
            raise AssertionError("fused launch not counted once")
        err = state_err(got, want)
        if err != 0:
            raise AssertionError(f"fused_superstep {name} from a stream "
                                 f"state disagrees with its plain version "
                                 f"(max abs err {err})")
        s = state.slots
        lane_epochs = torch.unique(s.epoch[s.active], return_counts=True)
        print(f"fused_superstep {name} from a stream state (head "
              f"{int(state.queue.head)}, tail {int(state.queue.tail)}, "
              f"capacity {STREAM_CAPACITY}; live lanes by epoch "
              f"{dict(zip(*(t.tolist() for t in lane_epochs)))}): bit-equal "
              f"to the plain version in every state tensor over "
              f"{int(got.stats.supersteps) - int(state.stats.supersteps)} "
              "supersteps (tolerance 0)")


def run_stream(name, impl, g, capacity, budget=0) -> tuple:
    """One stream soak with the launch counts zeroed just before it and
    read just after; checks them and prints the stream's numbers.
    Returns (harvest, stats, launches)."""
    stream = stream_walker(name, impl, budget).stream(
        g, capacity=capacity, seed=STREAM_SEED)
    starts = stream_starts(g, capacity)
    reset_all_launches()
    h = soak(stream, starts)
    launched = embedding_launches()
    st = stream.walk_stats()
    want = {k: 0 for k in launched}
    if impl == "fused":
        want["fused_superstep"] = st.launches
    elif impl == "cuda":
        want["walk_step_alias" if name == "deepwalk"
             else "walk_step_uniform"] = st.supersteps
    if launched != want:
        raise AssertionError(f"stream {name}/{impl}: kernel launches "
                             f"{launched}, expected {want}")
    if len(h["epochs"]) != len(starts) or st.terminations != len(starts):
        raise AssertionError(f"stream {name}/{impl}: harvested "
                             f"{len(h['epochs'])} of {len(starts)}")
    keys = h["epochs"] * capacity + h["qids"]
    if np.unique(keys).size != keys.size or h["mixed"] < 2:
        raise AssertionError(f"stream {name}/{impl}: an (epoch, qid) "
                             "harvested twice, or epochs never mixed")
    if set(range(STREAM_ROUNDS)) - set(h["epochs"].tolist()):
        raise AssertionError(f"stream {name}/{impl}: epochs "
                             f"{sorted(set(h['epochs'].tolist()))}")
    print(f"stream {name} step_impl={impl} capacity={capacity}"
          + (f" cache {budget} B" if budget else "")
          + f": walks/s={len(starts) / h['wall']:.1f} "
          f"launches={st.launches} supersteps={st.supersteps} "
          f"chunks={h['chunks']} host_read_share="
          f"{stream.host_read_s / h['wall']:.4f} wall_s={h['wall']:.4f} "
          f"epochs={sorted(set(h['epochs'].tolist()))} most_epochs_live="
          f"{h['mixed']} steps={st.steps} bubble_ratio="
          f"{st.bubbles / max(st.slot_steps, 1):.6f} wall_split_ms="
          f"{ {k: round(v * 1e3, 3) for k, v in h['split'].items()} } "
          f"kernel_launches={launched}")
    return h, st, launched


def same_stats(a, b, skip=("launches",)) -> bool:
    return all(x == y for f, x, y in zip(a._fields, a, b) if f not in skip)


def run_streams(graphs) -> dict:
    """Phase 5, the open system: ``Walker.stream`` at W = 4,096 and 80 hops
    on the main path's graphs, 3 x capacity arrivals (the ring wraps at
    least twice; slots of two epochs live at once), chunks of 16
    supersteps, arrivals injected in blocks as slots free, every finished
    slot harvested and released (:func:`soak`).  Fused for every stream
    program at capacity 65,536, each (epoch, qid) equal to its closed
    batch; DeepWalk fused with the 229,376-byte cache equal to it without;
    URW and DeepWalk at capacity 8,192 under fused (equal to the closed
    batches), cuda and torch, all three equal.  Returns each kernel's
    launches summed over the runs."""
    totals = {k: 0 for k in embedding_launches()}

    def add(launched):
        for k, n in launched.items():
            totals[k] += n
    for name in STREAM_PROGRAMS:
        g = graphs[name]
        h, st, launched = run_stream(name, "fused", g, STREAM_CAPACITY)
        add(launched)
        check_against_closed(name, "fused", g, h, STREAM_CAPACITY)
        print(f"stream {name}/fused: every harvested (epoch, qid) equals "
              "its closed batch under stream_key(seed, epoch)")
        if name == "deepwalk":
            hc, stc, launched = run_stream(name, "fused", g, STREAM_CAPACITY,
                                           budget=CACHE_SHARED)
            add(launched)
            if not (same_harvest(h, hc) and same_stats(st, stc, (
                    "launches", "cache_hits", "cache_misses",
                    "cache_coalesced")) and stc.cache_hits > 0):
                raise AssertionError("stream deepwalk: cached differs from "
                                     "uncached")
            print(f"stream deepwalk fused cache {CACHE_SHARED} B == uncached "
                  f"(hit rate {stc.cache_hits / max(stc.cache_hits + stc.cache_misses, 1):.6f})")
    for name in STREAM_PER_HOP:
        g = graphs[name]
        runs = {}
        for impl in ("fused", "cuda", "torch"):
            runs[impl] = run_stream(name, impl, g, STREAM_SMALL_CAPACITY)
            add(runs[impl][2])
        check_against_closed(name, "fused", g, runs["fused"][0],
                             STREAM_SMALL_CAPACITY)
        for impl in ("cuda", "torch"):
            if not (same_harvest(runs["fused"][0], runs[impl][0])
                    and same_stats(runs["fused"][1], runs[impl][1])):
                raise AssertionError(f"stream {name}: {impl} differs from "
                                     "fused")
        print(f"stream {name} capacity {STREAM_SMALL_CAPACITY}: fused == "
              "cuda == torch in every harvested walk and every stat but "
              "launches; fused equals its closed batches")
    return totals


# ---------------------------------------------------------------- the service

# Phase 6 runs the request service at the main path's width (W = 4,096,
# 80 hops, 16 supersteps a fused launch) with requests of 64 walks and
# steps of 8 supersteps, the reference's full-size serving benchmark
# (benchmarks/serve_walks.py); its offered loads are set against E[L] =
# max_hops, so the measured utilization is lower where walks end early.
SERVE_CAPACITY = 65_536          # the sweep's ring: 2 x capacity walks a
                                 # point, so every slot is reused
SERVE_SMALL_CAPACITY = 8_192     # the impl-parity ring (the per-hop impls
                                 # take 10-20 ms a superstep)
SERVE_CHUNK = 8                  # supersteps a step
SERVE_REQUEST = 64               # walks a request
SERVE_REQUESTS = 2_048           # requests a sweep point
SERVE_RHOS = (0.5, 0.9, 2.5)     # the reference's points below, near and
                                 # past its saturation
SERVE_ADAPT_REQUESTS = 1_024     # the adaptive run, at rho 2.5
SERVE_PARITY_REQUESTS = 128      # the impl-parity runs, at rho 0.9
SERVE_PROGRAMS = ("urw", "deepwalk")
SERVE_SEED = 11
SERVE_PARTS = {"inject": "inject", "advance": "advance", "done": "done_mask",
               "harvest": "harvest_ids", "release": "release"}


def instrument_service(svc) -> tuple:
    """Wrap the service's stream calls (inject, advance, done_mask,
    harvest_ids, release) with timers, and its ``submit`` with a record of
    each request's starts.  A call made inside another timed call
    (``release``'s own ``done_mask`` read) counts toward the outer one, so
    ``done`` is the harvest's read.  Returns (seconds by part, starts by
    request id), both filled as the service runs; the package itself has
    no timer."""
    split = dict.fromkeys(SERVE_PARTS, 0.0)
    depth = [0]

    def timed(fn, part):
        def call(*args, **kw):
            depth[0] += 1
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    split[part] += time.perf_counter() - t
        return call
    for part, method in SERVE_PARTS.items():
        setattr(svc.stream, method, timed(getattr(svc.stream, method), part))
    starts = {}
    submit = svc.submit

    def recording(start_vertices):
        rid = submit(start_vertices)
        starts[rid] = np.asarray(start_vertices, np.int32).reshape(-1)
        return rid
    svc.submit = recording
    return split, starts


def service_harvest(reqs, starts, device) -> dict:
    """The completed requests as one harvest (the form :func:`soak`
    returns): epochs, slot ids, starts, paths and lengths, paths and
    lengths on ``device``."""
    import torch

    def cat(field):
        return np.concatenate([getattr(r, field) for r in reqs])
    return {"epochs": cat("epochs").astype(np.int64),
            "qids": cat("qids").astype(np.int64),
            "starts": np.concatenate([starts[r.request_id] for r in reqs]),
            "paths": torch.from_numpy(cat("paths")).to(device),
            "lengths": torch.from_numpy(cat("lengths")).to(device)}


def serve_point(svc, name, impl, load, parts, card, graph=None) -> dict:
    """One load point of ``svc``: ``run_open_load`` with the launch counts
    zeroed just before it and read just after.  Checks the launches
    (fused: the kernel's count equals ``launches``; cuda: the walk step's
    equals ``supersteps``), that every request completed with its walks,
    that the (epoch, qid) identities are disjoint across requests, that
    each request's paths begin at its starts, that every recorded hop is
    an edge, and that the wall clocks are ordered submit <= admit <=
    complete.  Prints the point's numbers with the card line.  Returns
    the analysis, requests, stats, launches, harvest, wall and the seed
    the stream ran under.  ``graph`` is the CSR graph the hops are checked
    on (default: the service's own)."""
    import types

    import torch

    from repro_torch.serve import run_open_load
    split, starts = parts
    seed = svc.stream.seed
    split.update(dict.fromkeys(split, 0.0))
    reset_all_launches()
    t0 = time.perf_counter()
    a = run_open_load(svc, load, seed=SERVE_SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = embedding_launches()
    reqs, st = svc.drain(), svc.walk_stats()
    label = f"serve {name}/{impl} capacity={svc.capacity} rho={load.utilization}"
    want = {k: 0 for k in launched}
    if impl == "fused":
        want["fused_superstep"] = st.launches
    elif impl == "cuda":
        want["walk_step_alias" if name == "deepwalk"
             else "walk_step_uniform"] = st.supersteps
    if launched != want:
        raise AssertionError(f"{label}: kernel launches {launched}, "
                             f"expected {want}")
    walks = load.num_requests * load.request_size
    if not (len(reqs) == load.num_requests and all(r.done for r in reqs)
            and a.walks == walks == st.terminations):
        raise AssertionError(f"{label}: {len(reqs)} requests, {a.walks} "
                             f"walks completed of {walks}")
    h = service_harvest(reqs, starts, svc.graph.device)
    keys = h["epochs"] * svc.capacity + h["qids"]
    if np.unique(keys).size != keys.size:
        raise AssertionError(f"{label}: an (epoch, qid) served twice")
    if not all(np.array_equal(r.paths[:, 0], starts[r.request_id])
               for r in reqs):
        raise AssertionError(f"{label}: a request's paths do not begin at "
                             "its starts")
    graph = svc.graph if graph is None else graph
    check_paths(graph, torch.from_numpy(h["starts"]).to(
        graph.device), types.SimpleNamespace(
        paths=h["paths"], lengths=h["lengths"], stats=st),
        max_hops=svc.max_hops)
    if not all(r.wall_submitted <= r.wall_admitted <= r.wall_completed
               for r in reqs):
        raise AssertionError(f"{label}: wall clocks out of order")
    split["rest"] = wall - sum(split.values())
    ms = np.asarray([r.wall_sojourn for r in reqs]) * 1e3
    print(f"{label} chunk={svc.chunk}: offered "
          f"{a.offered_load:.4f} walks/superstep, utilization "
          f"{a.utilization:.4f}; sojourn supersteps p50={a.p50_sojourn} "
          f"p99={a.p99_sojourn} mean={a.mean_sojourn:.4f}; wall ms "
          f"p50={np.percentile(ms, 50):.4f} p99={np.percentile(ms, 99):.4f} "
          f"mean={ms.mean():.4f}; admission wait p50={a.p50_admission_wait} "
          f"p99={a.p99_admission_wait}; walks/s={walks / wall:.1f} "
          f"MStep/s={a.msteps_per_s:.4f} bubble_ratio={a.bubble_ratio:.6f} "
          f"starved_ratio={a.starved_ratio:.6f}; launches={st.launches} "
          f"supersteps={st.supersteps}; host_read_share="
          f"{svc.stream.host_read_s / wall:.4f} wall_s={wall:.4f} "
          f"wall_split_ms={ {k: round(v * 1e3, 3) for k, v in split.items()} } "
          f"epochs={sorted(set(h['epochs'].tolist()))} "
          f"kernel_launches={launched} | {card}")
    return {"analysis": a, "reqs": reqs, "stats": st, "launched": launched,
            "harvest": h, "wall": wall, "seed": seed}


def serve_sweep(name, g, card, add) -> None:
    """Phase 6, step 1: one fused service for ``name`` at capacity 65,536,
    warmed up by 8 requests, then a point for each of SERVE_RHOS with
    ``reset_metrics()`` before it; each point's (epoch, qid) equal to its
    closed batch under ``stream_key(seed, epoch)``, with the ring wrapped
    (epochs 0 and 1 at least: 2 x capacity arrivals, and under a high
    load a slot can go round twice while an early occupant of another is
    still live)."""
    from repro_torch.serve import OpenLoad, run_open_load
    svc = stream_walker(name, "fused").serve(
        g, capacity=SERVE_CAPACITY, chunk=SERVE_CHUNK, seed=SERVE_SEED)
    parts = instrument_service(svc)
    run_open_load(svc, OpenLoad(num_requests=8, request_size=SERVE_REQUEST,
                                utilization=0.5), seed=99)
    for rho in SERVE_RHOS:
        svc.reset_metrics()
        out = serve_point(svc, name, "fused", OpenLoad(
            num_requests=SERVE_REQUESTS, request_size=SERVE_REQUEST,
            utilization=rho), parts, card)
        add(out["launched"])
        if not {0, 1} <= set(out["harvest"]["epochs"].tolist()):
            raise AssertionError(f"serve {name} rho={rho}: the ring did not "
                                 "wrap")
        check_against_closed(name, "fused", g, out["harvest"],
                             SERVE_CAPACITY, seed=out["seed"])
        print(f"serve {name}/fused rho={rho}: every (epoch, qid) equals its "
              f"closed batch under stream_key({out['seed']}, epoch)")


def serve_adaptive(g, card, add) -> None:
    """Phase 6, step 2: URW fused from chunk 2 with the chunk controller
    (1 to 256, patience 2) under rho 2.5: a non-empty trace that grows,
    every chunk within bounds, the trace carried into ``analyze()``."""
    from repro_torch.serve import HopsController, OpenLoad
    svc = stream_walker("urw", "fused").serve(
        g, capacity=SERVE_CAPACITY, chunk=2, seed=SERVE_SEED, adapt=True,
        controller=HopsController(min_chunk=1, max_chunk=256, patience=2))
    out = serve_point(svc, "urw", "fused", OpenLoad(
        num_requests=SERVE_ADAPT_REQUESTS, request_size=SERVE_REQUEST,
        utilization=2.5), instrument_service(svc), card)
    add(out["launched"])
    events = svc.adaptation
    if not (events and any(e.reason == "grow" for e in events)
            and all(1 <= e.chunk_after <= 256 for e in events)
            and out["analysis"].adaptation == events):
        raise AssertionError(f"serve urw adaptive: trace {events}")
    check_against_closed("urw", "fused", g, out["harvest"], SERVE_CAPACITY,
                         seed=out["seed"])
    runs = []                    # the chunk sequence, run-length coded
    for chunk in [2] + [e.chunk_after for e in events]:
        if runs and runs[-1][0] == chunk:
            runs[-1][1] += 1
        else:
            runs.append([chunk, 1])
    reasons = {r: sum(e.reason == r for e in events)
               for r in ("shrink", "grow", "hold")}
    print(f"serve urw/fused adaptive: {len(events)} events {reasons}; "
          f"chunks (chunk x windows) "
          f"{', '.join(f'{c}x{n}' for c, n in runs)}; final chunk "
          f"{svc.chunk}; trace in analyze(); every (epoch, qid) equals its "
          "closed batch")


def serve_parity(name, g, card, add) -> None:
    """Phase 6, step 3: the service at capacity 8,192 under fused, cuda and
    torch on the same load: every request equal in slot ids, epochs,
    paths, lengths and the three superstep clocks; the stats equal but
    ``launches``; the analyses equal but the wall-derived
    ``msteps_per_s``; fused equal to its closed batches."""
    import dataclasses

    from repro_torch.serve import OpenLoad
    load = OpenLoad(num_requests=SERVE_PARITY_REQUESTS,
                    request_size=SERVE_REQUEST, utilization=0.9)
    runs = {}
    for impl in ("fused", "cuda", "torch"):
        svc = stream_walker(name, impl).serve(
            g, capacity=SERVE_SMALL_CAPACITY, chunk=SERVE_CHUNK,
            seed=SERVE_SEED)
        runs[impl] = serve_point(svc, name, impl, load,
                                 instrument_service(svc), card)
        add(runs[impl]["launched"])
    check_against_closed(name, "fused", g, runs["fused"]["harvest"],
                         SERVE_SMALL_CAPACITY, seed=SERVE_SEED)

    def fields(a):
        return {k: v for k, v in dataclasses.asdict(a).items()
                if k != "msteps_per_s"}
    want = runs["fused"]
    for impl in ("cuda", "torch"):
        got = runs[impl]
        same = [all(np.array_equal(np.asarray(getattr(x, f)),
                                   np.asarray(getattr(y, f)))
                    for f in ("qids", "epochs", "paths", "lengths",
                              "submitted_at", "admitted_at", "completed_at"))
                for x, y in zip(got["reqs"], want["reqs"])]
        if not (len(same) == len(want["reqs"]) and all(same)
                and same_stats(got["stats"], want["stats"])
                and fields(got["analysis"]) == fields(want["analysis"])):
            raise AssertionError(f"serve {name}: {impl} differs from fused")
    print(f"serve {name} capacity {SERVE_SMALL_CAPACITY}: fused == cuda == "
          "torch in every request (slot ids, epochs, paths, lengths, "
          "clocks), every stat but launches and every analysis field but "
          "msteps_per_s; fused equals its closed batches")


def run_service(graphs) -> dict:
    """Phase 6, the request service (``Walker.serve`` -> ``WalkService``)
    on the main path's graphs: the load sweep (URW, DeepWalk; fused), the
    adaptive run (URW) and the impl parity (URW, DeepWalk; fused, cuda,
    torch).  Returns each kernel's launches summed over the runs."""
    totals = {k: 0 for k in embedding_launches()}
    card = card_line()

    def add(launched):
        for k, n in launched.items():
            totals[k] += n
    for name in SERVE_PROGRAMS:
        serve_sweep(name, graphs[name], card, add)
    serve_adaptive(graphs["urw"], card, add)
    for name in SERVE_PROGRAMS:
        serve_parity(name, graphs[name], card, add)
    return totals


# ------------------------------------------------------- walks → embeddings

# Phase 4's run: node2vec's published settings (d = 128, walk length 80,
# window 10) with word2vec's 5 negatives, and the reference benchmark's
# batch (benchmarks/e2e_embeddings.py).
# 24 SGNS steps a round: a cut in depth for the time limit (the batch,
# dim, window and negatives are the width).
EMB = dict(seed=0, rounds=4, walks_per_round=65_536, steps_per_round=24,
           batch_size=4_096, dim=128, window=10, num_negatives=5)
EMB_RESUME_SCALE = 16            # the resume check's WG scale
EMB_TIMED_STEPS = 24             # SGNS steps timed for steps/s
EMB_SPLIT_STEPS = 8              # calls timed per part of a step
EMB_LEARN_STEPS = 8              # steps taken on one batch at full width
EMB_SMALL = dict(seed=3, rounds=2, walks_per_round=16, steps_per_round=8,
                 batch_size=32, dim=8, window=3, num_negatives=4)
TABLE_TOL = dict(rtol=1e-5, atol=1e-6)   # the CPU tests' table tolerance
EB_SOURCE = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
EB_REPLACES = "src/repro/kernels/embedding_bag/embedding_bag.py:41"
SS_SOURCE = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"
SS_REPLACES = "src/repro/kernels/segment_sum/segment_sum.py:67"


def embedding_walker():
    from repro_torch.walker import ExecutionConfig, compile
    return compile(programs()["deepwalk"], execution=ExecutionConfig(
        num_slots=NUM_SLOTS, step_impl="fused",
        hops_per_launch=HOPS_PER_LAUNCH))


def sgns_batch(g):
    """The first SGNS batch of phase 4's run, as the path hands its ids to
    the kernels: recorded through ``batch_hook`` in a one-step
    ``train_embeddings`` with EMB's sizes (step 0 samples round 0's walks
    alone, so it is also the full run's first batch)."""
    log = []
    embedding_walker().train_embeddings(
        g, **{**EMB, "rounds": 1, "steps_per_round": 1},
        batch_hook=lambda step, batch: log.append(batch))
    return log[0]


def check_embedding_bag(g, batch, floor) -> dict:
    """Phase 2: the embedding-bag kernel bit-equal to its plain version on
    the card, at the SGNS step's shapes (one-row bags of the ids of a real
    batch: B = 4,096 centers and B = 20,480 negatives, D = 128, R = |V|),
    at ragged B (1, 31, 33, 20,481: one warp, a warp either side of a
    block, a ragged last block), at H = 2 and 7 with -1
    pads and weights, at D = 100 (25 float4 words a row, a partial warp;
    H = 7 also against the CPU) and D = 102 (the scalar path), and from a
    table view whose data pointer is 4 bytes past 16-byte alignment (the
    scalar path at D = 128), each printing the path it took (float4 or
    scalar).  Each path shape timed cold and warm with its plain version, its bound,
    torch.nn.functional.embedding_bag and the launch floor, and the SGNS
    step's three gathers back to back (each launch a programmatic
    dependent of the one before); the JSON row is B = 20,480 cold."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops, ref
    gen = torch.Generator(device=g.device).manual_seed(0)
    R, D = g.num_vertices, EMB["dim"]
    table = torch.randn((R, D), generator=gen, device=g.device)
    centers, _, negatives, _ = batch
    rng = np.random.default_rng(7)

    def dev(x):
        return torch.from_numpy(x).to(g.device)

    def bags(B, H, pads=False):
        return dev(rng.integers(-1 if pads else 0, R, (B, H)).astype(np.int32))

    def weights(B, H):
        return dev(rng.random((B, H), dtype=np.float32))
    table100 = torch.randn((R, 100), generator=gen, device=g.device)
    table102 = torch.randn((R, 102), generator=gen, device=g.device)
    unaligned = torch.randn((R * D + 1,), generator=gen,
                            device=g.device)[1:].view(R, D)
    cases = {"path B=4096": (centers[:, None].contiguous(), table, None),
             "path B=20480": (negatives.reshape(-1, 1), table, None),
             "B=1": (bags(1, 1), table, None),
             "B=31": (bags(31, 1), table, None),
             "B=33": (bags(33, 1), table, None),
             "B=20481": (bags(20_481, 1), table, None),
             "B=4096 H=2 pads, weights": (bags(4_096, 2, True), table,
                                          weights(4_096, 2)),
             "B=4096 H=7 pads, weights": (bags(4_096, 7, True), table,
                                          weights(4_096, 7)),
             "general B=4096 H=7 D=100 pads, weights": (
                 bags(4_096, 7, True), table100, weights(4_096, 7)),
             "B=20480 D=100": (negatives.reshape(-1, 1), table100, None),
             "B=20480 D=102": (negatives.reshape(-1, 1), table102, None),
             "unaligned table B=20480": (negatives.reshape(-1, 1), unaligned,
                                         None)}
    row = None
    for label, args in cases.items():
        got, want = ops.embedding_bag(*args), ref.embedding_bag_ref(*args)
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"embedding_bag {label} disagrees with its "
                                 f"plain version (max abs err {err})")
        text = ""
        if label.startswith("general"):
            cpu = ref.embedding_bag_ref(*(a.cpu() for a in args))
            if not torch.equal(got.cpu(), cpu):
                raise AssertionError(f"embedding_bag {label} differs from "
                                     "the plain version on the CPU")
            text = "; equal to the plain version on the CPU"
        idx, tbl, _ = args
        vec = ops.vectorized(tbl, got)
        if label.startswith("unaligned") and vec:
            raise AssertionError("embedding_bag: an unaligned table took "
                                 "the float4 path")
        print(f"embedding_bag {label}: bit-equal to the plain version "
              f"(tolerance 0){text}; {'float4' if vec else 'scalar'} path")
        if not label.startswith("path"):
            continue
        B = idx.shape[0]
        ids = idx.clamp(0, R - 1).long()
        fns = {"kernel": lambda: ops.embedding_bag(*args),
               "plain": lambda: ref.embedding_bag_ref(*args),
               "F.embedding_bag": lambda: F.embedding_bag(ids, tbl,
                                                          mode="sum")}
        cold = {k: time_cold(f) for k, f in fns.items()}
        warm = {k: time_launches(f) for k, f in fns.items()}
        ms, plain_ms, library_ms = cold.values()
        rows = int(torch.unique(ids).numel())
        nbytes = B * 4 + rows * D * 4 + B * D * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * B * D / CUDA_CORE_OPS_PER_S * 1e3
        print(f"embedding_bag {label}: cold L2 (the path's case: the table "
              f"was just rewritten by AdamW) " + ", ".join(
                  f"{k} {v:.6f} ms" for k, v in cold.items())
              + "; warm L2 (graph replays) " + ", ".join(
                  f"{k} {v:.6f} ms" for k, v in warm.items())
              + f"; {floor_text(floor)}; bound {max(t_bytes, t_ops):.6f} ms "
              f"({nbytes} bytes: the ids, {rows} distinct rows of {D} "
              f"floats, the output); kernel/F.embedding_bag cold "
              f"{ms / library_ms:.4f}")
        row = {"name": "embedding_bag", "route": "cuda", "source": EB_SOURCE,
               "replaces": EB_REPLACES, "launches": None, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms}
    cold, warm = step_gathers(ops.embedding_bag, table, batch)
    print(f"embedding_bag the SGNS step's three gathers back to back (B = "
          f"4,096, 4,096, 20,480): cold {cold:.6f} ms, warm {warm:.6f} ms; "
          f"{floor_text(floor)}")
    return row


def step_gathers(embedding_bag, table, batch) -> tuple[float, float]:
    """(cold, warm) ms of the SGNS step's three gathers, as ``loss_fn``
    issues them back to back (centers, contexts, negatives of ``batch``
    from ``table``), through the wrapper ``embedding_bag``."""
    centers, contexts, negatives, _ = batch
    step = (centers[:, None].contiguous(), contexts[:, None].contiguous(),
            negatives.reshape(-1, 1))

    def gathers():
        for ids in step:
            embedding_bag(ids, table)
    return time_cold(gathers), time_launches(gathers)


def segment_sum_split(data, ids, S):
    """(fill ms, link ms, rows ms) of one segment-sum call: its three C
    entry points timed apart (CUDA-graph replays), on scratch of the
    wrapper's shapes: the fill (zeros into the result), the ordering
    (each position linked into its segment's chain) and the non-empty
    rows' sums over the chains the link left."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    lib = build.load("segment_sum")
    P, I = ctypes.c_void_p, ctypes.c_int
    fill, link, rows = (lib.segment_sum_fill, lib.segment_sum_link,
                        lib.segment_sum_rows)
    fill.argtypes, fill.restype = [P] * 2 + [I] * 4 + [P], I
    link.argtypes, link.restype = [P] * 4 + [I] * 3 + [P], I
    rows.argtypes, rows.restype = [P] * 5 + [I] * 4 + [P], I
    E, D = data.shape
    out = torch.empty((S, D), device=data.device)
    nxt = torch.empty((max(E, 1),), dtype=torch.int32, device=data.device)
    linked = torch.empty((max(E, 1),), dtype=torch.uint8, device=data.device)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(rc):
        if rc:
            raise RuntimeError(f"segment_sum part failed: cudaError {rc}")

    def run_fill():
        check(fill(out.data_ptr(), linked.data_ptr(), E, S, D, 1, stream()))

    def run_link():   # on a fill just made, as in a call
        check(link(ids.data_ptr(), out.data_ptr(), nxt.data_ptr(),
                   linked.data_ptr(), E, S, D, stream()))

    def run_rows():
        check(rows(data.data_ptr(), ids.data_ptr(), nxt.data_ptr(),
                   linked.data_ptr(), out.data_ptr(), E, S, D, 1, stream()))
    fill_ms = time_launches(run_fill)
    link_ms = time_launches(lambda: (run_fill(), run_link())) - fill_ms
    run_fill()
    run_link()
    return fill_ms, link_ms, time_launches(run_rows)


def check_segment_sum(g, batch) -> dict:
    """Phase 2: the segment-sum kernel, over the ids of a real SGNS batch
    (E = 4,096 centers, 20,480 negatives, 24,576 contexts and negatives;
    S = |V|, D = 128) and a general case (E = 24,576, D = 100, one hub
    segment holding 20% of the ids, empty segments, ids outside [0, S)),
    each launched twice: the two results identical bytes, equal bit for
    bit to the plain version on CPU copies, empty segments 0, and within
    1e-3 of index_add_ on the card (atomics: another order of adds).  Then
    the path's E = 24,576 ids, the general case's hub ids (over 1,024 of
    one id) and the path's again, one call each over the same data: each
    equal to its own plain version, so no chain outlives its call.  The
    path shapes timed with the plain version on the card, the bound and
    ``torch.zeros(S, D).index_add_``, and split into the ordering pass
    (the link) and the dense pass (the fill and the rows' sums;
    :func:`segment_sum_split`); the JSON row is E = 20,480."""
    import torch

    from repro_torch.kernels.segment_sum import ops, ref
    gen = torch.Generator(device=g.device).manual_seed(1)
    S, D = g.num_vertices, EMB["dim"]
    _, contexts, negatives, _ = batch
    rng = np.random.default_rng(8)
    hub = rng.integers(0, S, 24_576).astype(np.int32)
    hub[rng.random(24_576) < 0.2] = S // 3
    hub[::97], hub[1::101] = -1, S
    cases = {"path E=4096": (batch[0], D),
             "path E=20480": (negatives.reshape(-1), D),
             "path E=24576": (torch.cat([contexts, negatives.reshape(-1)]),
                              D),
             "general E=24576 D=100 hub 20%": (
                 torch.from_numpy(hub).to(g.device), 100)}
    row, max_err = None, 0.0
    for label, (ids, dim) in cases.items():
        data = torch.randn((ids.shape[0], dim), generator=gen,
                           device=g.device)
        got = ops.segment_sum(data, ids, S)
        again = ops.segment_sum(data, ids, S)
        want = ref.segment_sum_ref(data.cpu(), ids.cpu(), S)
        if not torch.equal(got, again):
            raise AssertionError(f"segment_sum {label}: two launches differ")
        err = float((got.cpu() - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"segment_sum {label} disagrees with its "
                                 f"plain version (max abs err {err})")
        hit = torch.zeros(S, dtype=torch.bool, device=g.device)
        hit[ids[(ids >= 0) & (ids < S)].long()] = True
        if bool((got[~hit] != 0).any()):
            raise AssertionError(f"segment_sum {label}: an empty segment "
                                 "is not 0")
        atomic = ref.segment_sum_ref(data, ids, S)
        atomic_err = float((got - atomic).abs().max())
        if atomic_err > 1e-3:
            raise AssertionError(f"segment_sum {label}: {atomic_err} from "
                                 "index_add_ on the card")
        runs = torch.unique(ids[(ids >= 0) & (ids < S)], return_counts=True)
        print(f"segment_sum {label}: identical bytes over two launches, "
              f"bit-equal to the plain version on the CPU (tolerance 0), "
              f"{int((~hit).sum())} empty segments 0, largest segment "
              f"{int(runs[1].max())} rows; index_add_ on the card within "
              f"{atomic_err:.3g} (tolerance 1e-3)")
        if not label.startswith("path"):
            continue
        E = ids.shape[0]
        ms = time_launches(lambda: ops.segment_sum(data, ids, S))
        plain_ms = time_launches(lambda: ref.segment_sum_ref(data, ids, S))
        lids = ids.long()
        library_ms = time_launches(lambda: torch.zeros(
            (S, dim), device=g.device).index_add_(0, lids, data))
        fill_ms, link_ms, rows_ms = segment_sum_split(data, ids, S)
        nbytes = E * dim * 4 + E * 4 + S * dim * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = E * dim / CUDA_CORE_OPS_PER_S * 1e3
        print(f"segment_sum {label}: kernel {ms:.6f} ms (ordering pass: "
              f"link {link_ms:.6f} ms; dense pass: fill {fill_ms:.6f} ms + "
              f"rows {rows_ms:.6f} ms), plain (on "
              f"the card, atomics) {plain_ms:.6f} ms, zeros + index_add_ "
              f"{library_ms:.6f} ms ({'no slower' if ms <= library_ms else 'SLOWER'}"
              f" than the wrapper: {ms / library_ms:.4f}x), bound "
              f"{max(t_bytes, t_ops):.6f} ms ({nbytes} bytes: the data and "
              f"ids read, the dense output written)")
        if label == "path E=20480":
            row = {"name": "segment_sum", "route": "cuda",
                   "source": SS_SOURCE, "replaces": SS_REPLACES,
                   "launches": None, "max_abs_err": None, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": library_ms}
    data = torch.randn((24_576, D), generator=gen, device=g.device)
    path_ids, hub_ids = cases["path E=24576"][0], cases[
        "general E=24576 D=100 hub 20%"][0]
    for ids in (path_ids, hub_ids, path_ids):
        got = ops.segment_sum(data, ids, S)
        if not torch.equal(got.cpu(), ref.segment_sum_ref(data.cpu(),
                                                          ids.cpu(), S)):
            raise AssertionError("segment_sum: a call after one with other "
                                 "ids disagrees with its plain version")
    print(f"segment_sum changed ids (path, hub {int((hub_ids == S // 3).sum())}"
          " entries of one id, path) over one data: each call bit-equal to "
          "its plain version on the CPU")
    row["max_abs_err"] = max_err
    return row


def embedding_launches():
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.fused_superstep import ops as fused_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.kernels.walk_step import ops as step_ops
    return {**step_ops.LAUNCHES, **fused_ops.LAUNCHES, **eb_ops.LAUNCHES,
            **ss_ops.LAUNCHES}


def reset_all_launches():
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.fused_superstep import ops as fused_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.kernels.walk_step import ops as step_ops
    for ops in (step_ops, fused_ops, eb_ops, ss_ops):
        ops.reset_launches()


# Each of phase 4's and phase 8's embeddings runs ends within this many
# seconds, or the script prints every thread's stack and exits 1: a
# cooperative fused launch that could never become resident beside the
# SGNS kernels on the consumer's stream would hang there (the whole of
# phase 4 took 31.8-47.6 s on an H100).
EMB_LIMIT_S = 300
# The traced overlapped run: 2 rounds at EMB's width, 4 steps a round (a
# round's walks take 10-45 ms, a step ~36 ms on an H100), cut in depth
# for the time limit.
EMB_TRACE = {**EMB, "rounds": 2, "steps_per_round": 4}


@contextlib.contextmanager
def phase_limit(seconds=EMB_LIMIT_S):
    """Exit the script (code 1, every thread's stack on stderr) if the
    block has not ended within ``seconds``."""
    import faulthandler
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


@contextlib.contextmanager
def pipeline_clock():
    """Timers the script wraps around ``train_loop.run_pipelined``'s
    producer and append functions and around the wait for an overlapped
    round (the package has none).  Yields a dict that the run fills:
    ``produce`` (each round's wall, on the thread that produced it: a
    round is whole on the device when its drain returns), ``append``
    (the host time at which each round's append began), ``wait`` (each
    wait for an overlapped round) and ``end`` (when the loop returned)."""
    from repro_torch.runtime import train_loop
    rec = {"produce": [], "append": [], "wait": [], "end": None}
    real_run, real_result = train_loop.run_pipelined, \
        train_loop._InFlight.result

    def run(produce_fn, append_fn, *args, **kw):
        def produce(r):
            t = time.perf_counter()
            walks = produce_fn(r)
            rec["produce"].append(time.perf_counter() - t)
            return walks

        def append(ring, walks):
            rec["append"].append(time.perf_counter())
            return append_fn(ring, walks)
        try:
            return real_run(produce, append, *args, **kw)
        finally:
            rec["end"] = time.perf_counter()

    def result(self):
        t = time.perf_counter()
        try:
            return real_result(self)
        finally:
            rec["wait"].append(time.perf_counter() - t)
    train_loop.run_pipelined, train_loop._InFlight.result = run, result
    try:
        yield rec
    finally:
        train_loop.run_pipelined = real_run
        train_loop._InFlight.result = real_result


def pipeline_walls(rec, overlapped: bool) -> dict:
    """Per-round walls of a :func:`pipeline_clock` record, in ms: the
    producer's; the caller's waits for a round (an overlapped run's
    measured waits; a serial run's producer, which runs in the caller's
    thread); the consumer's (from a round's append to the next one's, less
    the wait for the next round; the last to the loop's end)."""
    produce = [t * 1e3 for t in rec["produce"]]
    wait = [t * 1e3 for t in (rec["wait"] if overlapped else rec["produce"])]
    marks = rec["append"] + [rec["end"]]
    consumer = [(b - a) * 1e3 - (wait[i + 1] if i + 1 < len(wait) else 0.0)
                for i, (a, b) in enumerate(zip(marks, marks[1:]))]
    return {"produce": produce, "wait": wait, "consumer": consumer}


def fmt_ms(xs) -> str:
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


def print_overlap(tag, walls, labels, serial, card) -> None:
    """Each run's walls a round, then the share of the producer's time that
    each overlapped run hid: ``(serial wall - overlapped wall) / summed
    producer wall`` (the serial run's producer, which nothing contends
    with; the serial wall also holds the baseline's host round-trips), and
    the share the consumer did not wait for (``1 - waits / producer``,
    over the rounds after the first, which nothing can hide)."""
    for label in labels:
        wall, pw = walls[label]
        print(f"{tag} {label}: wall {wall:.4f} s; producer wall a round (ms) "
              f"{fmt_ms(pw['produce'])}; consumer wall a round (ms) "
              f"{fmt_ms(pw['consumer'])}; waits for the producer (ms) "
              f"{fmt_ms(pw['wait'])} | {card}")
    s_wall, s_pw = walls[serial]
    summed = sum(s_pw["produce"])
    for label in labels:
        wall, pw = walls[label]
        if label == serial:
            continue
        later = sum(pw["produce"][1:])
        waited = sum(pw["wait"][1:])
        unwaited = (f"{1 - waited / later:.4f}" if later > 0
                    else "not measured (one round)")
        print(f"{tag} {label} vs {serial}: hidden share (serial wall - "
              f"overlapped wall) / summed producer wall = ({s_wall:.4f} - "
              f"{wall:.4f}) / {summed / 1e3:.4f} = "
              f"{(s_wall - wall) / (summed / 1e3):.4f}; producer time after "
              f"round 0 not waited for: {unwaited} ({waited:.3f} of "
              f"{later:.3f} ms waited) | {card}")


def overlap_trace(prof) -> dict:
    """Device activities of a :func:`device_trace` of an overlapped run:
    how many fused launches intersect an embedding-bag or segment-sum
    interval, and how many intersect any activity on a stream the fused
    launches did not run on (the sampler's kernels and copies
    included), out of all fused launches; and the streams each ran on
    (kineto's resource id of the activity)."""
    from torch.autograd import DeviceType
    acts = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.device_resource_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    fused = [a for a in acts if "fused_superstep" in a[0]]
    sgns = [a for a in acts if "embedding_bag" in a[0]
            or (a[0].startswith("segment_") and "_kernel" in a[0])]
    fused_streams = {a[3] for a in fused}
    other = [a for a in acts if a[3] not in fused_streams]

    def hits(among):
        return sum(any(c < b and a < d for _, c, d, _ in among)
                   for _, a, b, _ in fused)
    return {"fused": len(fused), "sgns": len(sgns), "overlapping": hits(sgns),
            "other": len(other), "overlapping_other": hits(other),
            "fused_streams": sorted(fused_streams),
            "sgns_streams": sorted({a[3] for a in sgns})}


def run_embeddings(g) -> dict:
    """Phase 4: ``Walker.train_embeddings`` at full width (EMB) on the main
    path's graph, overlapped, serial and overlapped again, each run with
    the launch counts zeroed just before it and read just after: 3
    embedding-bag and 3 segment-sum launches a step, fused launches for
    the producer, none of the walk-step kernels; no recorded host copy
    when overlapped, one per round and per step when serial; the three
    runs' tables, moments and rings equal; the ring holding the walks of
    the last two rounds, as ``Walker.run`` gives them; the losses finite.
    Each run's walls (:func:`pipeline_clock`, :func:`print_overlap`), and
    a trace of one overlapped round (:func:`trace_embeddings_overlap`).
    Then the producer's walks/s, SGNS steps/s and the per-step device time
    of the sampler, forward + backward and AdamW.  Returns the launches
    summed over the three runs."""
    import torch

    from repro_torch.core import corpus_ring
    from repro_torch.core.rng import stream_key
    w = embedding_walker()
    card = card_line().replace("\n", "; ")
    steps = EMB["rounds"] * EMB["steps_per_round"]
    want_launched = {k: 0 for k in embedding_launches()}
    want_launched.update(embedding_bag=3 * steps, segment_sum=3 * steps)
    totals = {k: 0 for k in want_launched}
    outs, walls = [], {}
    for label in ("overlap", "serial", "overlap again"):
        reset_all_launches()
        copies = corpus_ring.host_copies()
        torch.cuda.synchronize()
        overlap = label != "serial"
        t0 = time.perf_counter()
        with phase_limit(), pipeline_clock() as rec:
            if overlap:
                with corpus_ring.no_host_copies():
                    out = w.train_embeddings(
                        g, **EMB, log_every=EMB["steps_per_round"])
            else:
                out = w.train_embeddings(g, **EMB, overlap=False,
                                         log_every=EMB["steps_per_round"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls[label] = wall, pipeline_walls(rec, overlap)
        launched = embedding_launches()
        copies = corpus_ring.host_copies() - copies
        fused = launched["fused_superstep"]
        if fused <= 0 or {**launched, "fused_superstep": 0} != want_launched:
            raise AssertionError(f"embeddings {label}: kernel launches "
                                 f"{launched}, expected {want_launched} and "
                                 "fused launches")
        if copies != (0 if overlap else EMB["rounds"] + steps):
            raise AssertionError(f"embeddings {label}: {copies} host copies")
        for k in totals:
            totals[k] += launched[k]
        losses = [h["loss"] for h in out["history"]]
        if out["step"] != steps or not np.all(np.isfinite(losses)):
            raise AssertionError(f"embeddings {label}: step {out['step']}, "
                                 f"losses {losses}")
        print(f"embeddings {label}: {steps} steps, "
              f"{EMB['rounds'] * EMB['walks_per_round']} walks in "
              f"{wall:.3f} s; losses at steps "
              f"{[h['step'] for h in out['history']]}: "
              f"{[round(x, 6) for x in losses]}; host copies {copies}; "
              f"kernel launches {launched}")
        outs.append(out)
    print_overlap("embeddings", walls, list(walls), "serial", card)
    first = outs[0]
    for label, out in zip(("serial", "overlap again"), outs[1:]):
        same = (all(torch.equal(first["params"][k], out["params"][k])
                    and torch.equal(first["opt_state"].nu[k],
                                    out["opt_state"].nu[k])
                    for k in first["params"])
                and all(torch.equal(a, b)
                        for a, b in zip(first["ring"], out["ring"])))
        if not same:
            raise AssertionError(f"embeddings: {label} differs from the "
                                 "overlapped run")
    for k, t in first["params"].items():
        if t.shape != (g.num_vertices, EMB["dim"]) or not bool(
                torch.isfinite(t).all()):
            raise AssertionError(f"embeddings: {k} {tuple(t.shape)} not "
                                 "finite")
    n = EMB["walks_per_round"]
    ring = first["ring"]
    for r in (EMB["rounds"] - 2, EMB["rounds"] - 1):
        starts = ((r * n + torch.arange(n, device=g.device))
                  % g.num_vertices).int()
        res = w.run(g, starts, seed=stream_key(EMB["seed"], r))
        rows = slice((r * n) % ring.capacity, (r * n) % ring.capacity + n)
        if not (torch.equal(ring.paths[rows], res.paths)
                and torch.equal(ring.lengths[rows], res.lengths)):
            raise AssertionError(f"embeddings: ring rows of round {r} differ "
                                 "from Walker.run's walks")
    print("embeddings: serial == overlap == overlap again in both tables, "
          "the moments and the ring; the ring holds rounds "
          f"{EMB['rounds'] - 2} and {EMB['rounds'] - 1} as Walker.run "
          "gives them; tables finite")
    del outs
    with timed("embeddings overlap trace"), phase_limit():
        trace_embeddings_overlap(g, w, card)
    with timed("embeddings measure"):
        measure_embeddings(g, w, first)
    with timed("embeddings step vs CPU"):
        check_embeddings_step(g, first)
    return totals


def trace_embeddings_overlap(g, w, card) -> None:
    """A device trace of one overlapped round: ``train_embeddings`` at
    EMB_TRACE (round 1's walks produced while round 0's steps are
    issued).  Prints how many fused launches ran at the same time as an
    embedding-bag or segment-sum kernel, or as any activity on another
    stream, and on which streams each ran; the run's tables and ring
    equal an untraced run of the same rounds."""
    import torch
    kw = EMB_TRACE
    want = w.train_embeddings(g, **kw)
    torch.cuda.synchronize()
    with device_trace() as prof:
        got = w.train_embeddings(g, **kw)
        torch.cuda.synchronize()
    if not (all(torch.equal(got["params"][k], want["params"][k])
                for k in want["params"])
            and all(torch.equal(a, b) for a, b in zip(got["ring"],
                                                      want["ring"]))):
        raise AssertionError("embeddings: the traced overlapped run differs")
    t = overlap_trace(prof)
    if t["fused"] == 0:
        print(f"embeddings overlap trace: not measured (the profiler "
              f"recorded no fused launch) | {card}")
        return
    print(f"embeddings overlap trace (2 rounds of {kw['walks_per_round']} "
          f"walks, {kw['steps_per_round']} steps a round): "
          f"{t['overlapping']} of {t['fused']} fused launches intersect an "
          f"embedding-bag or segment-sum interval ({t['sgns']} of those), "
          f"{t['overlapping_other']} intersect a device activity on another "
          f"stream ({t['other']} of those: the step's sampler, gathers, "
          f"AdamW and copies); fused on streams {t['fused_streams']}, "
          f"embedding-bag and segment-sum on streams {t['sgns_streams']} | "
          f"{card}")


def part_times(fn, reps=EMB_SPLIT_STEPS):
    """(wall ms, device busy ms, device activities) per call of ``fn``:
    the wall time from the host clock around ``reps`` calls ending in a
    synchronize; the busy time and activity count from a
    ``torch.profiler`` trace of ``reps`` more (the sum of the device
    activities' times, so host gaps are not counted)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with device_trace() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return (wall, sum(r[0] for r in rows) / reps / 1e3,
            sum(r[1] for r in rows) / reps)


def measure_embeddings(g, w, out) -> None:
    """The producer's walks/s (a round's drain, twice), SGNS steps/s
    (EMB_TIMED_STEPS steps from the trained state, host clock around the
    loop), and each part of a step — the sampler, forward + backward,
    AdamW — alone: its wall time, its device busy time and its device
    activities (:func:`part_times`)."""
    import torch

    from repro_torch.core import corpus_ring
    from repro_torch.core.rng import stream_key
    from repro_torch.models import embeddings as emb
    from repro_torch.optim import adamw
    n = EMB["walks_per_round"]
    for r in range(2):
        starts = ((r * n + torch.arange(n, device=g.device))
                  % g.num_vertices).int()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.run(g, starts, seed=stream_key(EMB["seed"], r))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"embeddings producer round {r}: {n} walks in {wall:.4f} s, "
              f"walks/s={n / wall:.1f} "
              f"host_sync_share={w.last_drain.sync_s / w.last_drain.wall_s:.4f}")
    steps = EMB["rounds"] * EMB["steps_per_round"]
    sg_cfg = emb.SkipGramConfig(num_vertices=g.num_vertices, dim=EMB["dim"],
                                num_negatives=EMB["num_negatives"],
                                window=EMB["window"])
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=max(1, steps // 10),
                                total_steps=steps)
    sample = corpus_ring.make_batch_sampler(
        g.num_vertices, EMB["batch_size"], EMB["window"],
        EMB["num_negatives"])
    sgns = emb.make_sgns_step(sg_cfg, opt_cfg)
    key = stream_key(EMB["seed"])
    params, opt, ring = out["params"], out["opt_state"], out["ring"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(steps, steps + EMB_TIMED_STEPS):
        params, opt, _ = sgns(params, opt, sample(ring, key, s))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / EMB_TIMED_STEPS * 1e3
    print(f"embeddings SGNS: {EMB_TIMED_STEPS} steps, "
          f"steps/s={1e3 / step_ms:.2f}, wall_ms_per_step={step_ms:.4f}")
    keys = sorted(params)
    batch = sample(ring, key, steps)

    def forward_backward():
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        loss = emb.loss_fn(leaves, *batch[:3], mask=batch[3])
        return dict(zip(keys, torch.autograd.grad(
            loss, [leaves[k] for k in keys])))
    grads = forward_backward()
    parts = {"sampler": lambda: sample(ring, key, steps),
             "forward+backward": forward_backward,
             "adamw": lambda: adamw.apply_updates(params, grads, opt,
                                                  opt_cfg)}
    busy_total = 0.0
    for name, fn in parts.items():
        wall, busy, acts = part_times(fn)
        busy_total += busy
        print(f"embeddings part {name}: wall_ms={wall:.4f} "
              f"device_busy_ms={busy:.4f} device_activities={acts:.1f}")
    adam_bytes = 2 * 7 * g.num_vertices * EMB["dim"] * 4
    print(f"embeddings step: device busy {busy_total:.4f} ms of a "
          f"{step_ms:.4f} ms step (idle share "
          f"{1 - busy_total / step_ms:.4f}); AdamW's bound "
          f"{adam_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({adam_bytes} bytes: "
          f"each table, its gradient and both moments read, the table and "
          f"moments written)")


def check_embeddings_step(g, out) -> None:
    """Phase 4: a full-width SGNS step does what it should.  The runs'
    losses stay near the untrained 6·ln 2 = 4.159: a step's 4,096 centers
    are 0.4% of the 2^20 rows, so most rows of the next batch were never
    trained.  So one batch sampled from the trained ring is taken
    EMB_LEARN_STEPS times from the trained tables with fresh moments (lr
    1e-2 held).  The first step is held to CPU copies in its two halves:
    the gradients within rtol 1e-5 and an atol of 1e-6 of the largest
    gradient (the loss's reductions add in another order, so each term
    differs by ulps), and AdamW on the same gradients within TABLE_TOL.
    The whole step is not compared: Adam's first step divides each
    gradient by its own magnitude, so a gradient near ``eps`` turns an
    ulp of the loss into up to ``lr`` of the table.  Then the batch's loss
    must fall at every step."""
    import torch

    from repro_torch.core import corpus_ring
    from repro_torch.core.rng import stream_key
    from repro_torch.models import embeddings as emb
    from repro_torch.optim import adamw
    sg_cfg = emb.SkipGramConfig(num_vertices=g.num_vertices, dim=EMB["dim"],
                                num_negatives=EMB["num_negatives"],
                                window=EMB["window"])
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1,
                                total_steps=EMB_LEARN_STEPS, min_lr_ratio=1.0)
    batch = corpus_ring.make_batch_sampler(
        g.num_vertices, EMB["batch_size"], EMB["window"],
        EMB["num_negatives"])(out["ring"], stream_key(EMB["seed"]),
                              EMB["rounds"] * EMB["steps_per_round"])
    keys = sorted(out["params"])

    def loss_and_grads(tables, b):
        leaves = {k: tables[k].detach().requires_grad_(True) for k in keys}
        loss = emb.loss_fn(leaves, *b[:3], mask=b[3])
        return loss.detach(), dict(zip(keys, torch.autograd.grad(
            loss, [leaves[k] for k in keys])))

    params = out["params"]
    host = {k: v.to("cpu", copy=True) for k, v in params.items()}
    t0 = time.perf_counter()
    host_loss, host_grads = loss_and_grads(host, tuple(x.cpu() for x in batch))
    cpu_s = time.perf_counter() - t0
    loss, grads = loss_and_grads(params, batch)
    torch.testing.assert_close(loss.cpu(), host_loss, rtol=1e-6, atol=0)
    grad_err, table_err = 0.0, 0.0
    for k in keys:
        got, want = grads[k].cpu(), host_grads[k]
        scale = float(want.abs().max())
        grad_err = max(grad_err, float((got - want).abs().max()) / scale)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
        host_grads[k] = got
    del got, want
    host, _, _ = adamw.apply_updates(host, host_grads,
                                     adamw.init_state(host), opt_cfg)
    del host_grads
    params, opt, _ = adamw.apply_updates(params, grads,
                                         adamw.init_state(params), opt_cfg)
    del grads
    for k in keys:
        got = params[k].cpu()
        table_err = max(table_err, float((got - host[k]).abs().max()))
        torch.testing.assert_close(got, host[k], **TABLE_TOL)
    del host, got
    sgns = emb.make_sgns_step(sg_cfg, opt_cfg)
    losses = [float(loss)]
    for _ in range(EMB_LEARN_STEPS - 1):
        params, opt, aux = sgns(params, opt, batch)
        losses.append(float(aux["loss"]))
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"embeddings: the loss of one batch did not fall "
                             f"at every step: {losses}")
    print(f"embeddings full-width step vs CPU copies: loss {float(loss):.8f} "
          f"here, {float(host_loss):.8f} there; gradients within "
          f"{grad_err:.3g} of the largest; AdamW on the same gradients within "
          f"{table_err:.3g} (the CPU's forward + backward took {cpu_s:.2f} s)"
          f"; one batch's loss over {EMB_LEARN_STEPS} steps: "
          f"{[round(x, 6) for x in losses]}")


def check_embeddings_resume() -> None:
    """Phase 4: a checkpointed run stopped after step 48 (the later
    checkpoints deleted) and resumed equals the uninterrupted run, tables,
    moments and ring; at WG scale EMB_RESUME_SCALE, EMB's other sizes."""
    import shutil
    import tempfile

    import torch

    from repro_torch.graph import make_dataset
    g = make_dataset("WG", weighted=True, with_alias=True,
                     scale_override=EMB_RESUME_SCALE)
    w = embedding_walker()
    spr = EMB["steps_per_round"]
    ref = w.train_embeddings(g, **EMB)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        w.train_embeddings(g, **EMB, ckpt_dir=d, ckpt_every=spr)
        for name in os.listdir(d):
            if int(name.split("_")[1]) > 2 * spr:
                shutil.rmtree(os.path.join(d, name))
        kept = sorted(os.listdir(d))
        res = w.train_embeddings(g, **EMB, ckpt_dir=d, ckpt_every=spr)
    same = (res["step"] == ref["step"]
            and all(torch.equal(res["params"][k], ref["params"][k])
                    and torch.equal(res["opt_state"].mu[k],
                                    ref["opt_state"].mu[k])
                    for k in ref["params"])
            and all(torch.equal(a, b) for a, b in zip(res["ring"],
                                                      ref["ring"])))
    if not same:
        raise AssertionError("embeddings: the resumed run differs")
    print(f"embeddings resume (WG scale {EMB_RESUME_SCALE}, |V|="
          f"{g.num_vertices}): resumed from {kept[-1]} of {kept}, bit-equal "
          "to the uninterrupted run in tables, moments and ring")


def check_embeddings_small_against_cpu() -> None:
    """Phase 4: a small run (WG scale 9, dim 8, DeepWalk fused) on the card
    against the same run on the CPU: every batch bit-equal, the tables
    within the CPU tests' tolerance (TABLE_TOL: the loss's reductions add
    in another order)."""
    import torch

    from repro_torch.graph import make_dataset
    from repro_torch.walker import ExecutionConfig, WalkProgram, compile
    logs, outs = {}, {}
    for dev in ("cpu", "cuda"):
        g = make_dataset("WG", weighted=True, with_alias=True,
                         scale_override=9, device=dev)
        log = logs[dev] = []
        outs[dev] = compile(WalkProgram.deepwalk(10), execution=ExecutionConfig(
            num_slots=64, step_impl="fused")).train_embeddings(
            g, **EMB_SMALL, batch_hook=lambda s, b, log=log: log.append(
                [x.cpu() for x in b]))
    if not all(torch.equal(x, y) for a, b in zip(logs["cpu"], logs["cuda"])
               for x, y in zip(a, b)):
        raise AssertionError("embeddings small: a batch on the card differs "
                             "from the CPU's")
    err = 0.0
    for k in ("in_embed", "out_embed"):
        got, want = outs["cuda"]["params"][k].cpu(), outs["cpu"]["params"][k]
        err = max(err, float((got - want).abs().max()))
        torch.testing.assert_close(got, want, **TABLE_TOL)
    print(f"embeddings small (WG scale 9, dim 8): {len(logs['cpu'])} batches "
          f"bit-equal to the CPU's; tables within {err:.3g} (tolerance "
          f"rtol {TABLE_TOL['rtol']}, atol {TABLE_TOL['atol']})")


# ------------------------------------------------------------------ tuning

TUNE_QUERIES = NUM_STARTS        # the measured tuning's closed batch
TUNE_REPEATS = 3                 # WalkMeasurer: min of 3, interleaved
TUNE_KEEP = 6                    # model-pruned candidates measured
TUNE_PROGRAMS = ("urw", "node2vec_w")
SWEEP_KS = (2, 4, 8, 16, 32, 64)  # hops_per_launch, the tuner's fused grid
SWEEP_PROGRAMS = ("urw", "ppr")
TUNE_CUDA_STARTS = 4_096         # cuda DeepWalk's model-only resolution
TUNE_SMALL_SCALE = 9             # the CPU / card model-only agreement


class RecordingMeasurer:
    """A measurer that records what each call measured (the anchors, then
    the pruned set) and passes it on."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __call__(self, candidates, runners):
        out = self.inner(candidates, runners)
        self.calls.append(dict(out))
        return out


def tune_measured(name, g, cache_path) -> dict:
    """Phase 7 (1): the measured autotune of ``name``, fused, W = 4,096
    default, TUNE_QUERIES starts: prints every measured candidate's
    seconds beside the fitted model's prediction, the fitted coefficients
    and the choice against the default; the choice is never slower."""
    from repro_torch import tune
    from repro_torch.walker import ExecutionConfig
    prog = programs()[name]
    base = ExecutionConfig(num_slots=NUM_SLOTS, record_paths=False,
                           step_impl="fused")
    meas = RecordingMeasurer(tune.WalkMeasurer(repeats=TUNE_REPEATS))
    t0 = time.perf_counter()
    res = tune.autotune(g, prog, base, num_queries=TUNE_QUERIES,
                        measurer=meas, keep=TUNE_KEEP,
                        cache=tune.TuningCache(cache_path))
    secs = time.perf_counter() - t0
    if res.source != "measured" or len(meas.calls) != 2:
        raise AssertionError(f"tune {name}: source {res.source}, "
                             f"{len(meas.calls)} measuring calls")
    sig = tune.graph_signature(g)
    default = tune.default_candidate(prog, base, tune.knobs_for(prog, base))

    def predicted(c):
        return tune.predict_us(*c.apply(prog, base), sig, TUNE_QUERIES,
                               res.coeffs)
    for label, measured in zip(("anchor", "pruned"), meas.calls):
        for c, s in measured.items():
            print(f"tune {name} {label} {c}: measured_s={s:.6f} "
                  f"predicted_s={predicted(c):.6f} "
                  f"walks/s={TUNE_QUERIES / s:.1f}")
    us = res.coeffs.as_array() * 1e6     # fitted on seconds
    print(f"tune {name} fitted coefficients (us): superstep={us[0]:.6g} "
          f"lane={us[1]:.6g} byte={us[2]:.6g} launch={us[3]:.6g}")
    chosen_s, default_s = res.measured[res.candidate], res.measured[default]
    print(f"tune {name}: chosen {res.candidate} {chosen_s:.6f} s "
          f"({TUNE_QUERIES / chosen_s:.1f} walks/s) vs default {default} "
          f"{default_s:.6f} s ({TUNE_QUERIES / default_s:.1f} walks/s); "
          f"{len(res.measured)} candidates measured in {secs:.1f} s; "
          f"key {res.key}")
    if chosen_s > default_s:
        raise AssertionError(f"tune {name}: the choice is slower than the "
                             "default")
    return {"candidate": res.candidate, "measured": res.measured}


def tune_k_sweep(graphs) -> dict:
    """Phase 7 (2): hops_per_launch over SWEEP_KS at W = 4,096 for URW and
    PPR, timed interleaved by the tuner's WalkMeasurer (min of 3).
    Returns program -> {candidate: seconds}."""
    import torch

    from repro_torch import tune
    from repro_torch.walker import ExecutionConfig, compile
    out = {}
    for name in SWEEP_PROGRAMS:
        g, prog = graphs[name], programs()[name]
        starts = (torch.arange(TUNE_QUERIES, device=g.device)
                  % g.num_vertices).to(torch.int32)
        runners, last = {}, {}
        for k in SWEEP_KS:
            cand = tune.Candidate.of(hops_per_launch=k)
            w = compile(prog, execution=ExecutionConfig(
                num_slots=NUM_SLOTS, record_paths=False, step_impl="fused",
                hops_per_launch=k))

            def run(w=w, cand=cand):
                last[cand] = w.run(g, starts, seed=0)
                torch.cuda.synchronize()
            runners[cand] = run
        best = tune.WalkMeasurer(repeats=TUNE_REPEATS)(list(runners),
                                                       runners)
        for cand, s in best.items():
            st = last[cand].stats
            print(f"k sweep {name} hops_per_launch="
                  f"{cand.get('hops_per_launch')}: walks/s="
                  f"{TUNE_QUERIES / s:.1f} s={s:.6f} "
                  f"launches={int(st.launches)} "
                  f"supersteps={int(st.supersteps)}")
        if len({int(r.stats.steps) for r in last.values()}) != 1:
            raise AssertionError(f"k sweep {name}: steps differ with k")
        win = min(best, key=best.get)
        print(f"k sweep {name}: fastest hops_per_launch="
              f"{win.get('hops_per_launch')}")
        out[name] = best
    return out


def tune_card_coeffs(g, measured) -> None:
    """Phase 7 (2b): the cost model fitted (``tune.fit``, least squares)
    over every URW run phase 7 timed — the autotune's candidates and the
    k sweep — the card's coefficients that ``tune.model.DEFAULT_COEFFS``
    carries.  Prints them in microseconds and each run's measured and
    predicted seconds."""
    from repro_torch import tune
    from repro_torch.walker import ExecutionConfig
    prog = programs()["urw"]
    base = ExecutionConfig(num_slots=NUM_SLOTS, record_paths=False,
                           step_impl="fused")
    sig = tune.graph_signature(g)
    rows = {c: tune.model.features(*c.apply(prog, base), sig, TUNE_QUERIES)
            for c in measured}
    coeffs = tune.fit(list(rows.values()), list(measured.values()))
    for c, s in measured.items():
        print(f"card fit urw {c}: measured_s={s:.6f} predicted_s="
              f"{float(rows[c] @ coeffs.as_array()):.6f}")
    us = coeffs.as_array() * 1e6
    print(f"card coefficients (us; urw fused, fit over {len(measured)} "
          f"runs): superstep={us[0]:.6g} lane={us[1]:.6g} byte={us[2]:.6g} "
          f"launch={us[3]:.6g}")


def tune_resolve_cached(name, g, starts_np, cache_path, chosen) -> None:
    """Phase 7 (3): every knob "auto", resolved from the written cache,
    must give the chosen candidate; the run equals the default config's
    in paths and lengths and a fixed run of the chosen config in every
    stat but launches.  Weighted Node2Vec's adaptive_chunks="auto" takes
    the cached choice; without a cache entry it takes the skew gate; paths
    are the same either way."""
    import torch

    from repro_torch import tune
    from repro_torch.walker import ExecutionConfig, compile
    prog = programs()[name]
    starts = torch.from_numpy(starts_np).to(g.device)
    auto = dict(num_slots="auto", queue_depth_factor="auto",
                hops_per_launch="auto", cache_budget="auto",
                step_impl="fused")
    w = compile(prog, execution=ExecutionConfig(tune_cache=cache_path,
                                                **auto))
    got = w.run(g, starts, seed=0)
    (rprog, rex), = w._resolved.values()
    knobs = chosen["candidate"].to_dict()
    resolved = {k: getattr(rex, k) for k in tune.space.EXEC_KNOBS}
    if any(resolved[k] != knobs[k] for k in resolved):
        raise AssertionError(f"resolve {name}: {resolved}, tuned {knobs}")
    dw = compile(prog, execution=ExecutionConfig(num_slots=NUM_SLOTS,
                                                 step_impl="fused"))
    default = dw.run(g, starts, seed=0)
    fixed = compile(rprog, execution=ExecutionConfig(
        step_impl="fused", **resolved)).run(g, starts, seed=0)
    check_paths(g, starts, got, max_hops=prog.max_hops)
    if not (torch.equal(got.paths, default.paths)
            and torch.equal(got.lengths, default.lengths)
            and same_walks(got, fixed)):
        raise AssertionError(f"resolve {name}: the resolved run differs")
    line = (f"resolve {name} from the cache: {resolved} == the tuned "
            f"choice; paths and lengths == default (W = {NUM_SLOTS}, k = "
            f"{HOPS_PER_LAUNCH}), every stat but launches == the fixed "
            f"config (launches {int(got.stats.launches)} vs default "
            f"{int(default.stats.launches)})")
    if prog.spec.kind == "reservoir_n2v":
        sig = tune.graph_signature(g)
        if rprog.spec.adaptive_chunks != knobs["adaptive_chunks"]:
            raise AssertionError(f"resolve {name}: adaptive_chunks "
                                 f"{rprog.spec.adaptive_chunks}, cached "
                                 f"{knobs['adaptive_chunks']}")
        # The default config has no entry (no tune_cache): the gate.
        (dprog, _), = dw._resolved.values()
        gate = tune.adaptive_chunk_gate(sig, NUM_SLOTS,
                                        prog.spec.reservoir_chunk)
        if dprog.spec.adaptive_chunks != gate:
            raise AssertionError(f"resolve {name}: no-entry resolution "
                                 f"{dprog.spec.adaptive_chunks}, gate {gate}")
        line += (f"; adaptive_chunks: cached {knobs['adaptive_chunks']}, "
                 f"with no entry the gate's {gate} (live max degree "
                 f"{tune.live_max_degree(sig, NUM_SLOTS)} of "
                 f"{sig.max_degree}); the same walks either way")
    print(line)


def tune_resolve_cuda(g, starts_np) -> None:
    """Phase 7 (4): cuda DeepWalk on TUNE_CUDA_STARTS starts with
    num_slots="auto" and no cache entry (the model's argmin) equals the
    fixed W = 4,096 run in paths and lengths."""
    import torch

    from repro_torch.walker import ExecutionConfig, compile
    prog = programs()["deepwalk"]
    starts = torch.from_numpy(starts_np[:TUNE_CUDA_STARTS]).to(g.device)
    w = compile(prog, execution=ExecutionConfig(num_slots="auto",
                                                step_impl="cuda"))
    t0 = time.perf_counter()
    got = w.run(g, starts, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (_, rex), = w._resolved.values()
    want = compile(prog, execution=ExecutionConfig(
        num_slots=NUM_SLOTS, step_impl="cuda")).run(g, starts, seed=0)
    check_paths(g, starts, got, max_hops=prog.max_hops)
    if not (torch.equal(got.paths, want.paths)
            and torch.equal(got.lengths, want.lengths)):
        raise AssertionError("resolve deepwalk/cuda: the run differs")
    print(f"resolve deepwalk cuda (model): num_slots={rex.num_slots}, "
          f"{int(got.stats.supersteps)} supersteps in {wall:.3f} s; paths "
          f"and lengths == W = {NUM_SLOTS}")


def tune_cpu_vs_card() -> None:
    """Phase 7 (5): model-only autotune on a CPU and a card copy of WG
    scale TUNE_SMALL_SCALE choose the same candidate under keys that
    differ only in the device field."""
    from repro_torch import tune
    from repro_torch.graph import make_dataset
    from repro_torch.walker import ExecutionConfig
    for name in ("urw", "node2vec_w"):
        prog = programs()[name]
        out = {}
        for dev in ("cpu", "cuda"):
            g = make_dataset("WG", weighted=True, with_alias=True,
                             scale_override=TUNE_SMALL_SCALE, device=dev)
            out[dev] = tune.autotune(
                g, prog, ExecutionConfig(record_paths=False,
                                         step_impl="fused"),
                num_queries=TUNE_QUERIES, measurer=None,
                cache=tune.TuningCache(None))
        a, b = out["cpu"].key.split("|"), out["cuda"].key.split("|")
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if (out["cpu"].candidate != out["cuda"].candidate or len(a) != len(b)
                or diff != [3] or a[3] != "cpu"):
            raise AssertionError(f"model-only {name}: cpu {out['cpu'].key} "
                                 f"{out['cpu'].candidate}, card "
                                 f"{out['cuda'].key} {out['cuda'].candidate}")
        print(f"model-only {name} WG {TUNE_SMALL_SCALE}: cpu == card "
              f"{out['cpu'].candidate}; device fields {a[3]!r}, {b[3]!r}")


def run_tune(graphs, starts_np) -> dict:
    """Phase 7, the autotuner (``repro_torch.tune``) on the main path's
    graph: measured autotune of fused URW and weighted Node2Vec into a
    cache file, the hops_per_launch sweep, resolution of "auto" from that
    file, cuda DeepWalk's model-only resolution and the CPU / card
    agreement.  The launch counts are zeroed before and read after;
    returns them."""
    import tempfile
    reset_all_launches()
    with tempfile.TemporaryDirectory() as tmp:
        cache_path = os.path.join(tmp, "tune_cache.json")
        chosen = {}
        for name in TUNE_PROGRAMS:
            t = time.perf_counter()
            chosen[name] = tune_measured(name, graphs[name], cache_path)
            print(f"  tune {name} time {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        sweep = tune_k_sweep(graphs)
        tune_card_coeffs(graphs["urw"], {**chosen["urw"]["measured"],
                                         **sweep["urw"]})
        print(f"  k sweep time {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        for name in TUNE_PROGRAMS:
            tune_resolve_cached(name, graphs[name], starts_np, cache_path,
                                chosen[name])
        print(f"  resolve time {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tune_resolve_cuda(graphs["deepwalk"], starts_np)
    tune_cpu_vs_card()
    print(f"  model-only time {time.perf_counter() - t:.1f} s")
    return embedding_launches()


# ---------------------------------------------------------- sharded backend

SHARD_N = 4                      # the main path's shards: 4 x 1,024 = W
SHARD_WIDE = 16                  # the paper's 16 pipelines: 16 x 256 = W
SHARD_WIDE_PROGRAMS = ("urw",)
# A shard's emission log holds every record of the batch (65,536 x 80).
SHARD_LOG = NUM_STARTS * MAX_HOPS
# Weighted Node2Vec's chunk ping-pong takes up to 2 x 290 + 1 supersteps a
# hop at the hubs, each a plain superstep over every shard's pool: its
# sharded run is cut in depth to phase 3's torch cut's 1,024 starts and
# to one hop (at 2 hops a walk that reached the hub scans its 290 chunks:
# 582 supersteps, 27 s on an H100 host); its width stays 4 x 1,024.  The
# other programs' sharded batches are cut in depth to their first
# SHARD_STARTS starts (the whole script ran 1,250.7 s of its 1,200 s limit
# on an H100 with all 65,536).
SHARD_CUT = {"node2vec_w": (N2V_TORCH_STARTS, 1)}
SHARD_STREAM_CAPACITY = 8_192    # URW, fed 3 x capacity arrivals
SHARD_SERVE_CAPACITY = 8_192
SHARD_SERVE_REQUESTS = 256       # 64-walk Poisson requests at rho 0.9
SHARD_EMB = {**EMB, "rounds": 2, "walks_per_round": 8_192,
             "steps_per_round": 8}
SHARD_STARTS = 4_096             # the closed batches' depth cut (a pool)
SHARD_PROFILE_STARTS = NUM_SLOTS  # the profiled drain: one pool's worth
# The shards in groups (a mesh naming cuda:0 G times): URW and weighted
# Node2Vec at 4 x 1,024 lanes in 2 and 4 groups, each equal to one group
# and to the single backend.  A group is issued its own phases, so a
# superstep's launches grow about G-fold on a host-bound superstep: the
# URW runs are cut in depth to SHARD_GROUP_HOPS hops (G = 4 at 80 hops
# would take ~10 s a run), weighted Node2Vec keeps SHARD_CUT.
SHARD_GROUPS = (2, 4)
SHARD_GROUP_PROGRAMS = ("urw", "node2vec_w")
SHARD_GROUP_HOPS = 16
RATES = {}   # (program, impl) -> walks/s of phase 3's last run of it


def sharded_walker(prog, n_shards=SHARD_N, mesh=None):
    from repro_torch.walker import ExecutionConfig, compile
    return compile(prog, backend="sharded", mesh=mesh,
                   execution=ExecutionConfig(
                       num_slots=NUM_SLOTS, num_devices=n_shards,
                       log_capacity=SHARD_LOG))


def group_mesh(devices):
    """The main path's 4 shards in ``len(devices)`` groups, group g on
    ``devices[g]``."""
    from repro_torch.distributed import Mesh
    return Mesh(SHARD_N, devices)


def on_card0(groups):
    import torch
    return [torch.device("cuda", 0)] * groups


def fused_walker(prog):
    from repro_torch.walker import ExecutionConfig, compile
    return compile(prog, execution=ExecutionConfig(
        num_slots=NUM_SLOTS, step_impl="fused",
        hops_per_launch=HOPS_PER_LAUNCH))


SHARD_WARMUP = 8                 # starts of each timed run's warm-up


def timed_run(w, g, starts, warm=True) -> tuple:
    """A warm-up on a few starts (unless ``warm`` is False), then
    ``w.run`` timed with the launch counts zeroed just before it and read
    just after: (result, wall seconds, launches)."""
    import torch
    if warm:
        w.run(g, starts[:SHARD_WARMUP], seed=0)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    res = w.run(g, starts, seed=0)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, embedding_launches()


def shard_line(st) -> str:
    """Supersteps, route waits and bubble ratio of each shard."""
    ratio = (st.bubbles.double() / st.slot_steps.clamp(min=1)).tolist()
    return (f"per shard: supersteps={st.supersteps.tolist()} "
            f"route_waits={st.route_waits.tolist()} "
            f"bubble_ratio={[round(x, 6) for x in ratio]}")


def sharded_closed(name, prog, g, starts, n_shards, card, add) -> None:
    """One sharded closed batch through ``Walker.run`` against the single
    backend's fused run of the same batch: paths and lengths equal, no
    drop, every hop an edge, no kernel launched by the sharded run (its
    superstep is plain torch).  Prints walks/s and MSteps/s beside the
    single backend's (this batch fused; phase 3's torch and fused)."""
    import torch

    from repro_torch.core.scheduler import analyze_run
    single, single_wall, launched = timed_run(fused_walker(prog), g, starts)
    add(launched)
    w = sharded_walker(prog, n_shards)
    # Weighted Node2Vec's cut batch is one superstep after a hop-0 scan
    # whose chunks follow the hubs among its starts: a warm-up on a few
    # starts costs as much as the run, and phases 3 and 8 have warmed the
    # allocator and the engine's code.
    res, wall, launched = timed_run(w, g, starts, warm=name not in SHARD_CUT)
    label = f"sharded {name} N={n_shards}x{NUM_SLOTS // n_shards}"
    if any(launched.values()):
        raise AssertionError(f"{label}: kernel launches {launched}")
    if int(res.stats.drops) != 0:
        raise AssertionError(f"{label}: {int(res.stats.drops)} drops")
    if not (torch.equal(res.paths, single.paths)
            and torch.equal(res.lengths, single.lengths)):
        raise AssertionError(f"{label}: walks differ from the single "
                             "backend's")
    check_paths(g, starts, res,
                prog.spec.metapath if name == "metapath" else None,
                max_hops=prog.max_hops)
    a = analyze_run(res.stats, wall)
    n = int(starts.shape[0])
    # Phase 3's runs: node2vec_w's torch run has its cut; the others ran
    # all NUM_STARTS starts.
    impls = ("torch",) if name in SHARD_CUT else ("torch", "fused")
    phase3 = " ".join(
        f"phase 3 {impl} {RATES[name, impl]:.1f}" for impl in impls
        if (name, impl) in RATES)
    if phase3 and name not in SHARD_CUT:
        phase3 += f" (at {NUM_STARTS} starts)"
    print(f"{label} starts={n} hops={prog.max_hops}: walks/s={n / wall:.1f} "
          f"MSteps/s={a.msteps_per_s:.6f} supersteps={a.supersteps} "
          f"steps={a.steps} route_waits={a.route_waits} drops={a.drops} "
          f"bubble_ratio={a.bubble_ratio:.6f} "
          f"wall_ms_per_superstep={wall / a.supersteps * 1e3:.4f} "
          f"wall_s={wall:.4f}; {shard_line(w.last_shard_stats)}; single "
          f"backend: this batch fused walks/s {n / single_wall:.1f} "
          f"supersteps {int(single.stats.supersteps)}"
          f"{'; ' + phase3 if phase3 else ''}; paths, lengths == the single "
          f"backend's | {card}")
    return res


def same_result(a, b) -> bool:
    """Paths, lengths and every folded stat equal."""
    import torch
    return (torch.equal(a.paths, b.paths) and torch.equal(a.lengths, b.lengths)
            and [int(x) for x in a.stats] == [int(x) for x in b.stats])


def across_cards() -> list:
    """(label, devices) of the 4 shards in 2 and 4 groups, one group a
    card, for as many groups as the machine has cards."""
    import torch
    return [(f"G={G} one a card", [torch.device("cuda", i)
                                   for i in range(G)])
            for G in SHARD_GROUPS if G <= torch.cuda.device_count()]


def sharded_grouped(name, prog, g, starts, base, single, card, runs,
                    profile=False) -> None:
    """A closed batch with the 4 shards in each ``runs`` entry's groups
    (label, devices), after one group on cuda:0 when ``base`` is None:
    paths, lengths and every stat equal to ``base`` (one group's run of
    the batch; None: that first run), paths and lengths to ``single`` (the
    single backend's fused run), no kernel launched.  The graph is
    partitioned onto the mesh before the timed run.  With ``profile``, a
    traced drain of each run on cuda:0 (device busy share and launches a
    superstep).  Weighted Node2Vec's runs take no warm-up (see
    :func:`sharded_closed`)."""
    import torch

    from repro_torch.graph import partition_graph
    if base is None:
        runs = [("G=1 on cuda:0", on_card0(1))] + runs
    for label, devices in runs:
        mesh = group_mesh(devices)
        pg = partition_graph(g, SHARD_N, mesh)
        w = sharded_walker(prog, mesh=mesh)
        full = (f"sharded {name} N={SHARD_N}x{NUM_SLOTS // SHARD_N} {label} "
                f"starts={int(starts.shape[0])} hops={prog.max_hops}")
        traced = profile and "cuda:0" in label
        if traced:   # the traced drain also warms the timed run
            profile_sharded(w, pg, starts, full)
        res, wall, launched = timed_run(
            w, pg, starts, warm=not traced and name not in SHARD_CUT)
        if any(launched.values()) or int(res.stats.drops):
            raise AssertionError(f"{full}: launches {launched}, drops "
                                 f"{int(res.stats.drops)}")
        base = res if base is None else base
        if not (same_result(res, base) and torch.equal(res.paths, single.paths)
                and torch.equal(res.lengths, single.lengths)):
            raise AssertionError(f"{full}: differs from one group on one "
                                 "card or from the single backend")
        sup = int(res.stats.supersteps)
        print(f"{full}: walks/s={int(starts.shape[0]) / wall:.1f} "
              f"supersteps={sup} wall_ms_per_superstep="
              f"{wall / sup * 1e3:.4f} wall_s={wall:.4f}; paths, lengths, "
              f"stats == one group's and the single backend's | {card}")


def sharded_groups(graphs, starts_np, bases, card, add,
                   across_only=False) -> None:
    """Phase 8's shard groups: URW (cut to SHARD_GROUP_HOPS, its one-group
    run made here) and weighted Node2Vec (SHARD_CUT, against ``bases``,
    the one-group runs above, or its own) in 2 and 4 groups on cuda:0 and
    one group a card where the machine has the cards (only these with
    ``across_only``)."""
    import torch
    runs = [] if across_only else [(f"G={G} on cuda:0", on_card0(G))
                                   for G in SHARD_GROUPS]
    runs += across_cards()
    for name in SHARD_GROUP_PROGRAMS:
        g = graphs[name]
        n, hops = SHARD_CUT.get(name, (SHARD_STARTS, SHARD_GROUP_HOPS))
        prog = dataclasses.replace(programs()[name], max_hops=hops)
        starts = torch.from_numpy(starts_np[:n]).to(g.device)
        with timed(f"sharded {name} groups"):
            single, _, launched = timed_run(fused_walker(prog), g, starts)
            add(launched)
            sharded_grouped(name, prog, g, starts, bases.get(name), single,
                            card, runs, profile=name not in SHARD_CUT)
    if torch.cuda.device_count() < 2:
        print(f"sharded across cards: not run: this machine has "
              f"{torch.cuda.device_count()} card (torch.cuda.device_count())"
              ", so every group ran on cuda:0 (on 2 or more cards: python3 "
              "chip_smoke.py --across-cards)")


def sharded_stream(g, card, add, mesh=None, base=None) -> dict:
    """A sharded URW stream (4 x 1,024 lanes, capacity 8,192) fed 3 x
    capacity arrivals by :func:`soak`: every (epoch, qid) equals its
    closed batch (the single backend, fused), the ring wrapped, no drop,
    no kernel launched by the stream.  Given ``mesh`` and ``base`` (the
    one-group stream's harvest), the stream in the mesh's groups, cut in
    depth to the first capacity of arrivals (one epoch), each equal to
    ``base``'s row of the same (epoch, qid)."""
    prog = programs()["urw"]
    stream = sharded_walker(prog, mesh=mesh).stream(
        g, capacity=SHARD_STREAM_CAPACITY, seed=STREAM_SEED)
    arrivals = stream_starts(g, SHARD_STREAM_CAPACITY)
    if base is not None:
        arrivals = arrivals[:SHARD_STREAM_CAPACITY]
    reset_all_launches()
    h = soak(stream, arrivals)
    launched = embedding_launches()
    st = stream.walk_stats()
    label = (f"sharded stream urw N={SHARD_N} "
             f"G={len(mesh.devices) if mesh else 1} "
             f"capacity={SHARD_STREAM_CAPACITY}")
    if any(launched.values()) or st.drops:
        raise AssertionError(f"{label}: launches {launched}, drops "
                             f"{st.drops}")
    if base is None:
        if len(set(h["epochs"].tolist())) < 3:
            raise AssertionError(f"{label}: the ring did not wrap twice")
        reset_all_launches()
        check_against_closed("urw", "fused", g, h, SHARD_STREAM_CAPACITY)
        add(embedding_launches())
    elif not same_harvest(h, harvest_rows(base, base["epochs"] == 0)):
        raise AssertionError(f"{label}: differs from the one-group stream")
    walks = h["epochs"].size
    split = {k: round(v * 1e3, 3) for k, v in h["split"].items()}
    print(f"{label}: {walks} walks, walks/s={walks / h['wall']:.1f} "
          f"supersteps={st.supersteps} route_waits={st.route_waits} "
          f"bubble_ratio={st.bubbles / max(st.slot_steps, 1):.6f} "
          f"host_read_share={stream.host_read_s / h['wall']:.4f} "
          f"wall_s={h['wall']:.4f} wall_split_ms={split} "
          f"epochs={sorted(set(h['epochs'].tolist()))}; every (epoch, qid) "
          f"equals {'the one-group stream' if base else 'its closed batch'} "
          f"| {card}")
    return h


def sharded_service(g, card, add) -> None:
    """One Poisson point (rho 0.9, 64-walk requests) of a WalkService over
    the sharded URW stream: :func:`serve_point`'s checks, no kernel
    launched, each request equal to its closed batch."""
    from repro_torch.serve import OpenLoad
    svc = sharded_walker(programs()["urw"]).serve(
        g, capacity=SHARD_SERVE_CAPACITY, chunk=SERVE_CHUNK, seed=SERVE_SEED)
    out = serve_point(svc, "urw", f"sharded N={SHARD_N}", OpenLoad(
        num_requests=SHARD_SERVE_REQUESTS, request_size=SERVE_REQUEST,
        utilization=0.9), instrument_service(svc), card, graph=g)
    if out["stats"].drops:
        raise AssertionError("sharded service: drops")
    reset_all_launches()
    check_against_closed("urw", "fused", g, out["harvest"],
                         SHARD_SERVE_CAPACITY, seed=out["seed"])
    add(embedding_launches())
    print(f"sharded service urw: every request equals its closed batch "
          f"under stream_key({out['seed']}, epoch)")


# Split training's groups (phase 8): the tables and moments in row blocks
# over 2 and 4 groups on cuda:0, each run bit-equal to one group.
SHARD_EMB_GROUPS = (2, 4)


@contextlib.contextmanager
def sgns_grad_norms():
    """Each SGNS step's ``grad_norm`` as the device scalar the step made
    (``"norms"``), and the clipping bound of each AdamW config a step was
    built with (``"grad_clip"``), kept in the yielded dict by a wrapper
    the script puts around ``embeddings.make_sgns_step`` (no host read
    while the run is timed)."""
    from repro_torch.models import embeddings as emb
    seen, real = {"norms": [], "grad_clip": []}, emb.make_sgns_step

    def make(cfg, opt_cfg):
        step = real(cfg, opt_cfg)
        seen["grad_clip"].append(opt_cfg.grad_clip)

        def wrapped(params, opt_state, batch):
            params, opt_state, aux = step(params, opt_state, batch)
            seen["norms"].append(aux["grad_norm"])
            return params, opt_state, aux
        return wrapped
    emb.make_sgns_step = make
    try:
        yield seen
    finally:
        emb.make_sgns_step = real


def reached_groups(batches, table) -> int:
    """The launches of each gather kernel over ``batches`` (each step's
    centers, contexts and negatives) in a run whose tables came out as
    ``table``: one a gather for a tensor, and for row blocks one a gather
    for each slab that ``RowBlocks.owner`` gives one of its ids
    (models.layers._SplitGather)."""
    import torch

    from repro_torch.distributed.row_blocks import RowBlocks
    if not isinstance(table, RowBlocks):
        return sum(len(batch) for batch in batches)
    return sum(int(torch.unique(table.owner(ids.reshape(-1))).numel())
               for batch in batches for ids in batch)


def sharded_embeddings(g, card, add, groups=None, one=None) -> None:
    """``train_embeddings`` at phase 4's width (DeepWalk, dim 128, batch
    4,096, 8,192 walks a round, so the 4 x 1,024 pool fills; 2 rounds of
    8 steps) on the single backend (fused), the sharded backend (its
    producer a sharded stream) overlapped and serial, with their walls
    (:func:`print_overlap`), and the sharded backend with its tables and
    moments in row blocks over each of ``groups`` (lists of devices, one
    a group; by default 2 and 4 groups on cuda:0; the one-group runs on
    the mesh ``one``, if given): rings, tables and moments equal, each
    slab checked on its group's device against the one-group run's rows;
    no step clipped at the ``grad_clip`` of the config the run built
    (each step's grad_norm kept on the device, read after the run); the
    gathers launch one embedding-bag and one segment-sum kernel for each
    group a gather's ids reach (3 a step in one group) and nothing else.
    Prints each run's wall and each device's peak memory above the run's
    start beside the table-sized buffers' share of a group.  A grouped
    run's peak may not pass, on one card, the one-group run's by half a
    table; one group a card, the one-group run's over G by half a table
    on any card (a step that joined a table's slabs on one card would).
    On one card every slab shares the device, so there the peak bounds
    only joins larger than half a table."""
    import torch

    from repro_torch.distributed.row_blocks import RowBlocks
    prog = programs()["deepwalk"]
    steps = SHARD_EMB["rounds"] * SHARD_EMB["steps_per_round"]
    nv, dim = g.num_vertices, SHARD_EMB["dim"]
    table_bytes = nv * dim * 4
    outs, walls = {}, {}
    groups = groups or [on_card0(G) for G in SHARD_EMB_GROUPS]
    serial = "sharded serial"
    runs = [("single", fused_walker(prog), None),
            ("sharded", sharded_walker(prog, mesh=one), None),
            (serial, sharded_walker(prog, mesh=one), None)]
    for devs in groups:
        runs.append((f"sharded G={len(devs)} on "
                     f"{' and '.join(dict.fromkeys(str(d) for d in devs))}",
                     sharded_walker(prog, mesh=group_mesh(devs)), devs))
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    peaks = {}
    for label, w, devs in runs:
        G = len(devs) if devs else 1
        reset_all_launches()
        torch.cuda.synchronize()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        held = {str(d): torch.cuda.memory_allocated(d) for d in cards}
        overlap = label != serial
        batches = []
        t0 = time.perf_counter()
        with phase_limit(), pipeline_clock() as rec, \
                sgns_grad_norms() as seen:
            outs[label] = w.train_embeddings(
                g, **SHARD_EMB, overlap=overlap,
                batch_hook=lambda step, batch: batches.append(batch[:3]))
        for d in cards:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        walls[label] = wall, pipeline_walls(rec, overlap)
        launched = embedding_launches()
        add(launched)
        check_embedding_launches(label, launched, reached_groups(
            batches, outs[label]["params"]["in_embed"]))
        norms, clip = seen["norms"], min(seen["grad_clip"])
        top = float(torch.stack(norms).max())
        if len(norms) != steps or not top < clip:
            raise AssertionError(f"sharded embeddings {label}: {len(norms)} "
                                 f"steps, largest grad_norm {top} (a step "
                                 f"that clips at grad_clip {clip} breaks "
                                 "the bit-equality to the single backend)")
        # The run's own peak: above what the earlier runs' results held.
        peaks[label] = {str(d): torch.cuda.max_memory_allocated(d)
                        - held[str(d)] for d in cards}
        walks = SHARD_EMB["rounds"] * SHARD_EMB["walks_per_round"]
        print(f"sharded embeddings {label}: {walks} walks and {steps} steps "
              f"in {wall:.3f} s; kernel launches {launched}; largest "
              f"grad_norm {top:.6f}; peak memory above the run's start "
              + ", ".join(f"{d} {b / 2**30:.3f} GiB"
                          for d, b in peaks[label].items())
              + " (tables, moments and gradients "
              f"{8 * table_bytes / 2**30:.3f} GiB, "
              f"{8 * table_bytes / G / 2**30:.3f} GiB a group) | {card}")
        # On one device its peak stays within half a table of one group's;
        # one group a card, each card's within half a table of one group's
        # over G (one group's card holds every slab), which a step that
        # joined a table's slabs on one card would pass.
        base = peaks.get("sharded", {})
        if len(set(map(str, devs or ()))) == 1:
            limit = {d: b + table_bytes // 2 for d, b in base.items()}
        else:
            limit = dict.fromkeys(base, max(base.values(), default=0) // G
                                  + table_bytes // 2)
        if devs and any(b > limit[d] for d, b in peaks[label].items()):
            raise AssertionError(
                f"sharded embeddings {label}: peaks {peaks[label]} against "
                f"one group's {base} (a step joined slabs?)")
    print_overlap("sharded embeddings", walls, ["sharded", serial], serial,
                  card)
    b = outs["sharded"]

    def tree(out, t):
        return out["params"] if t == "params" else getattr(out["opt_state"],
                                                           t)
    for label in ("single", serial):
        a = outs[label]
        if not (all(torch.equal(x, y) for x, y in zip(a["ring"], b["ring"]))
                and all(torch.equal(tree(a, t)[k], tree(b, t)[k])
                        for k in b["params"] for t in ("params", "mu", "nu"))):
            raise AssertionError(f"sharded embeddings differ from the "
                                 f"{label} run's")
    for label, _, devs in runs[3:]:
        c = outs[label]
        G = len(devs)
        rows = nv // G
        # The ring whole on the first group's device; each table's and
        # moment's slab g on group g's device, equal to one group's rows.
        ok = all(x.device == devs[0] and torch.equal(x, y)
                 for x, y in zip(c["ring"], b["ring"]))
        ok = ok and c["step"] == b["step"] and torch.equal(
            c["opt_state"].step, b["opt_state"].step.to(devs[0]))
        for k in b["params"]:
            for t in ("params", "mu", "nu"):
                x = tree(c, t)[k]
                ok = ok and isinstance(x, RowBlocks) and len(x.slabs) == G
                ok = ok and all(
                    s.device == d and s.shape[0] == rows and torch.equal(
                        s, tree(b, t)[k][i * rows:(i + 1) * rows].to(d))
                    for i, (s, d) in enumerate(zip(x.slabs, devs)))
        if not ok:
            raise AssertionError(f"sharded embeddings {label} differ from "
                                 "one group's")
    print("sharded embeddings: ring, tables and moments == the single "
          "backend's == the serial run's; in "
          + " and ".join(str(len(d)) for d in groups)
          + " groups each slab on its group's device == one group's rows")


def check_embedding_launches(label, launched, gathers) -> None:
    """``gathers`` embedding-bag and as many segment-sum launches (3 a step
    in one group), fused launches for the single backend's producer and
    none for the sharded one's."""
    want = {k: 0 for k in launched}
    want.update(embedding_bag=gathers, segment_sum=gathers)
    # (the sharded producers, in one group or more, launch no kernel)
    if label == "single" and launched["fused_superstep"] > 0:
        want["fused_superstep"] = launched["fused_superstep"]
    if launched != want:
        raise AssertionError(f"embeddings {label}: launches {launched}, "
                             f"expected {want}")


def sharded_profile(g) -> None:
    """Device busy share of one sharded drain (URW, 4 x 1,024, one pool's
    worth of starts) from ``torch.profiler``: busy time over wall, device
    launches a superstep, the top kernels."""
    import torch
    w = sharded_walker(programs()["urw"])
    starts = torch.from_numpy(np.random.default_rng(1).integers(
        0, g.num_vertices, SHARD_PROFILE_STARTS).astype(np.int32)).to(
        g.device)
    w.run(g, starts[:NUM_SLOTS // 4], seed=0)
    profile_sharded(w, g, starts, f"sharded urw N={SHARD_N} "
                    f"starts={SHARD_PROFILE_STARTS}")


def profile_sharded(w, g, starts, label) -> None:
    """``torch.profiler`` over one drain of ``w`` (warmed by the caller):
    busy time over wall, device launches a superstep, the top kernels."""
    import torch
    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.perf_counter()
        res = w.run(g, starts, seed=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    supersteps = int(res.stats.supersteps)
    if busy_ms == 0:
        print(f"profile {label}: device time not measured (the profiler "
              "recorded no device activity)")
        return
    top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{n}"
                    for us, n, k in rows[:5])
    print(f"profile {label}: "
          f"supersteps={supersteps} wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} "
          f"device_busy_share={busy_ms / wall_ms:.4f} "
          f"device_launches_per_superstep="
          f"{sum(r[1] for r in rows) / supersteps:.2f} "
          f"wall_ms_per_superstep={wall_ms / supersteps:.4f} top: {top}")


def run_sharded(graphs, starts_np) -> dict:
    """Phase 8, the sharded backend (``compile(program,
    backend="sharded")``, N shards stacked on the card) on the main path's
    graphs; returns each kernel's launches summed over the phase's runs
    (the single backend's comparison runs and the training steps: the
    sharded superstep launches none)."""
    import torch
    totals = {k: 0 for k in embedding_launches()}
    card = card_line()

    def add(launched):
        for k, n in launched.items():
            totals[k] += n
    bases = {}
    for name, prog in programs().items():
        g = graphs[name]
        n, hops = SHARD_CUT.get(name, (SHARD_STARTS, prog.max_hops))
        prog = dataclasses.replace(prog, max_hops=hops)
        starts = torch.from_numpy(starts_np[:n]).to(g.device)
        print(f"sharded {name}: cut in depth to {n} starts and {hops} "
              f"hops (width {SHARD_N} x {NUM_SLOTS // SHARD_N} kept)")
        t = time.perf_counter()
        res = sharded_closed(name, prog, g, starts, SHARD_N, card, add)
        if name in SHARD_CUT:
            bases[name] = res
        if name in SHARD_WIDE_PROGRAMS:
            sharded_closed(name, prog, g, starts, SHARD_WIDE, card, add)
        print(f"  sharded {name} time {time.perf_counter() - t:.1f} s")
    sharded_groups(graphs, starts_np, bases, card, add)
    with timed("sharded stream"):
        h = sharded_stream(graphs["urw"], card, add)
    with timed("sharded stream G=2"):
        sharded_stream(graphs["urw"], card, add,
                       mesh=group_mesh(on_card0(2)), base=h)
    with timed("sharded service"):
        sharded_service(graphs["urw"], card, add)
    with timed("sharded embeddings"):
        sharded_embeddings(graphs["deepwalk"], card, add)
    with timed("sharded profile"):
        sharded_profile(graphs["urw"])
    return totals


def run_across_cards() -> int:
    """``python3 chip_smoke.py --across-cards`` on a machine with 2 or
    more cards: phase 8's grouped runs with one group a card (closed URW
    and weighted Node2Vec batches in 2 and 4 groups, the URW stream in 2,
    split training in 2 and 4), each against one group on cuda:0 and the
    single backend, with every card's name and power limit."""
    import torch

    from repro_torch.graph import make_dataset
    from repro_torch.kernels import build
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"--across-cards needs 2 or more cards; this machine has "
              f"{cards}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.build(["fused_superstep", "embedding_bag", "segment_sum"])
    g = make_dataset("WG", weighted=True, with_alias=True,
                     scale_override=WG_SCALE)
    print(f"build and graph: {time.perf_counter() - t0:.1f} s; {cards} "
          f"cards")
    card = card_line().replace("\n", "; ")
    print(card)
    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, NUM_STARTS).astype(np.int32)
    totals = {k: 0 for k in embedding_launches()}

    def add(launched):
        for k, n in launched.items():
            totals[k] += n
    graphs = {name: g for name in SHARD_GROUP_PROGRAMS}
    sharded_groups(graphs, starts, {}, card, add, across_only=True)
    one, two = group_mesh(on_card0(1)), across_cards()[0][1]
    with timed("sharded stream one a card"):
        h = sharded_stream(g, card, add, mesh=one)
        sharded_stream(g, card, add, base=h, mesh=group_mesh(two))
    with timed("sharded embeddings one a card"):
        sharded_embeddings(g, card, add, one=one,
                           groups=[d for _, d in across_cards()])
    del g
    with timed("lmt substrate one group a card"):
        lmt_across_cards(add)
    print(f"across cards: {time.perf_counter() - t0:.1f} s; every run "
          f"equal to one group on cuda:0; kernel launches {totals}")
    return 0


def lmt_across_cards(add) -> None:
    """Phase 12's grouped substrate with one group a card: granite_moe
    FULL's 4 pipeline stages in 2 and 4 groups (as many as the cards) and
    the compressed reduction's 2 pods on 2 cards, each equal to its one
    group on cuda:0, under deterministic algorithms."""
    import torch
    cards = torch.cuda.device_count()
    failures = []
    torch.use_deterministic_algorithms(True)
    try:
        cfg, stacked, xs, shapes = lmt_pipe_draw()
        lmt_pipeline(cfg, stacked, xs, failures, add,
                     [("G=1 on cuda:0", on_card0(1))]
                     + [(f"G={G} one a card", [torch.device("cuda", i)
                                               for i in range(G)])
                        for G in LMT_PIPE_GROUPS if 1 < G <= cards])
        del stacked, xs
        torch.cuda.empty_cache()
        lmt_crosspod(shapes, failures,
                     [(f"{LMT_PODS} groups on {LMT_PODS} cards",
                       [torch.device("cuda", i) for i in range(LMT_PODS)])])
    finally:
        torch.use_deterministic_algorithms(False)
    if failures:
        raise AssertionError("lmt across cards: " + "; ".join(failures))


# Phase 9: the closed batches run again with the timers' clock replaced by
# random values, against phase 3's fused runs of the same batches.
VERIFIER_PROGRAMS = ("urw", "ppr")
VERIFIER_CLOCK_SEED = 9
VERIFIER_FIXTURES = ("dma-missing-wait", "dma-overwrite-in-flight",
                     "dma-undrained", "dma-cached-phantom-copy",
                     "visit-nonconsecutive", "visit-bad-first")
VERIFIER_TRACE_WARP = 0          # the grid warp whose schedule is traced
MAIN_FUSED = {}   # program -> phase 3's first fused WalkResult


def random_clock():
    """A stand-in for ``repro_torch.core.clock.now`` that returns uniform
    random seconds, and the list its calls append to."""
    rng = np.random.default_rng(VERIFIER_CLOCK_SEED)
    reads = []

    def now():
        reads.append(1)
        return float(rng.uniform(-1e6, 1e6))
    return now, reads


def start_fixtures() -> list:
    """``python -m repro_torch.analysis --fixture NAME`` for each fixture
    of the ``dma`` pass, each a fresh process, all started together."""
    env = dict(os.environ, PYTHONPATH=SRC)
    return [(name, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--fixture", name],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)) for name in VERIFIER_FIXTURES]


def finish_fixtures(procs) -> None:
    """Each fixture's process must exit non-zero with findings printed."""
    for name, proc in procs:
        out, _ = proc.communicate(timeout=CLI_TIMEOUT)
        if proc.returncode == 0 or "finding" not in out:
            raise AssertionError(f"fixture {name}: exit {proc.returncode}, "
                                 f"its defect not caught:\n{out}")
        last = out.strip().splitlines()[-1]
        print(f"verifier --fixture {name}: exit {proc.returncode} ({last})")


def traced_launch(g, prog, cfg, depth, key, state, cache=None):
    """An untraced and a traced launch of k = 1 supersteps from ``state``
    (each on its own copy) and the plain version's: both launches equal
    the plain version in every state tensor.  Returns the trace."""
    import torch

    from repro_torch.kernels.fused_superstep import ops, ref
    k = PHASE2_K["node2vec_w"]
    want = ref.fused_superstep_ref(g, prog.spec, cfg, depth,
                                   clone_state(state), key, k,
                                   None if cache is None else cache.hot_ids)
    work, block = ops.pack(clone_state(state))
    ops.fused_superstep(g, prog.spec, cfg, depth, work, key, k, block,
                        cache=cache)
    traced, tblock = ops.pack(clone_state(state))
    trace = ops.trace_schedule(g, prog.spec, cfg, depth, traced, key, k,
                               tblock, cache=cache, warp=VERIFIER_TRACE_WARP)
    torch.cuda.synchronize()
    for label, got in (("untraced", work), ("traced", traced)):
        err = state_err(got, want)
        if err != 0:
            raise AssertionError(f"verifier trace: the {label} launch "
                                 f"disagrees with the plain version (max "
                                 f"abs err {err})")
    if state_err(traced, work) != 0 or not torch.equal(tblock, block):
        raise AssertionError("verifier trace: the traced launch's bits "
                             "differ from the untraced launch's")
    return trace


def verifier_traces(g, starts_np) -> None:
    """Phase 9, the reservoir's staged schedule on the card: weighted
    Node2Vec (W = 4,096, k = 1) from the main-path state, and from a tail
    state with every live lane on the hub and the hub's row cached in
    shared memory, each launched untraced and traced
    (:func:`traced_launch`).  Each trace has no finding from the DMA pass
    and equals the declaration op for op: the uncached one
    ``dma_schedule("reservoir_n2v", chunks=n)`` over the traced warp's n
    items, the cached one the cached declaration, with no copy started
    on a ``cache.*`` buffer.  Any difference raises."""
    import dataclasses

    from repro_torch.analysis.dma_hazards import check_schedule
    from repro_torch.core.rng import stream_key
    from repro_torch.core.walk_engine import EngineConfig, maybe_build_cache
    from repro_torch.kernels.fused_superstep import ops
    from repro_torch.kernels.fused_superstep.schedule import dma_schedule
    prog = programs()["node2vec_w"]
    cfg = EngineConfig(num_slots=NUM_SLOTS, max_hops=MAX_HOPS,
                       mode="zero_bubble", injection_delay=0,
                       step_impl="fused", hops_per_launch=HOPS_PER_LAUNCH)
    CH = prog.spec.reservoir_chunk
    if CH > 64:
        raise AssertionError(f"reservoir_chunk {CH}: an item is one staged "
                             f"window only at CH <= 64")

    def check(label, trace, declared):
        findings = check_schedule(trace.ops, f"trace.{label}")
        if findings or trace.windows != trace.items or trace.items < 1:
            raise AssertionError(f"verifier trace {label}: {len(findings)} "
                                 f"findings, {trace.items} items, "
                                 f"{trace.windows} windows: {findings}")
        phantom = [op for op in trace.ops if op.kind == "start"
                   and op.buffer.startswith("cache.")]
        if phantom or trace.ops != declared:
            first = next((i for i, (a, b) in enumerate(
                zip(trace.ops, declared)) if a != b),
                min(len(trace.ops), len(declared)))
            raise AssertionError(
                f"verifier trace {label}: {len(trace.ops)} ops against "
                f"{len(declared)} declared, first difference at op {first}"
                f"; {len(phantom)} starts on a cache buffer")
        kinds = {k: sum(op.kind == k for op in trace.ops)
                 for k in ("start", "wait", "read")}
        print(f"verifier trace {label}: warp {VERIFIER_TRACE_WARP}, "
              f"{trace.items} (lane, chunk) items; {len(trace.ops)} ops "
              f"({kinds['start']} starts, {kinds['wait']} waits, "
              f"{kinds['read']} reads) == the declared schedule op for op; "
              f"0 findings; the traced launch == the untraced launch == "
              f"the plain version in every state tensor")

    key = tuple(int(k) for k in stream_key(0))   # the main path's
    state, depth = main_path_state(g, prog, cfg, key, starts_np)
    trace = traced_launch(g, prog, cfg, depth, key, state)
    check("reservoir_n2v", trace,
          dma_schedule("reservoir_n2v", chunks=trace.items,
                       weighted=g.weights is not None))

    ccfg = dataclasses.replace(cfg, cache_budget=shared_budget("node2vec_w"))
    block = ops.cache_block(maybe_build_cache(prog.spec, ccfg, g), g.device)
    tier = ops.cache_tier(prog.spec, ccfg, block)
    if tier != "shared":
        raise AssertionError(f"verifier trace: the hub's cache "
                             f"({block.nbytes()} B) is in the {tier} tier")
    state, depth = mid_drain_state(g, prog, ccfg,
                                   tuple(int(k) for k in stream_key(7)),
                                   seed=NUM_SLOTS)
    all_hub_state(g, state)
    key = tuple(int(k) for k in stream_key(7))
    trace = traced_launch(g, prog, ccfg, depth, key, state, cache=block)
    check(f"reservoir_n2v.cached (H={block.num_hot}, {block.nbytes()} B, "
          f"shared)", trace,
          dma_schedule("reservoir_n2v", chunks=trace.items, cached=True,
                       weighted=g.weights is not None))


def run_verifier(graphs, starts_np) -> dict:
    """Phase 9: the static verifier on this checkout
    (``repro_torch.analysis.run_all()`` and both ``--check`` CLIs, each
    in a fresh process: any finding or docs drift raises; the ``dma``
    pass's fixtures, each caught in a fresh process), the reservoir's
    traced schedule (:func:`verifier_traces`), then the
    timers' clock replaced by random values (``random_clock``): fused URW
    and PPR closed batches at the main path's width, each equal to phase
    3's fused run of the same batch in paths, lengths and every stat but
    ``launches``, and a fused URW stream at capacity 8,192 equal to the
    same stream with the real clock in every harvested walk and every
    stat but ``launches``.  Every run zeroes the launch counts before it
    and reads them after; returns the fused kernel's launches summed."""
    import torch

    from repro_torch.analysis import render_findings, run_all
    from repro_torch.core import clock
    from repro_torch.kernels.fused_superstep import ops as fused_ops
    from repro_torch.walker import ExecutionConfig, compile
    t = time.perf_counter()
    fixtures = start_fixtures()
    findings = run_all()
    if findings:
        raise AssertionError("verifier findings:\n"
                             + render_findings(findings))
    print(f"verifier: run_all() holds, 4 passes ({time.perf_counter() - t:.1f}"
          f" s; both --check CLIs ran during the build)")
    verifier_traces(graphs["node2vec_w"], starts_np)
    finish_fixtures(fixtures)
    print(f"verifier: fixtures and traces {time.perf_counter() - t:.1f} s")

    def launched(stats):
        n = fused_ops.LAUNCHES["fused_superstep"]
        if n != int(stats.launches) or n <= 0:
            raise AssertionError(f"fused launches {n}, stats say "
                                 f"{int(stats.launches)}")
        return n

    total, real_now = 0, clock.now
    now, reads = random_clock()
    try:
        clock.now = now
        for name in VERIFIER_PROGRAMS:
            g = graphs[name]
            w = compile(programs()[name], execution=ExecutionConfig(
                num_slots=NUM_SLOTS, record_paths=True, step_impl="fused",
                hops_per_launch=HOPS_PER_LAUNCH))
            starts = torch.from_numpy(starts_np).to(g.device)
            fused_ops.reset_launches()
            res = w.run(g, starts, seed=0)
            torch.cuda.synchronize()
            total += launched(res.stats)
            if not same_walks(MAIN_FUSED[name], res):
                raise AssertionError(f"verifier {name}: the random clock "
                                     "changed the walks or stats")
            print(f"verifier {name} fused, random clock: == phase 3's fused "
                  f"run in paths, lengths and the {len(res.stats) - 1} stats "
                  f"other than launches (drain wall_s read "
                  f"{w.last_drain.wall_s:.6g})")
    finally:
        clock.now = real_now

    g = graphs["urw"]
    starts = stream_starts(g, STREAM_SMALL_CAPACITY)
    runs = {}
    for label, fn in (("real", real_now), ("random", now)):
        stream = stream_walker("urw", "fused").stream(
            g, capacity=STREAM_SMALL_CAPACITY, seed=STREAM_SEED)
        fused_ops.reset_launches()
        try:
            clock.now = fn
            h = soak(stream, starts)
        finally:
            clock.now = real_now
        st = stream.walk_stats()
        total += launched(st)
        runs[label] = (h, st, stream.host_read_s)
    (h0, st0, read0), (h1, st1, read1) = runs["real"], runs["random"]
    if not (same_harvest(h0, h1) and same_stats(st0, st1)) \
            or len(h1["epochs"]) != len(starts):
        raise AssertionError("verifier stream: the random clock changed "
                             "the harvest or stats")
    if not reads:
        raise AssertionError("verifier: no timer read clock.now")
    print(f"verifier stream urw fused capacity {STREAM_SMALL_CAPACITY}, "
          f"random clock: {len(starts)} walks == the real clock's in every "
          f"harvested walk and stat but launches (host_read_s {read0:.6g} "
          f"real, {read1:.6g} random; {len(reads)} clock reads)")
    return {"fused_superstep": total}


# ---------------------------------------------------------------- phase 10
#
# The graph-learning zoo (``repro_torch.models``) at full width on the
# reference's shape cells (``configs/base.py``): one forward, loss and
# gradient on the card against the same port code on the CPU, two 8-step
# runs of ``runtime.train_loop.run`` under deterministic algorithms that
# must agree bit for bit, and the step's numbers.  The gathers and sums
# run on the embedding-bag and segment-sum kernels.

ZOO_STEPS = 8                    # steps a determinism run
ZOO_TIMED_FROM = 2               # median over steps 3-8
ZOO_FWD = dict(rtol=1e-4, atol=1e-5)    # the CPU tests' tolerances
ZOO_LOSS_RTOL = 1e-5
ZOO_GRAD = dict(rtol=1e-3, atol=1e-6)
ZOO_PNA_ATOL = 1e-4              # PNA: atol = this x the array's max |x|
# Card vs CPU at full width: each output and gradient leaf within a
# relative norm error, ||card - cpu|| / ||cpu||, of the CPU tests' rtol
# (1e-4 outputs, 1e-3 gradients).  Elementwise, the cuBLAS and CPU BLAS
# summation orders over 15 layers and K = 1,433 miss the SMOKE sizes'
# atol on near-zero elements (MeshGraphNet: 95.6 times the elementwise
# tolerance at a leaf norm error of 5.1e-5, on an H100).  PNA: 10x
# both, for its std aggregator: where a segment's messages are (nearly)
# equal (duplicates the sampler draws, one in-edge), sqrt(v + 1e-6) has
# slope up to 500 at v ~ 0 and scales each device's rounding residue of
# E[m^2] - E[m]^2 (PNA on the minibatch: gradient norm error 1.37e-3).
# The elementwise ratios are printed beside.
ZOO_NORM = {"out": 1e-4, "grad": 1e-3}
ZOO_NORM_PNA = {"out": 1e-3, "grad": 1e-2}
# Row widths the zoo hands the two kernels: degree counts and energies,
# positions, PNA, the minibatch features, MACE's l=2 rows (C·9), Cora.
ZOO_WIDTHS = (1, 3, 75, 602, 1_152, 1_433)
ZOO_MB_SEEDS = 1_024             # minibatch_lg (launch/specs.py:130-177)
ZOO_MB_FANOUTS = (15, 10)
ZOO_MB_FEAT = 602
ZOO_MB_CLASSES = 47
ZOO_DCN_TRAIN = 65_536           # train_batch
ZOO_DCN_CHECK = 512              # card vs CPU at serve_p99's batch
ZOO_SERVE = {"serve_p99": 512, "serve_bulk": 262_144}
ZOO_CANDIDATES = 1_000_000       # retrieval_cand
ZOO_CALLS = 8                    # timed predict / retrieval calls
ZOO_LAUNCHER_STEPS = 6


def tree_map(fn, tree):
    from repro_torch.checkpoint import checkpointer
    return checkpointer.tree_map(fn, tree)


def tree_leaves(tree):
    from repro_torch.checkpoint import checkpointer
    return checkpointer.leaves(tree)


def zoo_counts() -> dict:
    """The launches of the zoo's two kernels since the last reset."""
    launched = embedding_launches()
    return {k: launched[k] for k in ("embedding_bag", "segment_sum")}


def worst_ratio(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|) on ``got``'s device (at most
    1 passes; NaN fails)."""
    want = want.to(got.device)
    if got.numel() == 0:
        return 0.0
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def longest_segment(*ids) -> int:
    """The most rows any one segment of the step's sums takes."""
    import torch
    return max(int(torch.bincount(x.reshape(-1).long()).max()) for x in ids)


def zoo_forward(arch, cfg):
    """The arch's forward output as a function of (params, batch)."""
    from repro_torch.launch.train import gnn_module
    if arch == "dcn_v2":
        from repro_torch.models.recsys import dcn
        return lambda p, b: dcn.predict(p, b["dense"], b["sparse"], cfg)
    m = gnn_module(arch)
    if arch in ("schnet", "mace"):
        return lambda p, b: m.apply(p, b["species"], b["positions"],
                                    b["edge_index"], cfg, b["mol_id"],
                                    b["energies"].shape[0])
    if arch == "meshgraphnet":
        return lambda p, b: m.apply(p, b["node_feats"], b["edge_feats"],
                                    b["edge_index"], cfg)
    return lambda p, b: m.apply(p, b["node_feats"], b["edge_index"], cfg)


def zoo_loss(arch, cfg):
    from repro_torch.launch.train import gnn_module
    if arch == "dcn_v2":
        from repro_torch.models.recsys import dcn
        return lambda p, b: dcn.train_loss(p, b, cfg)
    m = gnn_module(arch)
    return lambda p, b: m.train_loss(p, b, cfg)


def zoo_loss_grads(loss_fn, params, batch):
    import torch

    from repro_torch.checkpoint.checkpointer import unflatten
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(unflatten(params, iter(leaves)), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def zoo_card_vs_cpu(label, arch, cfg, params_cpu, batch_cpu,
                    failures) -> None:
    """One forward, the loss and every gradient leaf on the card against
    the same port code on the CPU (whose plain path the CPU tests hold to
    the JAX reference), within the CPU tests' tolerances; a miss is
    appended to ``failures`` (the phase raises on them at its end)."""
    import torch
    fwd, loss_fn = zoo_forward(arch, cfg), zoo_loss(arch, cfg)
    res = {}
    for dev in ("cuda", "cpu"):
        p = params_cpu if dev == "cpu" else tree_map(lambda x: x.cuda(),
                                                     params_cpu)
        b = batch_cpu if dev == "cpu" else tree_map(lambda x: x.cuda(),
                                                    batch_cpu)
        with torch.no_grad():
            out = fwd(p, b)
        res[dev] = (out, *zoo_loss_grads(loss_fn, p, b))
        del p, b
    (oc, lc, gc), (oh, lh, gh) = res["cuda"], res["cpu"]
    pna = arch == "pna"
    tol = ZOO_NORM_PNA if pna else ZOO_NORM

    def elementwise(a, b, rtol, atol):
        return worst_ratio(a, b, rtol, ZOO_PNA_ATOL * float(b.abs().max())
                           if pna else atol)
    e_out = norm_error(oc, oh)
    r_out = elementwise(oc, oh, **ZOO_FWD)
    r_loss = abs(float(lc) - float(lh)) / (ZOO_LOSS_RTOL * abs(float(lh)))
    from repro_torch.checkpoint.checkpointer import flatten_with_paths
    paths = [p for p, _ in flatten_with_paths(params_cpu)]
    norms = [norm_error(a, b) for a, b in zip(gc, gh)]
    ratios = [elementwise(a, b, **ZOO_GRAD) for a, b in zip(gc, gh)]
    worst = int(np.nanargmax(norms))
    print(f"zoo {label} {arch}: card vs CPU, output norm error {e_out:.3g} "
          f"(tolerance {tol['out']:g}; elementwise {r_out:.3g} of the CPU "
          f"tests' tolerance), loss {r_loss:.3g} of its tolerance, gradient "
          f"leaves' norm errors up to {norms[worst]:.3g} ({paths[worst]}; "
          f"tolerance {tol['grad']:g}; elementwise up to "
          f"{float(np.nanmax(ratios)):.3g}); loss {float(lc):.8g} card, "
          f"{float(lh):.8g} CPU")
    bad = [f"{p} {e:.3g}" for p, e in zip(paths, norms)
           if not e <= tol["grad"]]
    if not (e_out <= tol["out"] and r_loss <= 1.0) or bad:
        failures.append(f"zoo {label} {arch}: the card differs from the CPU "
                        f"(output norm error {e_out:.3g}, loss {r_loss:.3g} "
                        f"of its tolerance, leaves {bad})")


def norm_error(got, want) -> float:
    """||got - want|| / ||want|| on ``got``'s device (0 for two zeros)."""
    want = want.to(got.device)
    den = float(want.norm())
    num = float((got - want).norm())
    return num / den if den > 0 else num


def zoo_train(label, arch, cfg, params, batch_fn, segment_ids) -> dict:
    """Two runs of ZOO_STEPS steps through ``train_loop.run`` from copies of
    ``params`` (on the card) under ``torch.use_deterministic_algorithms``:
    losses and final parameters bit-identical.  Prints the median step
    time of steps 3-8, peak memory, the longest segment and the kernels'
    launches; returns the launches of both runs."""
    import shutil
    import tempfile

    import torch

    from repro_torch.launch.train import make_grad_step
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    opt = adamw.AdamWConfig(total_steps=ZOO_STEPS, warmup_steps=1)
    step = make_grad_step(zoo_loss(arch, cfg), opt)
    launched = {"embedding_bag": 0, "segment_sum": 0}
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) \
                as d:
            for r in range(2):
                p = tree_map(torch.clone, params)
                state = (p, adamw.init_state(p))
                del p
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_all_launches()
                t0 = time.perf_counter()
                state, n, hist, _ = train_loop.run(
                    step, state, batch_fn, train_loop.TrainLoopConfig(
                        total_steps=ZOO_STEPS, ckpt_dir=os.path.join(d, str(r)),
                        ckpt_every=ZOO_STEPS + 1, log_every=1))
                wall = time.perf_counter() - t0
                shutil.rmtree(os.path.join(d, str(r)))
                counts = zoo_counts()
                if n != ZOO_STEPS or min(counts.values()) <= 0:
                    raise AssertionError(f"zoo {label} {arch}: run {r} took "
                                         f"{n} steps, launches {counts}")
                for k in launched:
                    launched[k] += counts[k]
                runs.append((hist, tree_leaves(state[0]), wall, counts,
                             torch.cuda.max_memory_allocated()))
    finally:
        torch.use_deterministic_algorithms(False)
    (h0, p0, wall0, c0, peak), (h1, p1, wall1, _, _) = runs
    losses = [h["loss"] for h in h0]
    if losses != [h["loss"] for h in h1] or not all(
            torch.equal(a, b) for a, b in zip(p0, p1)):
        raise AssertionError(f"zoo {label} {arch}: two runs from the same "
                             "parameters differ (not deterministic)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"zoo {label} {arch}: a loss is not finite")
    ms = float(np.median([h["dt_s"] for h in h0[ZOO_TIMED_FROM:]])) * 1e3
    print(f"zoo {label} {arch}: {ms:.4f} ms a training step (median of "
          f"steps {ZOO_TIMED_FROM + 1}-{ZOO_STEPS}), peak memory "
          f"{peak / 2**30:.3f} GiB, longest segment "
          f"{longest_segment(*segment_ids)} rows, launches a run "
          f"embedding_bag {c0['embedding_bag']} segment_sum "
          f"{c0['segment_sum']}; losses {losses[0]:.6g} -> {losses[-1]:.6g} "
          f"and final parameters bit-identical over 2 runs of {ZOO_STEPS} "
          f"steps (deterministic algorithms; run walls {wall0:.2f}, "
          f"{wall1:.2f} s with the final checkpoint)")
    del runs, p0, p1
    zoo_profile(label, arch, step, state, batch_fn)
    return launched


def zoo_profile(label, arch, step, state, batch_fn, reps=4, traced=3):
    """Where a step's time goes, continuing from ``state``: the synchronised
    wall of a step (batch included) without and with deterministic
    algorithms (median of ``reps`` each), then ``torch.profiler`` over
    ``traced`` deterministic steps: device busy ms and device launches a
    step and the top kernels.  The profiler's own overhead is not in the
    walls."""
    import torch
    walls = {}
    try:
        for det in (False, True):
            torch.use_deterministic_algorithms(det)
            ts = []
            for i in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step(state, batch_fn(i))
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            walls[det] = float(np.median(ts)) * 1e3
        with device_trace() as prof:
            for i in range(traced):
                state, _ = step(state, batch_fn(i))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3 / traced
    top = "; ".join(f"{k[:48]} {us / 1e3 / traced:.3f} ms x{n / traced:g}"
                    for us, n, k in rows[:5])
    print(f"zoo {label} {arch} profile: {walls[False]:.4f} ms a step without "
          f"deterministic algorithms, {walls[True]:.4f} with; device busy "
          f"{busy:.4f} ms a step ({busy / walls[True]:.4f} of the "
          f"deterministic wall), {sum(r[1] for r in rows) / traced:.0f} "
          f"device launches a step; top: {top}")


def zoo_widths(cora_g) -> None:
    """Both kernels at every row width the zoo gives them, over Cora's
    edges (E rows gathered by source, summed by destination), bit-equal to
    their plain versions on CPU copies."""
    import torch

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    src, dst = cora_edges(cora_g)
    n = cora_g.num_vertices
    gen = torch.Generator(device="cuda").manual_seed(10)
    for width in ZOO_WIDTHS:
        table = torch.randn((n, width), generator=gen, device="cuda")
        rows = embedding_bag(src[:, None].cuda(), table)
        sums = segment_sum(rows, dst.cuda(), n)
        torch.cuda.synchronize()
        if not torch.equal(rows.cpu(), embedding_bag_ref(src[:, None],
                                                         table.cpu())):
            raise AssertionError(f"zoo widths: embedding_bag at D = {width} "
                                 "differs from its plain version")
        if not torch.equal(sums.cpu(), segment_sum_ref(rows.cpu(), dst, n)):
            raise AssertionError(f"zoo widths: segment_sum at D = {width} "
                                 "differs from its plain version")
    print(f"zoo widths: embedding_bag and segment_sum at D = "
          f"{', '.join(map(str, ZOO_WIDTHS))} over Cora's {src.numel()} "
          f"edges bit-equal to their plain versions")


def cora_edges(g):
    """(src, dst) int32 CPU tensors of a CSR graph's edges."""
    import torch
    rp = g.row_ptr.cpu()
    src = torch.repeat_interleave(torch.arange(g.num_vertices,
                                               dtype=torch.int32),
                                  (rp[1:] - rp[:-1]).long())
    return src, g.col.cpu()


def zoo_cell(label, arch, cfg, batch_cpu, segment_keys, failures) -> dict:
    """A cell whose batch is fixed: card vs CPU, then the two runs."""
    import torch

    from repro_torch.core.rng import seeded_generator
    from repro_torch.launch.train import gnn_module
    params = gnn_module(arch).init_params(seeded_generator(0), cfg,
                                          device="cpu")
    zoo_card_vs_cpu(label, arch, cfg, params, batch_cpu, failures)
    params = tree_map(lambda x: x.cuda(), params)
    batch = tree_map(lambda x: x.cuda(), batch_cpu)
    ids = [batch_cpu["edge_index"][0], batch_cpu["edge_index"][1]] + \
        [batch_cpu[k] for k in segment_keys]
    out = zoo_train(label, arch, cfg, params, lambda step: batch, ids)
    del params, batch
    torch.cuda.empty_cache()
    return out


def zoo_minibatch(g, add, failures) -> None:
    """``minibatch_lg``: 1,024 seeds sampled (15, 10) on the WG graph (the
    blocks bit-equal to a CPU copy's), the union graph relabelled to local
    ids, features gathered from a (V x 602) table on the card each step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.rng import seeded_generator, stream_key
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.sampling_service import (block_union_graph,
                                                    sample_blocks,
                                                    sample_neighbors)
    from repro_torch.models import layers as L
    from repro_torch.models.gnn import pna
    seeds = np.random.default_rng(0).integers(0, g.num_vertices,
                                              ZOO_MB_SEEDS)
    blocks, nodes = sample_blocks(g, seeds, ZOO_MB_FANOUTS, seed=0)
    g_cpu = CSRGraph(row_ptr=g.row_ptr.cpu(), col=g.col.cpu(),
                     num_vertices=g.num_vertices, num_edges=g.num_edges,
                     max_degree=g.max_degree)
    blocks_cpu, nodes_cpu = sample_blocks(g_cpu, seeds, ZOO_MB_FANOUTS,
                                          seed=0)
    if not (torch.equal(nodes.cpu(), nodes_cpu) and all(
            torch.equal(a.edge_index.cpu(), b.edge_index)
            for a, b in zip(blocks, blocks_cpu))):
        raise AssertionError("zoo minibatch: the sampler's blocks on the card "
                             "differ from the CPU's")
    hop_ms = []
    key, frontier = stream_key(0), torch.as_tensor(seeds, device="cuda") \
        .to(torch.int32)
    for h, f in enumerate(ZOO_MB_FANOUTS):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nb = sample_neighbors(g, frontier, f, key, h)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        hop_ms.append(float(np.median(ts)) * 1e3)
        frontier = nb.reshape(-1)
    union = block_union_graph(blocks)
    uniq, local = torch.unique(union, return_inverse=True)
    local = local.to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(11)
    feats = torch.rand((g.num_vertices, ZOO_MB_FEAT), generator=gen,
                       device="cuda")
    labels = torch.randint(0, ZOO_MB_CLASSES, (g.num_vertices,),
                           generator=gen, device="cuda", dtype=torch.int32)
    node_feats = L.gather_rows(feats, uniq)
    if not torch.equal(node_feats, feats[uniq.long()]):
        raise AssertionError("zoo minibatch: the feature gather differs from "
                             "indexing")
    print(f"zoo minibatch_lg sampler: {ZOO_MB_SEEDS} seeds, fanouts "
          f"{ZOO_MB_FANOUTS}: {nodes.numel()} sampled ids, "
          f"{union.shape[1]} edges, {uniq.numel()} distinct nodes; hops "
          f"{hop_ms[0]:.4f}, {hop_ms[1]:.4f} ms; blocks and ids bit-equal "
          f"to the same call on a CPU copy of the graph; features "
          f"({g.num_vertices} x {ZOO_MB_FEAT}, "
          f"{feats.numel() * 4 / 1e9:.2f} GB) on the card")
    cfg = dataclasses.replace(get_arch("pna").FULL, node_in=ZOO_MB_FEAT,
                              out_dim=ZOO_MB_CLASSES)
    batch_labels = labels[uniq.long()]
    batch_cpu = {"node_feats": node_feats.cpu(), "edge_index": local.cpu(),
                 "labels": batch_labels.cpu()}
    params = pna.init_params(seeded_generator(0), cfg, device="cpu")
    zoo_card_vs_cpu("minibatch_lg", "pna", cfg, params, batch_cpu, failures)
    params = tree_map(lambda x: x.cuda(), params)

    def batch_fn(step):
        return {"node_feats": L.gather_rows(feats, uniq),
                "edge_index": local, "labels": batch_labels}
    add(zoo_train("minibatch_lg", "pna", cfg, params, batch_fn,
                  [local[0], local[1]]))
    del feats, params
    torch.cuda.empty_cache()


def zoo_dcn(add, failures) -> None:
    """DCN-v2 FULL: its weights drawn for the card equal the CPU's bit for
    bit (both drawn and scaled on the CPU generator), card vs CPU at
    batch 512, ``train_batch`` (65,536) trained twice, ``serve_p99`` /
    ``serve_bulk`` predicts and ``retrieval_cand`` (one query against
    1,000,000 x 64 candidates), each run twice and equal."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.rng import seeded_generator
    from repro_torch.data.pipeline import recsys_batch, to_device
    from repro_torch.models.recsys import dcn
    cfg = get_arch("dcn_v2").FULL
    t0 = time.perf_counter()
    params_cpu = dcn.init_params(seeded_generator(0), cfg, device="cpu")
    init_s = time.perf_counter() - t0

    def batch(n, seed, device):
        return to_device(recsys_batch(n, cfg.n_dense, cfg.n_sparse,
                                      cfg.vocabs(), seed=seed), device)
    zoo_card_vs_cpu("train_batch", "dcn_v2", cfg, params_cpu,
                    batch(ZOO_DCN_CHECK, 99, "cpu"), failures)
    gen = torch.Generator(device="cuda").manual_seed(12)
    cands = torch.nn.functional.normalize(torch.randn(
        (ZOO_CANDIDATES, cfg.retrieval_dim), generator=gen, device="cuda"),
        dim=-1)
    q = batch(1, 7, "cpu")
    with torch.no_grad():
        want = dcn.retrieval_scores(params_cpu, q["dense"], q["sparse"],
                                    cands.cpu(), cfg)
    t0 = time.perf_counter()
    params = dcn.init_params(seeded_generator(0), cfg, device="cuda")
    card_init_s = time.perf_counter() - t0
    same = all(torch.equal(a, b.cuda()) for a, b in
               zip(tree_leaves(params), tree_leaves(params_cpu)))
    verdict = "equals" if same else "DIFFERS FROM"
    print(f"zoo dcn_v2 init_params(device='cuda') {verdict} the CPU's bit "
          f"for bit ({len(tree_leaves(params))} leaves, drawn in "
          f"{card_init_s:.1f} s)")
    if not same:
        failures.append("zoo dcn_v2: the card's initial weights differ "
                        "from the CPU's")
    del params_cpu
    with torch.no_grad():
        got = dcn.retrieval_scores(params, q["dense"].cuda(),
                                   q["sparse"].cuda(), cands, cfg)
    r = worst_ratio(got, want, **ZOO_FWD)
    print(f"zoo retrieval_cand dcn_v2: scores against {ZOO_CANDIDATES} "
          f"candidates on the card vs the CPU {r:.3g} of the tolerance "
          f"(params made on the CPU in {init_s:.1f} s)")
    if not r <= 1.0:
        failures.append(f"zoo retrieval_cand: the card differs from the CPU "
                        f"({r:.3g} of the tolerance)")
    batches = [batch(ZOO_DCN_TRAIN, s, "cuda") for s in range(ZOO_STEPS)]
    add(zoo_train("train_batch", "dcn_v2", cfg, params,
                  lambda step: batches[step],
                  [batches[0]["sparse"][:, i] for i in range(cfg.n_sparse)]))
    del batches
    def predict(b):
        return lambda: dcn.predict(params, b["dense"], b["sparse"], cfg)
    calls = {name: predict(batch(n, 5, "cuda"))
             for name, n in ZOO_SERVE.items()}
    qc = tree_map(lambda x: x.cuda(), q)
    calls["retrieval_cand"] = lambda: dcn.retrieval_scores(
        params, qc["dense"], qc["sparse"], cands, cfg)
    for name, fn in calls.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        times, outs = [], []
        with torch.no_grad():
            for _ in range(ZOO_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(fn())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        counts = zoo_counts()
        add(counts)
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"zoo {name}: two calls differ")
        print(f"zoo {name} dcn_v2: {float(np.median(times[1:])) * 1e3:.4f} ms "
              f"a call (median of calls 2-{ZOO_CALLS}, output "
              f"{tuple(outs[0].shape)}), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"launches embedding_bag {counts['embedding_bag']} "
              f"segment_sum {counts['segment_sum']}; {ZOO_CALLS} calls "
              f"bit-identical")
    del params, cands, calls, outs
    torch.cuda.empty_cache()


def run_zoo(g) -> dict:
    """Phase 10: every cell of the zoo on the card; returns the kernels'
    launches summed over the cells' runs (the comparisons' launches are
    not counted)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.graph import make_cora_like
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("zoo: float32 matmuls must run at 'highest' "
                             "precision (no TF32)")
    launched = {"embedding_bag": 0, "segment_sum": 0}
    failures = []

    def add(counts):
        for k in launched:
            launched[k] += counts[k]
    cora_g, cora_x, cora_y = make_cora_like(0, device="cuda")
    zoo_widths(cora_g)
    src, dst = cora_edges(cora_g)
    pna_cfg = dataclasses.replace(get_arch("pna").FULL,
                                  node_in=cora_x.shape[1])
    with timed("zoo full_graph_sm pna"):
        add(zoo_cell("full_graph_sm", "pna", pna_cfg, {
            "node_feats": torch.from_numpy(cora_x),
            "edge_index": torch.stack([src, dst]),
            "labels": torch.from_numpy(cora_y)}, (), failures))
    cell = get_arch("meshgraphnet").SHAPES["full_graph_sm"].dims
    mgn_cfg = dataclasses.replace(get_arch("meshgraphnet").FULL,
                                  node_in=cell["d_feat"], edge_in=4)
    mgn = pipeline.to_device(pipeline.gnn_batch(
        cell["n_nodes"], cell["n_edges"], cell["d_feat"], d_edge=4), "cpu")
    with timed("zoo full_graph_sm meshgraphnet"):
        add(zoo_cell("full_graph_sm", "meshgraphnet", mgn_cfg, mgn, (),
                     failures))
    mol = get_arch("schnet").SHAPES["molecule"].dims
    mol_b = pipeline.to_device(pipeline.molecule_batch(
        mol["n_nodes"], mol["n_edges"], mol["batch"]), "cpu")
    for arch in ("schnet", "mace"):
        with timed(f"zoo molecule {arch}"):
            add(zoo_cell("molecule", arch, get_arch(arch).FULL, mol_b,
                         ("species", "mol_id"), failures))
    with timed("zoo minibatch_lg"):
        zoo_minibatch(g, add, failures)
    with timed("zoo dcn_v2"):
        zoo_dcn(add, failures)
    if failures:
        raise AssertionError("zoo: " + "; ".join(failures))
    print(f"zoo launches over the phase's runs: {launched} "
          f"({card_line()})")
    return launched


# ---------------------------------------------------------------- phase 11
#
# The language-model serving slice (``repro_torch.models.transformer`` and
# ``launch.serve``) at full width in float32, the reference's serving
# dtype (its loop's cache is float32, and bfloat16 parameters over it make
# its layer scan refuse the promoted carry).  The token embedding gathers
# on the embedding-bag kernel; the MoE's dispatch gathers on it and its
# combine sums on the segment-sum kernel.

LM_DEPTH = 2                     # (a): layers kept for card vs CPU
LM_CHECK_TOKENS = 16             # (a): prompt length of its 2 sequences
LM_CHECK_STEPS = 4               # (a): decode steps compared
# 16 new tokens a request, a cut in depth for the time limit (16
# requests over 8 slots still refill a slot).
LM_SERVE = {"requests": 16, "prompt": 128, "slots": 8, "max_new": 16}
LM_LONG = 4_096                  # (c): the two long prompts
LM_LONG_NEW = 4                  # (c): tokens served after them
LM_SHORT = 128                   # (e): decode vs forward at this length
LM_BLOCKS = (1_024, 2_048)       # (d): the config's blocks, then twice
LM_PREFILL_32K = 32_768          # (d): prefill_32k's sequence length
LM_PROFILED = 3                  # decode steps traced
# Path against path (card vs CPU, decode vs forward, 1,024 vs 2,048
# blocks): the relative norm error ||a - b|| / ||b|| of the logits (and
# of the caches in (a)) within the CPU tests' rtol, 1e-4: the same
# float32 function with its sums in other orders (cuBLAS, CPU BLAS, the
# online softmax's blocks).  Greedy tokens must be equal wherever the
# CPU's top-2 margin exceeds LM_MARGIN (logits are of order 1; the
# largest elementwise error is printed beside).
LM_NORM = 1e-4
LM_MARGIN = 1e-3


def lm_config(arch, **kw):
    import torch

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).FULL, dtype=torch.float32,
                               **kw)


def lm_no_drop(cfg):
    """``cfg`` with a capacity at which no token is dropped (``E / K``, so
    C >= T): a decode step (T = 2 tokens) and a forward over the whole
    sequence then route every token alike, where at the config's 1.25
    they drop different ones by design."""
    if not cfg.moe:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def lm_compare(label, got, want, failures, tol=LM_NORM) -> str:
    """The relative norm error of ``got`` (any device) against ``want``,
    as text; a miss is appended to ``failures``."""
    e = norm_error(got.float(), want.float())
    m = float((got.float() - want.float().to(got.device)).abs().max())
    if not e <= tol:
        failures.append(f"{label}: norm error {e:.3g} > {tol:g}")
    return f"{label} {e:.3g} (max |diff| {m:.3g})"


def lm_widths() -> None:
    """Both kernels at every shape the phase's counted runs give them,
    bit-equal to their plain versions on CPU copies: the token embedding
    (granite_moe's 49,155 x 1,536 table at 2 and 8 decode tokens, a
    128-token prompt, a 4,096-token prompt, (c)'s two 4,096-token
    sequences and (d)'s 32,768 tokens; deepseek_7b's 102,400 x 4,096 at
    2, 8 and 128), and
    granite_moe's MoE at the same token counts: the dispatch gather of
    token rows, the combine's gather of expert rows (E·C of them, 327,680
    at 32,768 tokens and at (c)'s no-drop capacity) and its sum of each
    token's K rows, in expert order."""
    import torch

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    cpu_gen = torch.Generator().manual_seed(13)
    shapes = []
    t0 = time.perf_counter()

    def gather(table, n):
        ids = torch.randint(0, table.shape[0], (n, 1), generator=cpu_gen,
                            dtype=torch.int32)
        got = embedding_bag(ids.cuda(), table).cpu()
        if not torch.equal(got, embedding_bag_ref(ids, table.cpu())):
            raise AssertionError(f"lm widths: embedding_bag over "
                                 f"{tuple(table.shape)}, {n} rows, differs "
                                 f"from its plain version")
        shapes.append(f"bag {n} of {tuple(table.shape)}")
        return got
    short = (2, LM_SERVE["slots"], LM_SERVE["prompt"])
    long = (LM_LONG, 2 * LM_LONG, LM_PREFILL_32K)
    for arch, counts in (("granite_moe", short + long),
                         ("deepseek_7b", short)):
        cfg = lm_config(arch)
        table = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                            device="cuda")
        for n in counts:
            gather(table, n)
        del table
    cfg = lm_config("granite_moe")
    moe, d = cfg.moe, cfg.d_model
    cells = [(T, moe.capacity_factor) for T in short + long]
    cells.append((2 * LM_LONG, lm_no_drop(cfg).moe.capacity_factor))
    for T, cf in cells:
        C = max(1, int(np.ceil(cf * moe.top_k * T / moe.num_experts)))
        gather(torch.randn((T, d), generator=gen, device="cuda"),
               T * moe.top_k)
        rows = gather(torch.randn((moe.num_experts * C, d), generator=gen,
                                  device="cuda"), T * moe.top_k)
        tok = torch.arange(T, dtype=torch.int32).repeat_interleave(
            moe.top_k)[torch.randperm(T * moe.top_k, generator=cpu_gen)]
        got = segment_sum(rows.cuda(), tok.cuda(), T).cpu()
        if not torch.equal(got, segment_sum_ref(rows, tok, T)):
            raise AssertionError(f"lm widths: segment_sum of {T} tokens' "
                                 f"{moe.top_k} rows differs from its plain "
                                 f"version")
        shapes.append(f"sum {T * moe.top_k} rows into {T}")
        del rows, got
    print(f"lm widths: {'; '.join(shapes)}: bit-equal to the plain versions "
          f"({time.perf_counter() - t0:.1f} s)")


def lm_card_vs_cpu(arch, failures) -> None:
    """(a) ``arch`` FULL at float32, depth cut to LM_DEPTH: the same
    weights (drawn on the CPU) on both devices; prefill logits and caches,
    then LM_CHECK_STEPS decode steps fed the CPU's greedy tokens."""
    import torch

    from repro_torch.core.rng import seeded_generator
    from repro_torch.models import transformer as tfm
    cfg = lm_config(arch, n_layers=LM_DEPTH)
    t0 = time.perf_counter()
    p_cpu = tfm.init_params(seeded_generator(0), cfg, device="cpu")
    init_s = time.perf_counter() - t0
    p_card = tree_map(lambda x: x.cuda(), p_cpu)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, LM_CHECK_TOKENS)), dtype=torch.int32)
    cap = LM_CHECK_TOKENS + LM_CHECK_STEPS + 1
    runs, fed = {}, []
    for dev, p in (("cpu", p_cpu), ("cuda", p_card)):
        logits, kv = tfm.prefill(p, toks.to(dev), cfg)
        cache = tfm.make_kv_cache(cfg, 2, cap, torch.float32, device=dev)
        cache[:, :, :, :LM_CHECK_TOKENS] = kv
        out = [logits[:, -1].cpu()]
        for s in range(LM_CHECK_STEPS):
            if dev == "cpu":
                fed.append(torch.argmax(out[-1], dim=-1).to(torch.int32))
            logits, cache = tfm.decode_step(p, fed[s][:, None].to(dev), cache,
                                            LM_CHECK_TOKENS + s, cfg)
            out.append(logits[:, 0].cpu())
        runs[dev] = (out, kv.cpu(), cache.cpu())
    (oc, kc, cc), (oh, kh, ch) = runs["cuda"], runs["cpu"]
    texts = [lm_compare(f"lm (a) {arch} prefill logits", oc[0], oh[0],
                        failures),
             lm_compare("prefill caches", kc, kh, failures),
             lm_compare(f"{LM_CHECK_STEPS} decode steps' logits",
                        torch.stack(oc[1:]), torch.stack(oh[1:]), failures),
             lm_compare("final cache", cc, ch, failures)]
    decided = flips = 0
    for a, b in zip(oc, oh):
        top = torch.topk(b, 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > LM_MARGIN
        decided += int(sure.sum())
        flips += int((sure & (a.argmax(-1) != b.argmax(-1))).sum())
    if flips:
        failures.append(f"lm (a) {arch}: {flips} greedy tokens differ where "
                        f"the CPU's top-2 margin exceeds {LM_MARGIN}")
    print(f"{'; '.join(texts)}; greedy tokens equal at {decided - flips} of "
          f"{decided} positions whose CPU top-2 margin exceeds {LM_MARGIN} "
          f"(of {2 * (LM_CHECK_STEPS + 1)}); {cfg.n_layers} of "
          f"{lm_config(arch).n_layers} layers, full width, weights drawn on "
          f"the CPU in {init_s:.1f} s")


def lm_weight_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def lm_prefill_ops(cfg, S: int) -> int:
    """Multiply-adds x 2 a prefill of S tokens needs: projections, the
    causal half of the scores and values, the router and the top_k
    experts of each token (or the dense FFN), and the last token's head."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = 2 * S * d * (2 * hq + 2 * hkv) * dh + 4 * hq * dh * S * (S + 1) // 2
    if cfg.moe:
        ff = 2 * S * d * cfg.moe.num_experts \
            + 6 * S * cfg.moe.top_k * d * cfg.moe.d_ff
    else:
        ff = 6 * S * d * cfg.d_ff
    return cfg.n_layers * (attn + ff) + 2 * d * cfg.vocab


def lm_timed(fn, times):
    """``fn`` timed between two synchronisations into ``times``."""
    import torch

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return timed


def lm_serve_run(params, cfg, reqs, slots, max_new, cache_cap) -> dict:
    """One ``continuous_batching_loop`` on the card with the counts zeroed
    just before it and read just after; ``tfm.prefill`` and
    ``decode_step`` are timed (synchronised) around the loop's calls."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    pre, dec = [], []
    real = (tfm.prefill, tfm.decode_step)
    tfm.prefill, tfm.decode_step = lm_timed(real[0], pre), \
        lm_timed(real[1], dec)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        results, stats = serve.continuous_batching_loop(
            params, cfg, reqs, slots, max_new, cache_cap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = zoo_counts()
    finally:
        tfm.prefill, tfm.decode_step = real
    return {"results": results, "stats": stats, "wall": wall,
            "prefill": pre, "decode": dec, "counts": counts,
            "peak": torch.cuda.max_memory_allocated()}


def lm_serve_line(label, params, cfg, run, slots, cache_cap, prompt) -> str:
    """The serve run's numbers, each time beside its bound (decode: the
    weights, but for the unused embedding rows, and the cache read once
    at 3.35 TB/s; prefill: the larger of the same weights and the prompt's
    cache written, and its operations at float32's 67 TFLOP/s)."""
    st = run["stats"]
    per_token = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head * 4
    cache = per_token * slots * cache_cap
    weights = lm_weight_bytes(params) - params["embed"].numel() * 4
    bound = (weights + slots * cfg.d_model * 4 + cache) \
        / HBM_BYTES_PER_S * 1e3
    dec_ms = float(np.median(run["decode"])) * 1e3
    pre_ms = float(np.median(run["prefill"])) * 1e3
    pre_bytes = (weights + prompt * (cfg.d_model * 4 + per_token)) \
        / HBM_BYTES_PER_S * 1e3
    pre_ops = lm_prefill_ops(cfg, prompt) / CUDA_CORE_OPS_PER_S * 1e3
    pre_bound, pre_by = max((pre_bytes, "bytes"), (pre_ops, "operations"))
    tok_s = st.busy_steps / sum(run["decode"])
    return (f"lm {label}: {len(run['results'])} requests of {prompt} tokens "
            f"over {slots} slots in {run['wall']:.3f} s; prefill "
            f"{pre_ms:.4f} ms a request (median of {len(run['prefill'])}; "
            f"bound {pre_bound:.4f} ms by {pre_by}); decode "
            f"{dec_ms:.4f} ms a step (median of {st.decode_steps}; bound "
            f"{bound:.4f} ms by bytes: {weights / 1e9:.3f} GB of weights + "
            f"{cache / 1e9:.3f} GB of cache), {tok_s:.1f} tokens/s "
            f"(bound {slots / bound * 1e3:.1f} with every lane busy); bubble "
            f"ratio {st.bubble_ratio:.4f}; peak memory "
            f"{run['peak'] / 2**30:.3f} GiB; launches embedding_bag "
            f"{run['counts']['embedding_bag']} segment_sum "
            f"{run['counts']['segment_sum']}")


def lm_requests(cfg, n, length, seed):
    import torch
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.integers(0, cfg.vocab, length),
                            dtype=torch.int32, device="cuda")
            for _ in range(n)]


def lm_profile(label, params, cfg, slots, cache_cap, pos, step_ms) -> None:
    """``torch.profiler`` over LM_PROFILED decode steps (after one
    untraced): device busy time and launches a step, the top kernels; the
    busy share of ``step_ms``, the serve run's untraced median step (the
    profiler slows the host several times over)."""
    import torch

    from repro_torch.models import transformer as tfm
    cache = tfm.make_kv_cache(cfg, slots, cache_cap, torch.float32,
                              device="cuda")
    tok = torch.zeros((slots, 1), dtype=torch.int32, device="cuda")
    tfm.decode_step(params, tok, cache, pos, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with device_trace() as prof:
        for _ in range(LM_PROFILED):
            logits, cache = tfm.decode_step(params, tok, cache, pos, cfg)
            tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / LM_PROFILED
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3 / LM_PROFILED
    top = "; ".join(f"{k[:48]} {us / 1e3 / LM_PROFILED:.3f} ms "
                    f"x{n / LM_PROFILED:g}" for us, n, k in rows[:6])
    print(f"lm {label} decode profile: device busy {busy:.4f} ms a step, "
          f"{busy / step_ms:.4f} of the untraced {step_ms:.4f} ms step "
          f"({wall:.4f} ms traced), "
          f"{sum(r[1] for r in rows) / LM_PROFILED:.0f} device launches a "
          f"step; top: {top}")


def lm_serve_cell(label, params, cfg, failures, runs) -> dict:
    """(b)/(e): LM_SERVE's requests served ``runs`` times (all bit-
    identical), the first run's numbers printed, a profile; returns the
    first run's launches."""
    s = LM_SERVE
    reqs = lm_requests(cfg, s["requests"], s["prompt"], 2)
    cap = s["prompt"] + s["max_new"] + 2
    out = [lm_serve_run(params, cfg, reqs, s["slots"], s["max_new"], cap)
           for _ in range(runs)]
    print(lm_serve_line(label, params, cfg, out[0], s["slots"], cap,
                        s["prompt"]))
    st = out[0]["stats"]
    kernels = ("embedding_bag", "segment_sum") if cfg.moe \
        else ("embedding_bag",)
    if st.completed != s["requests"] or \
            min(out[0]["counts"][k] for k in kernels) <= 0:
        failures.append(f"lm {label}: {st.completed} requests completed, "
                        f"launches {out[0]['counts']}")
    for r in out[1:]:
        same = r["results"] == out[0]["results"] and \
            dataclasses.asdict(r["stats"]) == dataclasses.asdict(st)
        print(f"lm {label}: run 2 {r['wall']:.3f} s, tokens and ServeStats "
              f"{'bit-identical' if same else 'DIFFER'} ({st})")
        if not same:
            failures.append(f"lm {label}: two serve runs differ")
    lm_profile(label, params, cfg, s["slots"], cap, s["prompt"],
               float(np.median(out[0]["decode"])) * 1e3)
    return out[0]["counts"]


def lm_decode_vs_forward(label, params, cfg, seq, failures) -> None:
    """(c)/(e): a decode step after a prefill of ``seq`` tokens (2
    sequences) against the full forward of the ``seq + 1`` tokens (the
    plain path: ``seq + 1`` is no multiple of the blocks), and the
    prefill's logits against the forward's at position ``seq - 1``; at a
    capacity that drops no token (``lm_no_drop``)."""
    import torch

    from repro_torch.models import transformer as tfm
    cfg = lm_no_drop(cfg)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, seq + 1)), dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    logits_p, kv = tfm.prefill(params, toks[:, :seq], cfg)
    cache = tfm.make_kv_cache(cfg, 2, seq + 2, torch.float32, device="cuda")
    cache[:, :, :, :seq] = kv
    del kv
    logits_d, _ = tfm.decode_step(params, toks[:, seq:], cache, seq, cfg)
    del cache
    x, _ = tfm.forward(params, toks, dataclasses.replace(
        cfg, chunk_threshold=seq + 2))
    full = (x[:, -2:] @ params["lm_head"]).float()
    del x
    torch.cuda.synchronize()
    path = "chunked" if seq >= cfg.chunk_threshold else "full"
    dec = lm_compare(f"lm {label} decode at {seq} vs forward of {seq + 1}",
                     logits_d[:, 0], full[:, 1], failures)
    pre = lm_compare(f"{path} prefill of {seq} vs the forward",
                     logits_p[:, 0], full[:, 0], failures)
    print(f"{dec}; {pre} ({time.perf_counter() - t0:.1f} s)")


def lm_long(params, cfg, failures) -> dict:
    """(c) two requests of LM_LONG-token prompts served (the chunked
    prefill), then the decode-vs-forward check at LM_LONG."""
    reqs = lm_requests(cfg, 2, LM_LONG, 4)
    cap = LM_LONG + LM_LONG_NEW + 2
    run = lm_serve_run(params, cfg, reqs, 2, LM_LONG_NEW, cap)
    print(lm_serve_line(f"granite_moe long ({LM_LONG}, chunked prefill at "
                        f"{cfg.q_block} blocks)", params, cfg, run, 2, cap,
                        LM_LONG))
    lm_decode_vs_forward("granite_moe", params, cfg, LM_LONG, failures)
    return run["counts"]


def lm_prefill_32k(params, cfg, failures) -> dict:
    """(d) one prefill at ``prefill_32k``'s sequence length at batch 1,
    at the config's blocks and at twice them; returns the launches of
    both."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    S = get_arch("granite_moe").SHAPES["prefill_32k"].dims["seq_len"]
    if S != LM_PREFILL_32K:   # lm_widths checked the kernels at this length
        raise AssertionError(f"prefill_32k is {S} tokens, not "
                             f"{LM_PREFILL_32K}")
    toks = lm_requests(cfg, 1, S, 5)[0][None, :]
    launched = {"embedding_bag": 0, "segment_sum": 0}
    logits, texts = {}, []
    bound = lm_prefill_ops(cfg, S) / CUDA_CORE_OPS_PER_S * 1e3
    for blk in LM_BLOCKS:
        c = dataclasses.replace(cfg, q_block=blk, kv_block=blk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        out, kv = tfm.prefill(params, toks, c)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = zoo_counts()
        for k in launched:
            launched[k] += counts[k]
        logits[blk] = out
        texts.append(f"{blk} blocks {ms:.1f} ms (peak memory "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
                     f"launches {counts})")
        del kv
    err = lm_compare(f"{LM_BLOCKS[0]} vs {LM_BLOCKS[1]} blocks' logits",
                     logits[LM_BLOCKS[0]][0], logits[LM_BLOCKS[1]][0],
                     failures)
    print(f"lm granite_moe prefill_32k (batch 1, {S} tokens): "
          f"{'; '.join(texts)}; bound {bound:.1f} ms by operations; {err}")
    return launched


def lm_draw(arch):
    """``arch`` FULL at float32 drawn on the card from seed 0: its config
    and parameters; prints the draw's time and peak memory (the weights
    and one layer's draws)."""
    import torch

    from repro_torch.core.rng import seeded_generator
    from repro_torch.models import transformer as tfm
    cfg = lm_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tfm.init_params(seeded_generator(0, "cuda"), cfg)
    torch.cuda.synchronize()
    print(f"lm {arch} FULL: {cfg.param_count() / 1e9:.3f} B parameters, "
          f"{lm_weight_bytes(params) / 1e9:.2f} GB at float32, drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s, peak memory of the "
          f"draw {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB")
    return cfg, params


def run_lm() -> dict:
    """Phase 11: the LM serving slice at full width; returns the kernels'
    launches summed over the serve runs and the 32k prefills (the
    comparisons' launches are not counted)."""
    import torch

    from repro_torch.configs import get_arch
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lm: float32 matmuls must run at 'highest' "
                             "precision (no TF32)")
    launched = {"embedding_bag": 0, "segment_sum": 0}
    failures = []

    def add(counts):
        for k in launched:
            launched[k] += counts[k]
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            with timed("lm widths"):
                lm_widths()
            with timed("lm (a)"):
                for arch in ("granite_moe", "deepseek_7b"):
                    lm_card_vs_cpu(arch, failures)
            cfg, params = lm_draw("granite_moe")
            with timed("lm (b)"):
                add(lm_serve_cell("granite_moe serve", params, cfg, failures,
                                  2))
            with timed("lm (c)"):
                add(lm_long(params, cfg, failures))
            with timed("lm (d)"):
                add(lm_prefill_32k(params, cfg, failures))
            del params
            torch.cuda.empty_cache()
            cfg, params = lm_draw("deepseek_7b")
            with timed("lm (e)"):
                add(lm_serve_cell("deepseek_7b serve", params, cfg, failures,
                                  1))
                lm_decode_vs_forward("deepseek_7b", params, cfg, LM_SHORT,
                                     failures)
            del params
            torch.cuda.empty_cache()
            for arch in ("minitron_8b", "stablelm_12b"):
                lm_draw(arch)
                torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    phi = get_arch("phi35_moe").FULL
    print(f"lm phi35_moe FULL: not run: {phi.param_count() / 1e9:.1f} B "
          f"parameters are {phi.param_count() * 4 / 1e9:.1f} GB at float32 "
          f"({phi.param_count() * 2 / 1e9:.1f} GB even in bfloat16), more "
          f"than the card's {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    if failures:
        raise AssertionError("lm: " + "; ".join(failures))
    print(f"lm launches over the phase's runs: {launched} ({card_line()})")
    return launched


# ---------------------------------------------------------------- phase 12
#
# The language-model training slice (``launch.train.make_lm_step``: the
# gradient of ``transformer.train_loss``, each layer rematerialised under
# ``torch.utils.checkpoint``, then AdamW in place) at full width in
# float32, the dtype the reference's launcher forces.  The token embedding
# and the MoE's dispatch gather on the embedding-bag kernel and their
# gradients sum on the segment-sum kernel; the MoE's combine the other way
# round.

LMT_SEQ = 4_096                  # train_4k's sequence length
# Batches tried in turn, the first that fits taken.  4 fits too (AdamW
# keeps at most two temporaries of a leaf), but its ~9 s steps would take
# the script past its time limit on a slow host; 5 and more are untried.
LMT_BATCHES = (3, 2, 1)
LMT_STEPS = 4                    # steps a run; two runs, bit-identical
LMT_CHECK_LAYERS = 2             # card vs CPU and remat on/off: depth cut
LMT_CHECK_SEQ = 512              # ... and sequence length (one sequence)
LMT_DEEPSEEK_LAYERS = 12         # deepseek_7b's depth cut (30 do not fit)
# Card vs CPU: the loss within the CPU tests' rtol (1e-5) and every
# gradient leaf within a relative norm error of their gradient rtol
# (1e-3): the same float32 function, its sums in other orders.
LMT_LOSS_RTOL = 1e-5
LMT_GRAD_NORM = 1e-3
LMT_PIPE = (4, 8, 4, 16)         # stages, microbatches, rows, width
LMT_PODS = 2                     # the compressed reduction's pods
LMT_CROSSPOD_STEPS = 3           # its steps of error feedback
# GPipe over granite_moe FULL: 32 layers as 4 stages of 8, 8 microbatches
# of 1 x 512 tokens (train_4k's 4,096 cut in depth), forward only, the
# stages in 1, 2 and 4 groups.
LMT_PIPE_STAGES = 4
LMT_PIPE_MICRO = 8
LMT_PIPE_SEQ = 512
LMT_PIPE_GROUPS = (1, 2, 4)
LMT_MEASURED = {}   # granite_moe FULL's run 1, for phase 13


def lmt_batch(cfg, B, seq, step, device="cuda"):
    """``data.pipeline.lm_batch``'s Zipf tokens and labels on ``device``."""
    from repro_torch.data import pipeline as datapipe
    dcfg = datapipe.TokenPipelineConfig(cfg.vocab, seq, B)
    return datapipe.to_device(datapipe.lm_batch(dcfg, step), device)


def lmt_layer_ops(cfg, B, S) -> int:
    """Multiply-adds x 2 of one layer's forward as the code computes it:
    the projections, the chunked attention's causal tiles (the Q block's
    KV blocks up to its last position) or the full S x S scores, the
    router and all E·C rows of the experts' buffers (padding included)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    T = B * S
    proj = 2 * T * d * (2 * hq + 2 * hkv) * dh
    if S >= cfg.chunk_threshold:
        qb = min(cfg.q_block, S)
        nq = S // qb
        pairs = B * qb * min(cfg.kv_block, S) * sum(
            -(-((i + 1) * qb) // min(cfg.kv_block, S)) for i in range(nq))
    else:
        pairs = B * S * S
    attn = 4 * hq * dh * pairs
    if cfg.moe:
        m = cfg.moe
        C = max(1, int(np.ceil(m.capacity_factor * m.top_k * T
                               / m.padded_experts)))
        ff = 2 * T * d * m.num_experts \
            + 6 * m.padded_experts * C * d * m.d_ff
    else:
        ff = 6 * T * d * cfg.d_ff
    return proj + attn + ff


def lmt_step_ops(cfg, B, S) -> int:
    """A training step's operations: each layer's forward three times and
    its backward at twice a forward with remat (forward, the recompute, the
    backward; two without), the head and loss's forward and backward."""
    per = 4 if cfg.remat else 3
    head = 3 * 2 * B * S * cfg.d_model * cfg.vocab
    return cfg.n_layers * per * lmt_layer_ops(cfg, B, S) + head


def lmt_step_bytes(params) -> int:
    """AdamW's bytes a step: parameters, gradients and both moments read,
    parameters and moments written (float32)."""
    return 7 * lm_weight_bytes(params)


def lmt_routes(fn):
    """``fn()`` with ``moe._route`` spied: returns its result and, for each
    call, the experts chosen (on the CPU) and the smallest gap between a
    token's K-th and (K+1)-th router probability."""
    import torch

    from repro_torch.models import moe
    real, seen = moe._route, []

    def spy(params, x, cfg):
        probs, gates, experts, C = real(params, x, cfg)
        top = torch.topk(probs.detach(), cfg.top_k + 1, dim=-1).values
        seen.append((experts.cpu(), float((top[:, -2] - top[:, -1]).min())))
        return probs, gates, experts, C
    moe._route = spy
    try:
        out = fn()
    finally:
        moe._route = real
    return out, seen


def lmt_card_vs_cpu(failures) -> None:
    """granite_moe FULL cut to LMT_CHECK_LAYERS layers and one sequence of
    LMT_CHECK_SEQ tokens: the same weights (drawn on the CPU) on both
    devices, the loss and every gradient leaf; the routing compared; then
    remat off on the card, bit-identical to remat on."""
    import torch

    from repro_torch.checkpoint.checkpointer import flatten_with_paths
    from repro_torch.core.rng import seeded_generator
    from repro_torch.models import transformer as tfm
    cfg = lm_config("granite_moe", n_layers=LMT_CHECK_LAYERS)
    t0 = time.perf_counter()
    p_cpu = tfm.init_params(seeded_generator(0), cfg, device="cpu")
    p_card = tree_map(lambda x: x.cuda(), p_cpu)
    batch = lmt_batch(cfg, 1, LMT_CHECK_SEQ, 0, "cpu")

    def grads(p, c, dev):
        b = tuple(x.to(dev) for x in batch)
        return lmt_routes(lambda: zoo_loss_grads(
            lambda q, bb: tfm.train_loss(q, *bb, c), p, b))
    (lh, gh), rh = grads(p_cpu, cfg, "cpu")
    (lc, gc_), rc = grads(p_card, cfg, "cuda")
    (lo, go), _ = grads(p_card, dataclasses.replace(cfg, remat=False), "cuda")
    paths = [p for p, _ in flatten_with_paths(p_cpu)]
    norms = [norm_error(a, b) for a, b in zip(gc_, gh)]
    worst = int(np.nanargmax(norms))
    r_loss = abs(float(lc) - float(lh)) / abs(float(lh))
    moved = sum(int((a != b).any(-1).sum()) for (a, _), (b, _) in zip(rc, rh))
    margin = min(m for _, m in rh)
    remat_same = torch.equal(lc, lo) and all(torch.equal(a, b)
                                             for a, b in zip(gc_, go))
    print(f"lmt card vs CPU: granite_moe FULL width, {cfg.n_layers} of "
          f"{lm_config('granite_moe').n_layers} layers, 1 x {LMT_CHECK_SEQ} "
          f"tokens: loss {float(lc):.8g} card, {float(lh):.8g} CPU (relative "
          f"error {r_loss:.3g}, tolerance {LMT_LOSS_RTOL:g}); gradient leaves' "
          f"norm errors up to {norms[worst]:.3g} ({paths[worst]}; tolerance "
          f"{LMT_GRAD_NORM:g}); {len(rc)} routings, tokens routed "
          f"differently {moved} (smallest CPU gap between the K-th and "
          f"K+1-th probability {margin:.3g}); remat on vs off on the card: "
          f"{'bit-identical' if remat_same else 'DIFFER'} "
          f"({time.perf_counter() - t0:.1f} s)")
    bad = [f"{p} {e:.3g}" for p, e in zip(paths, norms)
           if not e <= LMT_GRAD_NORM]
    if not r_loss <= LMT_LOSS_RTOL or bad:
        failures.append(f"lmt card vs CPU: loss {r_loss:.3g}, leaves {bad}")
    if moved:
        failures.append(f"lmt card vs CPU: {moved} tokens routed to other "
                        f"experts (smallest CPU gap {margin:.3g})")
    if not remat_same:
        failures.append("lmt: remat on and off give other gradients")


def lmt_run(cfg, B, label):
    """``cfg`` drawn on the card from seed 0, then LMT_STEPS steps of
    ``make_lm_step`` on ``lm_batch``'s steps 0.. with the launch counts
    zeroed just before and read just after; returns the run's record
    (the state is kept for the caller)."""
    import torch

    from repro_torch.core.rng import seeded_generator
    from repro_torch.launch.train import make_lm_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tfm.init_params(seeded_generator(0, "cuda"), cfg)
    state = (params, adamw.init_state(params))
    del params
    step = make_lm_step(cfg, adamw.AdamWConfig(total_steps=LMT_STEPS,
                                               warmup_steps=1))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    setup_bytes = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, dts = [], []
    for s in range(LMT_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, lmt_batch(cfg, B, LMT_SEQ, s))
        losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    return {"state": state, "step": step, "losses": losses, "dts": dts,
            "counts": zoo_counts(), "draw_s": draw_s, "label": label,
            "peak": torch.cuda.max_memory_allocated(),
            "setup_bytes": setup_bytes}


def lmt_fit(cfg):
    """The first of LMT_BATCHES whose run of LMT_STEPS steps fits on the
    card (a run that runs out of memory is dropped whole); returns (B, the
    run)."""
    import gc

    import torch
    for B in LMT_BATCHES:
        run = None
        try:
            run = lmt_run(cfg, B, "run 1")
        except torch.cuda.OutOfMemoryError:
            pass
        if run is not None:
            return B, run
        gc.collect()
        torch.cuda.empty_cache()
        print(f"lmt {cfg.name}: batch {B} x {LMT_SEQ} runs out of the card's "
              f"memory")
    raise AssertionError(f"lmt {cfg.name}: not even batch 1 fits")


def lmt_host_copy(tree) -> list:
    """Every leaf of ``tree`` copied into pinned host memory (the card
    cannot hold a second copy of the weights beside a run's state)."""
    import torch
    out = []
    for x in tree_leaves(tree):
        out.append(torch.empty(x.shape, dtype=x.dtype, pin_memory=True))
        out[-1].copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    return out


def lmt_profile(run, batch, B, step_ms) -> float:
    """One more step on ``batch``, traced: device busy ms over the untraced
    median step; prints the top kernels and returns the busy share."""
    import torch
    with device_trace() as prof:
        run["state"], _ = run["step"](run["state"], batch)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    top = "; ".join(f"{k[:48]} {us / 1e3:.3f} ms x{n:g}"
                    for us, n, k in rows[:6])
    print(f"lmt profile (batch {B}): device busy {busy:.4f} ms of the "
          f"untraced {step_ms:.4f} ms step, share {busy / step_ms:.4f}; "
          f"{sum(r[1] for r in rows)} device launches a step; top: {top}")
    return busy / step_ms


def lmt_line(cfg, B, run, params) -> str:
    ms = float(np.median(run["dts"][1:])) * 1e3
    ops = lmt_step_ops(cfg, B, LMT_SEQ)
    by = max((ops / CUDA_CORE_OPS_PER_S * 1e3, "operations"),
             (lmt_step_bytes(params) / HBM_BYTES_PER_S * 1e3, "bytes"))
    return (f"{cfg.n_layers} layers, batch {B} x {LMT_SEQ} tokens: "
            f"{ms:.1f} ms a step (median of steps 2-{LMT_STEPS}; step 1 "
            f"{run['dts'][0] * 1e3:.1f} ms), bound {by[0]:.1f} ms by "
            f"{by[1]} ({ops / 1e12:.2f} TFLOP at 67 TFLOP/s float32), "
            f"{B * LMT_SEQ / ms * 1e3:.0f} tokens/s; losses "
            f"{', '.join(f'{x:.6f}' for x in run['losses'])}; peak memory "
            f"{run['peak'] / 2**30:.3f} GiB; launches embedding_bag "
            f"{run['counts']['embedding_bag']} segment_sum "
            f"{run['counts']['segment_sum']}; drawn in {run['draw_s']:.1f} s")


def lmt_granite(failures, add) -> int:
    """granite_moe FULL (32 layers) trained at the largest batch of
    LMT_BATCHES that fits: two runs of LMT_STEPS steps from the seed,
    losses and final parameters bit-identical; a traced step; returns the
    batch."""
    import torch
    from repro_torch.configs import get_arch
    cfg = lm_config("granite_moe")
    shape = get_arch("granite_moe").SHAPES["train_4k"].dims
    if shape["seq_len"] != LMT_SEQ:
        raise AssertionError(f"train_4k is {shape['seq_len']} tokens, not "
                             f"{LMT_SEQ}")
    B, run = lmt_fit(cfg)
    add(run["counts"])
    LMT_MEASURED.update(cfg=cfg, batch=B, setup_bytes=run["setup_bytes"],
                        leaves=len(tree_leaves(run["state"])),
                        ms=float(np.median(run["dts"][1:])) * 1e3)
    params = run["state"][0]
    print(f"lmt granite_moe FULL ({cfg.param_count() / 1e9:.3f} B "
          f"parameters; weights, gradients and two AdamW moments "
          f"{16 * cfg.param_count() / 1e9:.1f} GB at float32): train_4k's "
          f"global batch {shape['global_batch']} cut to {B} (the first of "
          f"{LMT_BATCHES} that fits one card; larger batches would take the "
          f"script past its time limit); run 1: "
          f"{lmt_line(cfg, B, run, params)}")
    first = lmt_host_copy(params)
    losses = run["losses"]
    del run, params
    torch.cuda.empty_cache()
    run = lmt_run(cfg, B, "run 2")
    add(run["counts"])
    same = run["losses"] == losses and all(
        torch.equal(a, b.to(a.device, non_blocking=True))
        for a, b in zip(tree_leaves(run["state"][0]), first))
    print(f"lmt granite_moe run 2: {lmt_line(cfg, B, run, run['state'][0])}; "
          f"losses and final parameters "
          f"{'bit-identical' if same else 'DIFFER'} to run 1's")
    if not same:
        failures.append("lmt granite_moe: two runs from the seed differ")
    if not all(np.isfinite(losses)):
        failures.append(f"lmt granite_moe: losses {losses}")
    del first
    with timed("lmt profile"):
        lmt_profile(run, lmt_batch(cfg, B, LMT_SEQ, LMT_STEPS), B,
                    float(np.median(run["dts"][1:])) * 1e3)
    del run
    torch.cuda.empty_cache()
    return B


def lmt_deepseek(failures, add) -> None:
    """deepseek_7b at full width with its depth cut to LMT_DEEPSEEK_LAYERS
    (30 layers' weights, gradients and moments are 110 GB): one run of
    LMT_STEPS steps at batch 1."""
    import torch
    full = lm_config("deepseek_7b")
    cfg = lm_config("deepseek_7b", n_layers=LMT_DEEPSEEK_LAYERS)
    run = lmt_run(cfg, 1, "run 1")
    add(run["counts"])
    print(f"lmt deepseek_7b FULL width, depth cut: the 30 layers' weights, "
          f"gradients and moments are {16 * full.param_count() / 1e9:.1f} GB "
          f"at float32, above the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; "
          f"{LMT_DEEPSEEK_LAYERS} layers are "
          f"{16 * cfg.param_count() / 1e9:.1f} GB: "
          f"{lmt_line(cfg, 1, run, run['state'][0])}")
    if not all(np.isfinite(run["losses"])):
        failures.append(f"lmt deepseek_7b: losses {run['losses']}")
    del run
    torch.cuda.empty_cache()


def lmt_widths(B) -> None:
    """Both kernels at every shape a counted granite_moe step gives them
    (T = B x LMT_SEQ tokens, a 49,155 x 1,536 table, K = 8 of 40 experts,
    E·C expert rows), bit-equal to their plain versions on CPU copies: the
    token embedding (a gather of the batch's Zipf tokens) and its gradient
    (their sum into the table's rows; token 0 alone takes about a quarter
    of them); the dispatch gather of T·K token rows and its gradient, the
    combine's sum of T·K rows into T (the same shapes); the combine's
    gather of E·C expert rows and its gradient, a sum of T·K rows into
    E·C."""
    import torch

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    cfg = lm_config("granite_moe")
    m, d = cfg.moe, cfg.d_model
    T = B * LMT_SEQ
    C = max(1, int(np.ceil(m.capacity_factor * m.top_k * T / m.num_experts)))
    gen = torch.Generator(device="cuda").manual_seed(14)
    cpu_gen = torch.Generator().manual_seed(14)
    toks = lmt_batch(cfg, B, LMT_SEQ, 0, "cpu")[0].reshape(-1)
    tok = torch.arange(T, dtype=torch.int32).repeat_interleave(m.top_k)[
        torch.randperm(T * m.top_k, generator=cpu_gen)]
    slot = torch.randint(0, m.num_experts * C, (T * m.top_k,),
                         generator=cpu_gen, dtype=torch.int32)
    texts = []
    t0 = time.perf_counter()
    for what, ids, rows in (("token embedding", toks, cfg.vocab),
                            ("dispatch / combine", tok, T),
                            ("combine gather", slot, m.num_experts * C)):
        table = torch.randn((rows, d), generator=gen, device="cuda")
        got = embedding_bag(ids[:, None].cuda(), table).cpu()
        if not torch.equal(got, embedding_bag_ref(ids[:, None],
                                                  table.cpu())):
            raise AssertionError(f"lmt widths: embedding_bag ({what}) "
                                 "differs from its plain version")
        del table
        grad = torch.randn((ids.numel(), d), generator=gen, device="cuda")
        got = segment_sum(grad, ids.cuda(), rows).cpu()
        if not torch.equal(got, segment_sum_ref(grad.cpu(), ids, rows)):
            raise AssertionError(f"lmt widths: segment_sum ({what}) differs "
                                 "from its plain version")
        del grad, got
        texts.append(f"{what}: {ids.numel()} rows of {rows} x {d} "
                     f"(longest segment {longest_segment(ids)})")
    print(f"lmt widths (batch {B}): {'; '.join(texts)}: both kernels "
          f"bit-equal to their plain versions "
          f"({time.perf_counter() - t0:.1f} s)")


def lmt_substrate(failures) -> None:
    """``pipeline_apply`` at LMT_PIPE against the stages applied in turn
    (the reference test's atol 1e-5)."""
    import torch

    from repro_torch.distributed import pipeline
    from repro_torch.runtime import elastic
    P, M, mb, D = LMT_PIPE
    g = torch.Generator().manual_seed(15)
    ws = (torch.randn((P, D, D), generator=g) * 0.3).cuda()
    xs = torch.randn((M, mb, D), generator=g).cuda()

    def stage(w, x):
        return torch.tanh(x @ w)
    mesh = elastic.build_mesh((P,), ("pipe",), devices=["cuda:0"])
    out = pipeline.pipeline_apply(stage, ws, xs, mesh)
    seq = xs
    for i in range(P):
        seq = stage(ws[i], seq)
    err = float((out - seq).abs().max())
    if not (out.shape == seq.shape and err <= 1e-5):
        failures.append(f"lmt pipeline: max |diff| {err:.3g} > 1e-5")
    print(f"lmt pipeline_apply P={P} M={M} ({mb} x {D}): max |diff| to the "
          f"stages in turn {err:.3g} (atol 1e-5), bubble "
          f"{pipeline.gpipe_bubble_fraction(P, M):.4f}")


def lmt_crosspod(layer_shapes, failures, runs, card="cuda:0") -> None:
    """``crosspod_psum_compressed`` over LMT_PODS pods of one granite_moe
    FULL layer's leaves (``layer_shapes``: (shape, dtype) a leaf; the
    gradients drawn on the CPU from a seed), LMT_CROSSPOD_STEPS steps of
    error feedback: the
    stacked call on the CPU and on ``card``, and the pods in groups for
    each ``runs`` entry (label, devices: one a group), each reduced
    gradient and error bit-equal to the stacked call's on the card."""
    import torch

    from repro_torch.distributed import Mesh
    from repro_torch.optim import grad_compression as gcomp
    gen = torch.Generator().manual_seed(16)
    grads = [torch.randn((LMT_PODS, *shape), generator=gen).to(dtype)
             for shape, dtype in layer_shapes]
    n = sum(x[0].numel() for x in grads)

    def run(devices):
        G = len(devices)
        mesh = Mesh(LMT_PODS, devices, "pod")
        g = [[b.to(d) for b, d in zip(x.chunk(G), devices)] for x in grads]
        if G == 1:
            g = [x[0] for x in g]
        e = gcomp.init_error_state(g)
        sync_all()
        t0 = time.perf_counter()
        for _ in range(LMT_CROSSPOD_STEPS):
            red, e = gcomp.crosspod_psum_compressed(g, e, "pod", mesh=mesh)
        sync_all()
        dt = (time.perf_counter() - t0) / LMT_CROSSPOD_STEPS
        join = (lambda x: x.cpu()) if G == 1 else \
            (lambda x: torch.cat([b.cpu() for b in x]))
        return [join(x) for x in red + e], dt
    t0 = time.perf_counter()
    cpu, _ = run([torch.device("cpu")])
    cpu_s = time.perf_counter() - t0
    stacked, card_ms = run([torch.device(card)])
    same_cpu = all(torch.equal(a, b) for a, b in zip(stacked, cpu))
    texts = [f"stacked on {card} {card_ms * 1e3:.3f} ms a step, "
             f"{'==' if same_cpu else '!='} CPU bit for bit ({cpu_s:.1f} s "
             f"on the CPU)"]
    if not same_cpu:
        failures.append("lmt crosspod_psum_compressed: card != CPU")
    for label, devices in runs:
        got, dt = run(devices)
        same = all(torch.equal(a, b) for a, b in zip(got, stacked))
        texts.append(f"{label} {dt * 1e3:.3f} ms a step, "
                     f"{'==' if same else '!='} stacked")
        if not same:
            failures.append(f"lmt crosspod_psum_compressed {label}: differs "
                            "from the stacked call")
    print(f"lmt crosspod_psum_compressed: one granite_moe FULL layer's "
          f"{len(grads)} leaves over {LMT_PODS} pods ({n} elements a pod, "
          f"{n} B of int8 payload against {4 * n} at float32), "
          f"{LMT_CROSSPOD_STEPS} steps of error feedback: "
          f"{'; '.join(texts)} ({card_line()})")


def sync_all() -> None:
    """Wait for every visible card (``torch.cuda.synchronize()`` waits for
    the current one only)."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def lmt_pipe_stage(cfg):
    """One GPipe stage of the transformer: ``_block`` over its layers in
    turn on hidden states at positions 0..S-1."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm

    def stage(layers, x):
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for lp in L.tree_unstack(layers):
            x = tfm._block(cfg, x, positions, lp)[0]
        return x
    return stage


def lmt_pipe_draw():
    """granite_moe FULL drawn on cuda:0 from seed 0: its layers as
    LMT_PIPE_STAGES stages (views of the stacked leaves), LMT_PIPE_MICRO
    microbatches of 1 x LMT_PIPE_SEQ Zipf tokens (``lm_batch``'s) as
    hidden states after the token embedding, and the leaves' (shape,
    dtype) of one layer."""
    import torch

    from repro_torch.core.rng import seeded_generator
    from repro_torch.models import transformer as tfm
    cfg = lm_config("granite_moe")
    t0 = time.perf_counter()
    params = tfm.init_params(seeded_generator(0, "cuda"), cfg)
    P = LMT_PIPE_STAGES
    stacked = tree_map(lambda a: a.reshape(P, -1, *a.shape[1:]),
                       params["layers"])
    toks = lmt_batch(cfg, LMT_PIPE_MICRO, LMT_PIPE_SEQ, 0)[0]
    with torch.no_grad():
        xs = tfm._embed(params["embed"], toks)[:, None]
    shapes = [(tuple(a.shape[1:]), a.dtype)
              for a in tree_leaves(params["layers"])]
    del params
    torch.cuda.synchronize()
    print(f"lmt pipeline: granite_moe FULL drawn on cuda:0 in "
          f"{time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers as "
          f"{P} stages of {cfg.n_layers // P}; {LMT_PIPE_MICRO} microbatches "
          f"of 1 x {LMT_PIPE_SEQ} tokens as hidden states "
          f"{tuple(xs.shape)} (train_4k's 4,096 tokens cut in depth)")
    return cfg, stacked, xs, shapes


def lmt_pipeline(cfg, stacked, xs, failures, add, runs) -> dict:
    """GPipe over granite_moe FULL's LMT_PIPE_STAGES stages, forward only:
    the stages applied in turn to each microbatch on cuda:0 (the
    comparison, not counted), then ``pipeline_apply`` with the stages in
    groups for each ``runs`` entry (label, devices: one a group; the
    stages placed once with ``place_stages``, each run's launch counts
    zeroed just before it and read just after), each output bit-equal to
    the stages in turn.  A run on a card not used before is run once
    untimed first (the card's first launches load its kernels).  Prints
    ms a tick and each run's launches; returns {label: ms a tick}."""
    import torch

    from repro_torch.distributed import pipeline, place_stages
    from repro_torch.runtime import elastic
    P, M = LMT_PIPE_STAGES, LMT_PIPE_MICRO
    T = M + P - 1
    stage = lmt_pipe_stage(cfg)
    with torch.no_grad():
        t0 = time.perf_counter()
        want = []
        for x in xs:
            for i in range(P):
                x = stage(tree_map(lambda a, i=i: a[i], stacked), x)
            want.append(x)
        want = torch.stack(want)
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
        print(f"lmt pipeline: the {P} stages in turn on {M} microbatches "
              f"on cuda:0: {seq_ms:.1f} ms ({seq_ms / M:.2f} ms a "
              f"microbatch through all stages)")
        out, warm = {}, {xs.device}
        for label, devices in runs:
            mesh = elastic.build_mesh((P,), ("pipe",), devices=devices)
            sync_all()
            t0 = time.perf_counter()
            placed = place_stages(stacked, mesh)
            sync_all()
            place_s = time.perf_counter() - t0
            if not warm.issuperset(devices):
                pipeline.pipeline_apply(stage, placed, xs, mesh)
                warm.update(devices)
            sync_all()
            reset_all_launches()
            t0 = time.perf_counter()
            y = pipeline.pipeline_apply(stage, placed, xs, mesh)
            sync_all()
            ms = (time.perf_counter() - t0) * 1e3
            counts = zoo_counts()
            add(counts)
            same = y.device == devices[-1] and torch.equal(
                y.to(want.device), want)
            out[label] = ms / T
            print(f"lmt pipeline {label}: {ms:.1f} ms for {T} ticks, "
                  f"{ms / T:.2f} ms a tick; launches embedding_bag "
                  f"{counts['embedding_bag']} segment_sum "
                  f"{counts['segment_sum']}; stages placed in "
                  f"{place_s:.2f} s; outputs on {y.device}, "
                  f"{'bit-equal' if same else 'NOT EQUAL'} to the stages "
                  f"in turn; bubble {pipeline.gpipe_bubble_fraction(P, M):.4f}"
                  f" ({P - 1}/{T})")
            if not same:
                failures.append(f"lmt pipeline {label}: differs from the "
                                "stages in turn")
            if (label, devices) in (runs[0], runs[-1]):
                lmt_pipe_profile(stage, placed, xs, mesh, label, ms,
                                 len(set(devices)))
            del placed, y
    return out


def lmt_pipe_profile(stage, placed, xs, mesh, label, ms, cards) -> None:
    """One more run of the pipeline, traced: device busy ms (summed over
    the ``cards`` it ran on) against the untraced run's ``ms`` on each
    card, device launches a tick, the top activities."""
    from repro_torch.distributed import pipeline
    T = LMT_PIPE_MICRO + LMT_PIPE_STAGES - 1
    with device_trace() as prof:
        pipeline.pipeline_apply(stage, placed, xs, mesh)
        sync_all()
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    top = "; ".join(f"{k[:40]} {us / 1e3:.3f} ms x{n:g}"
                    for us, n, k in rows[:4])
    print(f"lmt pipeline profile {label}: device busy {busy:.1f} ms over "
          f"{cards} card(s), share {busy / (ms * cards):.4f} of the "
          f"untraced {ms:.1f} ms on each; {sum(r[1] for r in rows) / T:.0f} "
          f"device launches a tick; top: {top}")


def run_lm_train() -> dict:
    """Phase 12: the LM training slice at full width; returns the kernels'
    launches summed over the counted FULL runs (the comparisons' launches
    are not counted)."""
    import torch
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lmt: float32 matmuls must run at 'highest' "
                             "precision (no TF32)")
    launched = {"embedding_bag": 0, "segment_sum": 0}
    failures = []

    def add(counts):
        for k in launched:
            launched[k] += counts[k]
    torch.use_deterministic_algorithms(True)
    try:
        with timed("lmt card vs CPU"):
            lmt_card_vs_cpu(failures)
        with timed("lmt granite_moe"):
            B = lmt_granite(failures, add)
        with torch.no_grad(), timed("lmt widths"):
            lmt_widths(B)
        with timed("lmt deepseek_7b"):
            lmt_deepseek(failures, add)
        with torch.no_grad(), timed("lmt substrate"):
            lmt_substrate(failures)
            cfg, stacked, xs, shapes = lmt_pipe_draw()
            lmt_pipeline(cfg, stacked, xs, failures, add,
                         [(f"G={G} on cuda:0", on_card0(G))
                          for G in LMT_PIPE_GROUPS])
            del stacked, xs
            torch.cuda.empty_cache()
            lmt_crosspod(shapes, failures,
                         [(f"{LMT_PODS} groups on cuda:0",
                           on_card0(LMT_PODS))])
    finally:
        torch.use_deterministic_algorithms(False)
    if failures:
        raise AssertionError("lmt: " + "; ".join(failures))
    print(f"lmt launches over the phase's FULL runs: {launched} "
          f"({card_line()})")
    return launched


# ---------------------------------------------------------------- phase 13
#
# The dry-run (``launch.dryrun``: the port's steps on ``meta`` tensors,
# counted, over the H100's data-sheet peaks) held against phase 12's
# measured granite_moe step.

DRY_CELLS = 80                   # 40 (arch x shape) cells x 2 meshes
DRY_CELL = ("granite_moe", "train_4k")
DRY_PERF = ("phi35_moe", "decode_32k", "moe.capacity_factor=1.0")
# The sweep's worker processes: one took 98.6 s on an H100 host beside
# the build, past the fused kernel's 67.6 s nvcc; four took 81.9 s
# beside an 89.8 s build on a slower host.
DRY_JOBS = 4
# The dry-run's FLOPs at the cell's global batch of 256, scaled to phase
# 12's batch, against lmt_step_ops: the experts' capacity is a ceil of
# the tokens, so the scaling is exact only where both batches' capacities
# are whole (they are here: C = T/4); 2 % covers a ceil elsewhere.
DRY_FLOP_RTOL = 0.02
DRY_ALLOC_SLACK = 512            # the caching allocator's rounding a leaf


def check_dryrun(out_dir) -> dict:
    """Phase 1: every record of the dry-run's sweep is "ok" with a finite,
    positive roofline (compute, memory and bound; collectives finite and
    at least 0); returns the single mesh's record of DRY_CELL."""
    import glob
    import math
    paths = sorted(glob.glob(os.path.join(out_dir, "*", "*.json")))
    if len(paths) != DRY_CELLS:
        raise AssertionError(f"dryrun: {len(paths)} records, not "
                             f"{DRY_CELLS}")
    bad = []
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        r = rec.get("roofline", {})
        terms = [r.get(k) for k in ("compute_s", "memory_s", "bound_s",
                                    "collective_s")]
        if rec["status"] != "ok" or not all(
                isinstance(x, float) and math.isfinite(x) for x in terms) \
                or min(terms[:3]) <= 0 or terms[3] < 0:
            bad.append(f"{os.path.basename(path)}: {rec.get('error', r)}")
    if bad:
        raise AssertionError("dryrun records: " + "; ".join(bad))
    with open(os.path.join(out_dir, "single",
                           f"{DRY_CELL[0]}__{DRY_CELL[1]}.json")) as f:
        rec = json.load(f)
    r = rec["roofline"]
    print(f"dryrun: {len(paths)} records ok, rooflines finite and positive; "
          f"{DRY_CELL[0]} {DRY_CELL[1]} on {rec['chips']} devices: "
          f"{rec['cost_analysis']['flops']:.6e} FLOP and "
          f"{rec['cost_analysis']['bytes_accessed']:.6e} bytes a device, "
          f"bound {r['bound_s'] * 1e3:.3f} ms by {r['dominant']}")
    return rec


def run_dryrun_vs_card(dry_rec) -> None:
    """Phase 13: the dry-run against phase 12's granite_moe FULL step
    (float32, batch B x 4,096): (a) the sweep's FLOPs for the cell's
    global batch of 256, scaled to B, against ``lmt_step_ops`` within
    DRY_FLOP_RTOL, and the dry-run of the step itself (a one-device mesh,
    batch B) against it exactly; (b) the dry-run's parameter and AdamW
    bytes on the one-device mesh against the card's
    ``torch.cuda.memory_allocated()`` growth over phase 12's setup,
    within the allocator's rounding; (c) the dry-run's roofline of that
    step beside the measured ms, with the card's name and power limit.
    Counts on ``meta``: nothing is launched."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed.mesh import GridMesh
    from repro_torch.launch import dryrun, specs
    m = LMT_MEASURED
    cfg, B = m["cfg"], m["batch"]
    cell = get_arch(DRY_CELL[0]).SHAPES[DRY_CELL[1]]
    gb, seq = cell.dims["global_batch"], cell.dims["seq_len"]
    failures = []
    want = lmt_step_ops(cfg, B, seq)

    def matmul_flops(r):       # lmt_step_ops counts the matrix products
        return r["cost_analysis"]["flops"] - r["kernels"]["flops"]
    scaled = matmul_flops(dry_rec) * dry_rec["chips"] * B / gb
    err = abs(scaled - want) / want
    print(f"dry {DRY_CELL[0]} {DRY_CELL[1]}: FLOPs of matrix products at "
          f"global batch {gb} scaled to {B}: {scaled:.6e}, lmt_step_ops "
          f"{want:.6e}, relative "
          f"error {err:.3e} (tolerance {DRY_FLOP_RTOL})")
    if not err <= DRY_FLOP_RTOL:
        failures.append(f"scaled FLOPs off by {err:.3e}")
    one = GridMesh((1, 1), ("data", "model"), torch.device("meta"))
    step = ShapeCell(DRY_CELL[1], "train", dict(seq_len=seq, global_batch=B))
    over = {"dtype": cfg.dtype}
    rec = dryrun.count_cell(DRY_CELL[0], step, one, False, over)
    flops = matmul_flops(rec)
    print(f"dry {DRY_CELL[0]} at batch {B} on one device: {flops:.6e} FLOP "
          f"of matrix products (and {rec['kernels']['flops']:.6e} of the "
          f"gather and sum kernels, calls {rec['kernels']['calls']}), "
          f"lmt_step_ops {want:.6e} "
          f"({'equal' if flops == want else 'DIFFER'})")
    if flops != want:
        failures.append(f"batch {B}: {flops} FLOP, lmt_step_ops {want}")
    _, args, _, _ = specs.build_cell(DRY_CELL[0], step, one, False,
                                     overrides=over)
    state_bytes = sum(dryrun.argument_bytes(args[i], args.specs[i], one)
                      for i in (0, 1))
    slack = DRY_ALLOC_SLACK * m["leaves"]
    gap = m["setup_bytes"] - state_bytes
    print(f"dry {DRY_CELL[0]} parameters and AdamW state: {state_bytes} "
          f"bytes by the dry-run, {m['setup_bytes']} allocated on the card "
          f"over phase 12's setup (gap {gap} bytes, allowed 0 to {slack}: "
          f"{DRY_ALLOC_SLACK} a leaf)")
    if not 0 <= gap <= slack:
        failures.append(f"state bytes: dry-run {state_bytes}, card "
                        f"{m['setup_bytes']}")
    r = rec["roofline"]
    fp32_ms = rec["cost_analysis"]["flops"] / CUDA_CORE_OPS_PER_S * 1e3
    print(f"dry {DRY_CELL[0]} batch {B} x {seq} roofline on one card: compute "
          f"{r['compute_s'] * 1e3:.3f} ms (at the bfloat16 tensor-core peak), "
          f"memory {r['memory_s'] * 1e3:.3f} ms (bytes before fusion), "
          f"collectives {r['collective_s'] * 1e3:.3f} ms, bound "
          f"{r['bound_s'] * 1e3:.3f} ms by {r['dominant']}; the step runs in "
          f"float32 outside the tensor cores: {fp32_ms:.3f} ms at 67 "
          f"TFLOP/s; measured {m['ms']:.3f} ms a step (phase 12, median), "
          f"{fp32_ms / m['ms']:.4f} of the float32 bound; "
          f"card {card_line()}")
    if not 0 < r["bound_s"] < float("inf"):
        failures.append(f"roofline {r}")
    if failures:
        raise AssertionError("dry run vs the card: " + "; ".join(failures))


# ---------------------------------------------------------------- phase 14
#
# Asynchronous checkpoint writes (``checkpointer.save(..., blocking=False)``
# through ``train_loop.run``'s ``async_checkpoint``) over phase 12's
# granite_moe step at full width, cut in depth: the same run with blocking
# and with asynchronous saves, every checkpoint compared byte for byte.

CKPT_STEPS = 8                   # steps a run
CKPT_EVERY = 4                   # periodic checkpoints after steps 4 and 8
# Phase 12's batch cut to 1 x 4,096 tokens: a checkpoint's bytes (the
# parameters and AdamW moments) do not depend on the batch.
CKPT_BATCH = 1
CKPT_READ = 64 << 20             # bytes a read when two files are compared


def same_files(a, b) -> int:
    """The bytes of directory ``a``'s files if ``b`` holds the same names
    with the same bytes, else -1."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return -1
    n = 0
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            while True:
                x, y = fa.read(CKPT_READ), fb.read(CKPT_READ)
                if x != y:
                    return -1
                if not x:
                    break
                n += len(x)
    return n


def ckpt_run(cfg, params, ckpt_dir, asynchronous) -> dict:
    """``train_loop.run`` over CKPT_STEPS of ``make_lm_step`` from a copy
    of ``params`` (fresh moments), a checkpoint every CKPT_EVERY steps,
    with the launch counts zeroed just before and read just after.  Timers
    the script wraps around ``checkpointer.save`` and ``PendingSave.join``
    record how long each holds the caller; the loop's final save, which
    rewrites the last periodic step, writes under ``final/`` instead so
    that both are kept."""
    import torch

    from repro_torch.launch.train import make_lm_step
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    ckpt = train_loop.checkpointer
    save, join = ckpt.save, ckpt.PendingSave.join
    saves, joins = [], []

    def timed_save(d, step, tree, blocking=True):
        if any(s["step"] == step for s in saves):
            d = os.path.join(d, "final")
        t0 = time.perf_counter()
        out = save(d, step, tree, blocking=blocking)
        saves.append({"step": step, "s": time.perf_counter() - t0,
                      "pinned": getattr(out, "pinned_bytes", 0)})
        return out

    def timed_join(self, timeout=None):
        t0 = time.perf_counter()
        try:
            join(self, timeout)
        finally:
            joins.append(time.perf_counter() - t0)
    state = (tree_map(torch.clone, params), adamw.init_state(params))
    state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    step = make_lm_step(cfg, adamw.AdamWConfig(total_steps=CKPT_STEPS,
                                               warmup_steps=1))
    loop_cfg = train_loop.TrainLoopConfig(
        total_steps=CKPT_STEPS, ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
        log_every=1, async_checkpoint=asynchronous)
    ckpt.save, ckpt.PendingSave.join = timed_save, timed_join
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        state, n, hist, _ = train_loop.run(
            step, state, lambda s: lmt_batch(cfg, CKPT_BATCH, LMT_SEQ, s),
            loop_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = zoo_counts()
    finally:
        ckpt.save, ckpt.PendingSave.join = save, join
    if n != CKPT_STEPS:
        raise AssertionError(f"ckpt: the run stopped at step {n}")
    return {"state": state, "wall": wall, "saves": saves, "joins": joins,
            "state_bytes": state_bytes,
            "dts": [h["dt_s"] for h in hist],
            "losses": [h["loss"] for h in hist], "counts": counts}


def ckpt_line(label, run) -> str:
    """A run's walls: steps 2-8 but the one after a checkpoint, that one,
    what each save and join held the caller, the pinned bytes."""
    dts = run["dts"]
    after = [CKPT_EVERY]          # 0-based: the step after step 4's save
    rest = [d for i, d in enumerate(dts[1:], 1) if i not in after]
    saves = ", ".join(f"step {s['step']}{' (final)' if i == 2 else ''} "
                      f"{s['s'] * 1e3:.1f} ms" for i, s in
                      enumerate(run["saves"]))
    return (f"ckpt {label}: run wall {run['wall']:.3f} s; a step "
            f"{float(np.median(rest)) * 1e3:.2f} ms (median of steps 2-8 "
            f"but 5; step 1 {dts[0] * 1e3:.2f} ms), step 5 (just after step "
            f"4's checkpoint) {dts[CKPT_EVERY] * 1e3:.2f} ms; save held the "
            f"caller: {saves}; joins waited "
            f"{', '.join(f'{j * 1e3:.1f} ms' for j in run['joins']) or '-'};"
            f" pinned {max(s['pinned'] for s in run['saves'])} B; launches "
            f"embedding_bag {run['counts']['embedding_bag']} segment_sum "
            f"{run['counts']['segment_sum']}")


def run_async_checkpoint() -> dict:
    """Phase 14: granite_moe FULL cut to LMT_CHECK_LAYERS layers, drawn on
    the card from seed 0; ``train_loop.run`` from those parameters with
    blocking and with asynchronous saves under deterministic algorithms:
    every file of the checkpoints at steps 4 and 8 (and of the final save)
    byte-equal between the runs, the losses and the final parameters and
    moments bit-equal.  Returns the kernels' launches of both runs."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.rng import seeded_generator
    from repro_torch.models import transformer as tfm
    cfg = lm_config("granite_moe", n_layers=LMT_CHECK_LAYERS)
    root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    failures, runs = [], {}
    torch.use_deterministic_algorithms(True)
    try:
        params = tfm.init_params(seeded_generator(0, "cuda"), cfg)
        print(f"ckpt granite_moe FULL width, {cfg.n_layers} layers "
              f"({cfg.param_count() / 1e9:.3f} B parameters), batch {CKPT_BATCH} x {LMT_SEQ} tokens, "
              f"{CKPT_STEPS} steps, a checkpoint every {CKPT_EVERY}")
        for flag, label in ((False, "blocking"), (True, "async")):
            runs[label] = ckpt_run(cfg, params, os.path.join(root, label),
                                   flag)
            print(ckpt_line(label, runs[label]))
        del params
        launched = {k: sum(r["counts"][k] for r in runs.values())
                    for k in ("embedding_bag", "segment_sum")}
        nbytes = runs["async"]["state_bytes"]
        compared = []
        for sub in (f"step_{CKPT_EVERY:08d}", f"step_{CKPT_STEPS:08d}",
                    f"final/step_{CKPT_STEPS:08d}"):
            n = same_files(os.path.join(root, "blocking", sub),
                           os.path.join(root, "async", sub))
            compared.append(f"{sub} {'byte-equal' if n >= 0 else 'DIFFER'}"
                            f" ({n} B)")
            if n < 0:
                failures.append(f"{sub} differs")
        same = runs["blocking"]["losses"] == runs["async"]["losses"] and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(runs["blocking"]["state"]),
                tree_leaves(runs["async"]["state"]), strict=True))
        if not same:
            failures.append("the final states or the losses differ")
        if not all(np.isfinite(runs["async"]["losses"])):
            failures.append(f"losses {runs['async']['losses']}")
        if runs["async"]["saves"][0]["pinned"] != nbytes:
            failures.append(f"pinned {runs['async']['saves'][0]['pinned']} "
                            f"B for {nbytes} B of state")
        print(f"ckpt blocking vs async ({nbytes / 1e9:.3f} GB of parameters "
              f"and AdamW moments a checkpoint): {'; '.join(compared)}; final "
              f"parameters, moments and losses "
              f"{'bit-identical' if same else 'DIFFER'} ({card_line()})")
    finally:
        torch.use_deterministic_algorithms(False)
        runs.clear()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("ckpt: " + "; ".join(failures))
    return launched


# ------------------------------------------------------------ the launchers
#
# The command-line checks run in processes of their own while phase 1
# builds the fused kernel and the graphs.  They measure nothing and spend
# most of their seconds starting Python and reaching the card, so run
# together there they cost the script little (one after another they
# took about 70 s of it on an H100 host).  Every one has exited before
# phase 2 starts, so none runs beside a measurement.

CLI_TIMEOUT = 300                # seconds a command may take


def cli_chains(tmp) -> tuple[list, list, list]:
    """The checks as chains whose commands run in turn (PNA's resume after
    its first run, the perf line after its own baseline), split into
    those that need no kernel (the verifier's two ``--check`` CLIs, the
    dry-run on ``meta`` tensors), those that launch the embedding-bag,
    segment-sum and walk-step kernels, and those that launch the fused
    kernel too.  A command: (label, arguments after ``python``, strings or
    compiled patterns its standard output must hold, which of its lines to
    print)."""
    def train(arch, steps, resume=False):
        return (f"zoo launcher --arch {arch} --steps {steps}"
                f"{' --resume' if resume else ''}",
                ["-m", "repro_torch.launch.train", "--arch", arch, "--steps",
                 str(steps), "--ckpt-dir", os.path.join(tmp, arch)]
                + (["--resume"] if resume else []),
                [f"done at step {steps}"]
                + ([f"resumed at step {ZOO_LAUNCHER_STEPS}"] if resume else []),
                "last")

    def check(module):
        return [(f"verifier python -m {module} --check",
                 ["-m", module, "--check"], [], "all")]
    # The perf line's baseline is its cell counted apart, so that its chain
    # runs beside the sweep and not after it.
    base = os.path.join(tmp, "perf_baseline")
    sweep = [(f"dryrun -m repro_torch.launch.dryrun --all --mesh both "
              f"--jobs {DRY_JOBS}",
              ["-m", "repro_torch.launch.dryrun", "--all", "--mesh", "both",
               "--jobs", str(DRY_JOBS), "--out", os.path.join(tmp, "dryrun")],
              ["80/80 cells OK"], "last")]
    perf = [(f"dryrun -m repro_torch.launch.dryrun --arch {DRY_PERF[0]} "
             f"--shape {DRY_PERF[1]} --mesh single",
             ["-m", "repro_torch.launch.dryrun", "--arch", DRY_PERF[0],
              "--shape", DRY_PERF[1], "--mesh", "single", "--out", base],
             ["1/1 cells OK"], "last"),
            (f"dryrun -m repro_torch.launch.perf --arch {DRY_PERF[0]} --shape "
             f"{DRY_PERF[1]} --set {DRY_PERF[2]}",
             ["-m", "repro_torch.launch.perf", "--arch", DRY_PERF[0],
              "--shape", DRY_PERF[1], "--tag", "smoke", "--set", DRY_PERF[2],
              "--baseline-dir", base, "--out", os.path.join(tmp, "perf")],
             ["vs baseline bound="], "last")]
    no_kernel = [check("repro_torch.analysis"),
                 check("repro_torch.core.phase_program"), sweep, perf]

    def launched(*names):
        return [re.compile(rf"\b{n}=[1-9]") for n in names]
    # The examples at the reference's default sizes, each as a script: the
    # three on the embedding-bag, segment-sum and walk-step kernels, then
    # the four that launch the fused kernel (run once it is built).
    examples = [(f"example torch_{name}.py {' '.join(args)}".rstrip(),
                 [os.path.join("examples", f"torch_{name}.py"), *args],
                 want, "all") for name, args, want in (
        ("gnn_neighbor_sampling", [],
         ["done"] + launched("embedding_bag", "segment_sum")),
        ("serve_continuous_batching", [],
         ["served 24 requests"] + launched("embedding_bag")),
        ("quickstart", ["--step-impl", "cuda"],
         ["first MetaPath walk"]
         + launched("walk_step_uniform", "walk_step_alias")),
        ("quickstart", ["--step-impl", "fused"],
         ["first MetaPath walk"] + launched("fused_superstep")),
        ("serve_walk_requests", ["--step-impl", "fused"],
         ["tenant B request 4: 64 walks"] + launched("fused_superstep")),
        ("distributed_walks", ["--step-impl", "fused"],
         ["bit-identical to single-device engine: True",
          "drops=0 (must be 0)"] + launched("fused_superstep")),
        ("cached_superstep_smoke", [],
         ["paths/lengths/stats bit-identical", "OK"]
         + launched("hits", "fused_superstep")))]
    kernels = [
        [train("pna", ZOO_LAUNCHER_STEPS),
         train("pna", ZOO_LAUNCHER_STEPS + 2, resume=True)],
        [train("dcn_v2", ZOO_LAUNCHER_STEPS)],
        [("lm launcher -m repro_torch.launch.serve --arch deepseek_7b "
          "(SMOKE, 16 requests)",
          ["-m", "repro_torch.launch.serve", "--arch", "deepseek_7b"],
          ["completed=16", "device=cuda"], "first")],
        [("lmt launcher -m repro_torch.launch.train --arch granite_moe "
          "--device cuda --steps 4",
          ["-m", "repro_torch.launch.train", "--arch", "granite_moe",
           "--device", "cuda", "--steps", "4", "--ckpt-dir",
           os.path.join(tmp, "granite_moe")], ["done at step 4"], "last")],
        examples[:3]]
    return no_kernel, kernels, [examples[3:]]


def run_chain(chain, after=None) -> list:
    """Each command of ``chain`` in turn, until one fails, once the future
    ``after`` (a build) is done: (label, the completed process, seconds,
    wanted strings, lines to print)."""
    if after is not None:
        after.result()
    env = dict(os.environ, PYTHONPATH=SRC)
    done = []
    for label, argv, want, show in chain:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *argv], capture_output=True,
                           text=True, env=env, cwd=ROOT, timeout=CLI_TIMEOUT)
        done.append((label, r, time.perf_counter() - t0, want, show))
        if r.returncode != 0:
            break
    return done


def finish_clis(futures) -> None:
    """Wait for every chain; print each command's line; raise if one
    exited non-zero or printed less than it must."""
    failures = []
    for f in futures:
        for label, r, secs, want, show in f.result():
            if r.returncode != 0 or not all(
                    w.search(r.stdout) if isinstance(w, re.Pattern)
                    else w in r.stdout for w in want):
                failures.append(f"{label}: exit {r.returncode}, wanted "
                                f"{want}\n{r.stdout}\n{r.stderr}")
                continue
            lines = r.stdout.strip().splitlines() or [""]
            text = {"all": " / ".join(lines), "first": lines[0],
                    "last": lines[-1]}[show]
            print(f"{label}: exit 0 in {secs:.1f} s; {text}")
    if failures:
        raise AssertionError("launchers:\n" + "\n".join(failures))


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: run it from the root of a checkout "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    if sys.argv[1:] == ["--across-cards"]:
        return run_across_cards()

    from repro_torch.graph import make_dataset
    from repro_torch.kernels import build

    # Phase 1: build, the graphs and the command-line checks.  The fused
    # kernel's nvcc (the longest) runs beside the other three's; the
    # checks that launch kernels start once those three are built, and
    # the graphs are made while the fused kernel builds.
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    t_run = t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    no_kernel, kernels, fused_chains = cli_chains(tmp)
    with ThreadPoolExecutor(max_workers=len(no_kernel) + len(kernels)
                            + len(fused_chains) + 1) as pool:
        clis = [pool.submit(run_chain, c) for c in no_kernel]
        fused = pool.submit(build.build, ["fused_superstep"])
        secs = build.build([n for n in build.SOURCES
                            if n != "fused_superstep"])
        clis += [pool.submit(run_chain, c) for c in kernels]
        clis += [pool.submit(run_chain, c, fused) for c in fused_chains]
        t1 = time.perf_counter()
        g = make_dataset("WG", weighted=True, with_alias=True,
                         scale_override=WG_SCALE)
        gt = make_dataset("WG", num_edge_types=3, scale_override=WG_SCALE)
        graph_s = time.perf_counter() - t1
        secs.update(fused.result())
        print(f"build: {time.perf_counter() - t0:.2f} s {secs}")
        for lib in build.SOURCES:
            print(f"ptxas {lib}:")
            for line in ptxas_report(build.build_log(lib)):
                print(line)
        print(card_line())
        print_grids()
        print(f"graph WG scale {WG_SCALE}: |V|={g.num_vertices} "
              f"|E|={g.num_edges} max_deg={g.max_degree}; typed (3 edge "
              f"types): |E|={gt.num_edges} max_deg={gt.max_degree}; built "
              f"in {graph_s:.1f} s (beside the fused kernel's build)")
        t1 = time.perf_counter()
        try:
            finish_clis(clis)
            dry_rec = check_dryrun(os.path.join(tmp, "dryrun"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"phase 1 launchers: waited {time.perf_counter() - t1:.1f} s "
              f"for them after the build; phase 1: "
              f"{time.perf_counter() - t0:.1f} s")
    deg = (g.row_ptr[1:] - g.row_ptr[:-1]).double()
    hubs, dangling = deg > 5_000, float((deg == 0).double().mean())
    print(f"WG degrees: dangling share {dangling:.4f}, "
          f"E[d^2]/E[d] {float((deg * deg).sum() / deg.sum()):.1f} (the "
          f"mean degree of a walk's next vertex), {int(hubs.sum())} vertices "
          f"above degree 5,000 holding "
          f"{float(deg[hubs].sum() / deg.sum()):.4f} of the edges")
    graphs = {"urw": g, "ppr": g, "deepwalk": g, "metapath": gt,
              "node2vec": g, "node2vec_w": g}

    starts = np.random.default_rng(0).integers(
        0, g.num_vertices, NUM_STARTS).astype(np.int32)

    def phase(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t:.1f} s")
        return out
    floor = phase("2 launch floor", launch_floor)
    rows = phase("2 walk_step", check_kernels, g, floor)
    rows["fused_superstep"] = phase("2 fused", check_fused, graphs, starts)
    batch = phase("2 SGNS batch", sgns_batch, g)
    rows["embedding_bag"] = phase("2 embedding_bag", check_embedding_bag, g,
                                  batch, floor)
    rows["segment_sum"] = phase("2 segment_sum", check_segment_sum, g, batch)
    del batch
    phase("2 fused from a stream state", check_fused_stream_state, graphs)
    launches = phase("3 main path", run_main_path, graphs, starts)
    launches["fused_superstep"] += phase(
        "3 cached main path", run_cached_main_path, graphs, starts)
    phase("3 profile", profile_supersteps, graphs, starts)
    phase("3 small batch vs CPU", check_small_against_cpu)
    emb_launches = phase("4 embeddings", run_embeddings, g)
    for name in ("fused_superstep", "embedding_bag", "segment_sum"):
        launches[name] = launches.get(name, 0) + emb_launches[name]
    phase("4 resume", check_embeddings_resume)
    phase("4 small run vs CPU", check_embeddings_small_against_cpu)
    for label, fn in (("5 streams", run_streams), ("6 serve", run_service)):
        for name, n in phase(label, fn, graphs).items():
            launches[name] = launches.get(name, 0) + n
    for name, n in phase("7 tune", run_tune, graphs, starts).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in phase("8 sharded", run_sharded, graphs, starts).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in phase("9 verifier", run_verifier, graphs, starts).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in phase("10 zoo", run_zoo, g).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in phase("11 LM serving", run_lm).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in phase("12 LM training", run_lm_train).items():
        launches[name] = launches.get(name, 0) + n
    phase("13 dry run vs the card", run_dryrun_vs_card, dry_rec)
    for name, n in phase("14 async checkpoint", run_async_checkpoint).items():
        launches[name] = launches.get(name, 0) + n
    for name, row in rows.items():
        row["launches"] = launches[name]
        if row["launches"] <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    print(f"total: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
