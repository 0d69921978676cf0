// Fused superstep kernel for Hopper (sm_90a): k whole supersteps of the
// walk engine per launch, in one persistent thread block.
//
// Replaces the TPU kernel
//   repro/kernels/fused_superstep/fused_superstep.py::fused_superstep_kernel
// for its uniform (URW, and PPR with the stop draw), alias (DeepWalk),
// metapath, rejection (unweighted Node2Vec, `_rejection_sample`) and
// reservoir (weighted Node2Vec, `_reservoir_sample`) branches, and the
// gather hierarchy of the hot-vertex cache (`_cached_row_access`, the
// cached gathers of `walk_step.py::cached_gather1_loop` and
// `cached_gather2_loop`) for all five.
//
// Per superstep, as in the reference: a work test; per lane the Threefry
// stop and column draws, row access, the kind's pick, the column gather,
// termination and the path write; the stats; the Theorem VI.1 staging
// controller; the zero-bubble refill ranked by an exclusive prefix count
// of free lanes.  Every result is bit-equal to the plain superstep
// (repro_torch/core/walk_engine.py::_superstep, run by ../ref.py).
//
// What bounds it on the H100: one SM.  Each live lane derives its draws
// in-kernel: 2 Threefry blocks fold query id and hop into the key (a 3rd
// folds an epoch > 0), shared by the lane's draws, then each draw folds
// its salt and runs its block; ~80 int32 ops a block, so 4 blocks (~320
// ops) a lane for URW/DeepWalk/MetaPath and 6 (~480) for PPR, every
// superstep; its memory traffic (a few dependent gathers a lane) is small
// beside that.  The card's bound is its int32 rate, but one block runs on
// one SM, where each thread walks its lanes in turn and every superstep
// ends in about ten block barriers and the refill's dependent loads.
// Measured on an H100 (PERF.md), the time per superstep grows with the
// lanes each thread owns (W / 1024), live or idle, and not with the kind's
// RNG work.  A multi-block design is a later change.
//
// What the design does about it: it keeps the whole machine on the device
// for k supersteps, so a launch replaces the thousands of small tensor ops
// and the per-superstep host sync of the per-hop drain.  Lanes skip all
// work while idle.  Thread t owns a contiguous run of lanes, so lane order
// is (thread, index) order, the order the refill ranks ascend in; each
// thread takes its lanes kChunk at a time and issues all their draws, then
// all their row loads, then the dependent loads, so a chunk's loads are in
// flight together.  Any lane count runs: lane state stays in the state
// tensors themselves, touched only by the owning thread.  Shared memory
// holds the block-wide scalars (queue counters, stats) and the reduction
// and scan scratch; the controller's head history stays in the control
// block in device memory, touched by thread 0 only, since its length
// (the injection delay + 1) is unbounded.  The TPU kernel's double-
// buffered DMA loops and path-write staging slots have no counterpart:
// resident warps hide the gathers and each path record is a plain store.
//
// A lane's `active` byte is 0 (free) or 1 (live) between supersteps; inside
// one it is 2 for a lane that terminated this superstep, until the refill
// gives the lane a new query or frees it, and 3 for a live lane whose row
// is cached, from the cache's resolve pass until its lane pass.
//
// The Node2Vec branches run one lane at a time (process_lane_n2v), since
// their work per lane is a loop whose length is the lane's own: up to K
// rejection rounds, or ceil(deg / CH) reservoir chunks.  Each reads
// N(v_prev) by the lower-bound bisection of samplers.edge_exists (its trip
// count, from the wrapper, and its compares; a halving with lo >= hi
// changes nothing, so the loop stops there).  What bounds them is latency:
// a lane's bisection probes are a chain of dependent loads, and the thread
// whose lanes' neighbor lists sum longest (a hub has 18,507 on the WG
// stand-in) scans them all while the block waits at the superstep's
// barrier.  Measured on an H100 (PERF.md): 25-35 ms a reservoir superstep
// at W = 4096, 0.7-2 us a candidate.  The reservoir takes its candidates
// two at a time, the pair that shares one Threefry block, and bisects
// both together, so two probe chains are in flight.  Splitting a lane's
// scan over a warp or the block is the next step (ROADMAP queue 2 item
// 1f).
//
// The gather hierarchy (a runtime condition, num_hot > 0, so it adds no
// kernel instantiation): the wrapper passes the hot-vertex cache's packed
// block (graph/hot_cache.py: the sorted hot ids, their degrees and row
// offsets, and verbatim copies of their rows' columns and the kind's
// payloads) as one int32 array.  Where it fits beside the kernel's static
// shared memory, the block copies it into dynamic shared memory at the
// start of each launch, the counterpart of the TPU kernel's VMEM; a larger
// block is read in place in device memory.  Each superstep starts with two
// passes over a thread's lanes: (1) every lane, idle or not, atomicMin's
// (lane << 32 | vv) into slot vv mod W of a W-word tag table,
// vv = clamp(v_curr, 0, V-1), so the slot keeps its smallest lane, the
// lane the reference's reverse-order fill leaves there; a barrier; (2)
// each lane reads its slot's word: it follows if that lane is another with
// the same vv, else leads; it probes the sorted hot ids (lower-bound
// bisection, the reference's _cache_probe) and writes its slot or -1 to
// the cslot scratch; live lanes count hits and misses (leaders) and
// coalesced (followers), summed over the warp and added to the block's
// stats with shared-memory atomics, so no barrier; a live lane whose probe
// hit is marked kCachedLive.  A thread resets its own range of the table
// in the refill pass, after the superstep's barriers, so the table never
// goes stale within or across launches: one barrier a superstep more than
// without a cache.  Row access and every gather keyed on v_curr (the
// column, the alias probe, the typed row, the rejection proposal, the
// reservoir's candidates and weights) read the block for a cached lane, at
// offsets clamped into [0, P-1]; a follower has its leader's vertex and so
// its own probe gives the same slot.  The bisection of N(v_prev) always
// reads device memory.  The block is a verbatim copy, so a cached read
// returns what the graph holds: only the three counters differ from the
// uncached run.  What bounds it, measured on an H100 (PERF.md): the passes
// run on every lane each superstep, and a block staged in shared memory
// takes the SM's L1 from the lane state and the gathers, so where few
// lanes hit (under 1% on the WG stand-in) a cached launch is slower than
// an uncached one, and a 213 KB block staged is slower than a 1 MiB block
// read in place.
//
// Registers: __launch_bounds__(1024, 1) allows 64 a thread, and the
// 4-lane pass of the alias kind and the reservoir's pair scan sit at or
// near it.  So a cached lane is not live to the uncached lane pass, which
// is the kernel without a cache; a second loop then runs each cached lane
// through the same pass compiled for its tier (kShared: the block at a
// constant shared-memory address; kGlobal: the block in device memory).
// The cache's loops are not unrolled and the table's reset rides in the
// refill loop: each of these choices removed spills that ptxas reported
// for some instantiation (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "walk_common.cuh"

// The cache's packed block, staged here when it fits (cache_words > 0).
extern __shared__ int4 s_block[];

namespace {

using walk::clampi;
using walk::uniform_index;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunk = 4;           // lanes a thread carries through a pass
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind {
  kUniform = 0, kAlias = 1, kMetapath = 2, kRejection = 3, kReservoir = 4
};

// Control block layout (ops.py): int64 words.
constexpr int kCtlWork = 0;
constexpr int kCtlSupersteps = 1;
constexpr int kCtlHead = 2;
constexpr int kCtlStaged = 3;
constexpr int kCtlTail = 4;
constexpr int kCtlStats = 5;
constexpr int kNumStats = 12;
constexpr int kCtlHist = kCtlStats + kNumStats;

// WalkStats field order.
enum Stat {
  kSteps = 0, kSlotSteps, kBubbles, kStarved, kTerminations, kSupersteps,
  kRouteWaits, kDrops, kLaunches, kCacheHits, kCacheMisses, kCacheCoalesced
};

constexpr uint8_t kFree = 0, kLive = 1, kEnded = 2, kCachedLive = 3;

struct Args {
  int* v_curr;
  int* v_prev;
  int* query_id;
  int* hop;
  uint8_t* active;
  int* epoch;
  const int* q_start;
  const int* q_order;
  const int* q_epoch;
  uint8_t* done;
  int* lengths;
  int* paths;
  long long* ctl;
  const int* row_ptr;
  const int* col;
  const float* alias_prob;
  const int* alias_idx;
  const int* type_offsets;
  const int* schedule;
  const float* weights;   // may be null: every edge weighs 1.0
  int width;
  int num_queries;
  int max_hops;
  int num_vertices;
  int num_edges;
  int type_stride;     // T + 1: the row length of type_offsets
  int schedule_len;
  int delay;
  int k;
  long long depth;
  uint2 key;
  float stop_prob;
  float inv_p;          // Node2Vec 1/p, 1/q and max(1/p, 1, 1/q), each
  float inv_q;          // rounded once to float32 on the host
  float w_max;
  int rounds;           // rejection rounds K
  int chunk;            // reservoir chunk CH
  int bisect_iters;     // samplers.bisect_iters(max_degree)
  // The hot-vertex cache: its packed block is hot_ids (H words), hot_deg
  // (H), hot_off (H + 1), col (P) at word c_col = 3H + 1, then weights,
  // alias_prob, alias_idx (P each, floats as their bits) and type_offsets
  // (H rows of type_stride) at their offsets, -1 where absent.
  const int* cache;     // the block in device memory; unused when H == 0
  unsigned long long* tags;   // (W,) scratch: the tag table
  int* cslot;           // (W,) scratch: each lane's cache slot, or -1
  int num_hot;          // H; 0: no cache
  int cache_entries;    // P
  int probe_trips;      // HotVertexCache.probe_trips
  int cache_words;      // words staged into shared memory; 0: read in place
  int c_col;
  int c_wgt;
  int c_prob;
  int c_alias;
  int c_toff;
};

// The lane passes' tiers: kGraph reads the graph, kShared and kGlobal
// read the cache's block, staged in shared memory or in place.
constexpr int kGraph = 0, kShared = 1, kGlobal = 2;

// Where the cache's block is read from in tier kTier.
template <int kTier>
__device__ __forceinline__ const int* cache_base(const Args& a) {
  return kTier == kShared ? reinterpret_cast<const int*>(s_block) : a.cache;
}

// Lower-bound bisection of vv in the sorted hot ids (_cache_probe): the
// cache slot of vv, or -1.  A halving with lo >= hi changes nothing, so the
// loop stops there.
__device__ __forceinline__ int cache_probe(const Args& a, const int* cb,
                                           int vv) {
  int lo = 0, hi = a.num_hot;
  for (int it = 0; it < a.probe_trips && lo < hi; ++it) {
    const int mid = (lo + hi) >> 1;
    if (cb[mid] < vv) lo = mid + 1;
    else hi = mid;
  }
  return lo < a.num_hot && cb[lo] == vv ? lo : -1;
}

// Sum over the block, returned to every thread.  Every thread calls it.
__device__ int block_sum(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  __syncthreads();   // the scratch's previous readers are done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) total += scratch[w];
  return total;
}

// Exclusive prefix sum over the threads in thread order; the block's total
// goes to *total.  Every thread calls it.
__device__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    sum += s;
  }
  *total = sum;
  return before + x - v;
}

// Live lanes among [lo, hi).
__device__ int count_live(const uint8_t* active, int lo, int hi) {
  int n = 0;
  for (int i = lo; i < hi; ++i) n += active[i] == kLive;
  return n;
}

// Gather hierarchy, pass 1: lanes [lo, hi) claim their tag slots.  Every
// thread calls it, and a barrier follows before cache_resolve.
__device__ __forceinline__ void cache_fill(const Args& a, int lo, int hi) {
#pragma unroll 1
  for (int i = lo; i < hi; ++i) {
    const int vv = clampi(a.v_curr[i], 0, a.num_vertices - 1);
    atomicMin(a.tags + vv % a.width,
              static_cast<unsigned long long>(i) << 32 |
                  static_cast<unsigned>(vv));
  }
}

// Gather hierarchy, pass 2: lanes [lo, hi) resolve leader or follower,
// probe the cache and write their slot to cslot; the live ones' hits,
// misses (leaders) and coalesced (followers) go to the block's stats, and
// a live lane whose row is cached is marked kCachedLive, for the cached
// lane pass.  Every thread calls it (a warp sum).
template <int kTier>
__device__ __forceinline__ void cache_resolve(const Args& a, int lo, int hi,
                                              long long* stats) {
  const int* cb = cache_base<kTier>(a);
  unsigned hits = 0, misses = 0, coalesced = 0;
#pragma unroll 1
  for (int i = lo; i < hi; ++i) {
    const int vv = clampi(a.v_curr[i], 0, a.num_vertices - 1);
    const unsigned long long tag = __ldcg(a.tags + vv % a.width);
    const bool follower = static_cast<int>(tag >> 32) != i &&
                          static_cast<int>(tag & 0xffffffffu) == vv;
    const int cs = cache_probe(a, cb, vv);
    a.cslot[i] = cs;
    if (a.active[i] == kLive) {
      coalesced += follower;
      hits += !follower && cs >= 0;
      misses += !follower && cs < 0;
      if (cs >= 0) a.active[i] = kCachedLive;
    }
  }
  hits = __reduce_add_sync(kFullMask, hits);
  misses = __reduce_add_sync(kFullMask, misses);
  coalesced = __reduce_add_sync(kFullMask, coalesced);
  if ((threadIdx.x & 31) == 0) {
    using u64 = unsigned long long;
    auto* st = reinterpret_cast<u64*>(stats);
    atomicAdd(st + kCacheHits, static_cast<u64>(hits));
    atomicAdd(st + kCacheMisses, static_cast<u64>(misses));
    atomicAdd(st + kCacheCoalesced, static_cast<u64>(coalesced));
  }
}

// Terminate and advance lane i after its pick: write the hop and its path
// record if it advances, mark it ended if it stops, dead-ends or reaches
// max_hops, and count both.
template <bool kRecord>
__device__ __forceinline__ void finish_lane(const Args& a, int i, int v, int h,
                                            int q, bool stop, bool ok, int nxt,
                                            int* n_steps, int* n_term) {
  const bool adv = !stop && ok;
  const int nh = adv ? h + 1 : h;
  const bool term = stop || !ok || nh >= a.max_hops;
  if (adv) {
    a.v_prev[i] = v;
    a.v_curr[i] = nxt;
    a.hop[i] = nh;
    if (kRecord) {
      a.lengths[q] = nh + 1;
      a.paths[q * (static_cast<long long>(a.max_hops) + 1) + nh] = nxt;
    }
  }
  if (term) {
    a.done[q] = 1;
    a.active[i] = kEnded;
  }
  *n_steps += adv;
  *n_term += term;
}

// One pass over up to kN of this thread's lanes, starting at `base`:
// draws, row access, pick, column gather, terminate and advance.  Adds the
// chunk's advancing and terminating lanes to *n_steps and *n_term.  In
// tier kGraph the pass reads the graph (a cached lane, kCachedLive, is not
// live to it); in tier kShared or kGlobal every lane of the pass is cached
// (its cslot is >= 0): row access and the v_curr-keyed gathers read the
// cache's block, the lane's addr being an offset into the block's packed
// rows, and gathers clamp into [0, P-1].
template <int kKind, bool kStop, bool kRecord, int kN, int kTier>
__device__ __forceinline__ void process_chunk(const Args& a, int base, int hi,
                                              int* n_steps, int* n_term) {
  constexpr bool kHit = kTier != kGraph;
  bool live[kN], stop[kN];
  int v[kN], h[kN], q[kN], addr[kN], deg[kN];
  int idx[kN], nxt[kN];
  float u0[kN], u1[kN];

  // Draws: the stop draw (counter (0,0), word 0) and the column draw
  // (counter (0,0) word 0; alias: counter (0,1), words 0 and 1).
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int i = base + j;
    live[j] = i < hi && a.active[i] == kLive;
    stop[j] = false;
    if (!live[j]) continue;
    v[j] = a.v_curr[i];
    h[j] = a.hop[i];
    q[j] = a.query_id[i];
    const uint2 pk = walk::task_prefix(a.key, q[j], h[j], a.epoch[i]);
    if (kStop) {
      const uint2 sk = walk::fold_in(pk, walk::kSaltStop);
      const uint2 y = walk::threefry2x32(sk.x, sk.y, 0u, 0u);
      stop[j] = walk::bits_to_uniform(y.x) < a.stop_prob;
    }
    const uint2 ck = walk::fold_in(pk, walk::kSaltColumn);
    const uint2 y = walk::threefry2x32(ck.x, ck.y, 0u,
                                       kKind == kAlias ? 1u : 0u);
    u0[j] = walk::bits_to_uniform(y.x);
    u1[j] = kKind == kAlias ? walk::bits_to_uniform(y.y) : 0.0f;
  }

  // Row access: the clamped vertex's (addr, deg); deg 0 out of range.
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    addr[j] = 0;
    deg[j] = 0;
    if (!live[j] || a.num_vertices <= 0) continue;
    const bool valid = v[j] >= 0 && v[j] < a.num_vertices;
    if (kHit) {   // the directory: hot_deg at word H, hot_off at 2H
      const int cs = a.cslot[base + j];
      addr[j] = cache_base<kTier>(a)[2 * a.num_hot + cs];
      deg[j] = valid ? cache_base<kTier>(a)[a.num_hot + cs] : 0;
      continue;
    }
    const int vc = clampi(v[j], 0, a.num_vertices - 1);
    addr[j] = __ldg(a.row_ptr + vc);
    const int end = __ldg(a.row_ptr + vc + 1);
    deg[j] = valid ? end - addr[j] : 0;
  }

  // Pick: the neighbor offset idx (before the column clamp).
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    idx[j] = addr[j];
    if (!live[j] || deg[j] <= 0) continue;
    if (kKind == kMetapath) {
      // Sub-segment of the scheduled type; none -> dead end.
      const int t = __ldg(a.schedule + h[j] % a.schedule_len);
      int lo, cnt;
      if (kHit) {
        const int* row = cache_base<kTier>(a) + a.c_toff +
                         a.cslot[base + j] * a.type_stride;
        lo = row[t];
        cnt = row[t + 1] - lo;
      } else {
        const long long row =
            static_cast<long long>(clampi(v[j], 0, a.num_vertices - 1)) *
            a.type_stride;
        lo = __ldg(a.type_offsets + row + t);
        cnt = __ldg(a.type_offsets + row + t + 1) - lo;
      }
      idx[j] = addr[j] + lo + uniform_index(cnt, u0[j]);
      if (cnt <= 0) deg[j] = 0;
    } else if (kKind == kAlias) {
      // Keep draw k with probability prob[addr+k], else take alias[addr+k].
      float p;
      int al;
      const int kdraw = uniform_index(deg[j], u0[j]);
      if (kHit) {
        const int e = clampi(addr[j] + kdraw, 0, a.cache_entries - 1);
        p = __int_as_float(cache_base<kTier>(a)[a.c_prob + e]);
        al = cache_base<kTier>(a)[a.c_alias + e];
      } else {
        if (a.num_edges <= 0) continue;
        const int e = clampi(addr[j] + kdraw, 0, a.num_edges - 1);
        p = __ldg(a.alias_prob + e);
        al = __ldg(a.alias_idx + e);
      }
      const int pick = u1[j] < p ? kdraw : al;
      idx[j] = addr[j] + clampi(pick, 0, max(deg[j] - 1, 0));
    } else {
      idx[j] = addr[j] + uniform_index(deg[j], u0[j]);
    }
  }

  // Column access, clamped into [0, E-1] (cached: [0, P-1]); no read when
  // E == 0.
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    nxt[j] = -1;
    if (!live[j] || deg[j] <= 0) continue;
    if (kHit)
      nxt[j] = cache_base<kTier>(a)[a.c_col + clampi(idx[j], 0, a.cache_entries - 1)];
    else if (a.num_edges > 0)
      nxt[j] = __ldg(a.col + clampi(idx[j], 0, a.num_edges - 1));
  }

  // Terminate and advance.
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (live[j])
      finish_lane<kRecord>(a, base + j, v[j], h[j], q[j], stop[j], deg[j] > 0,
                           nxt[j], n_steps, n_term);
  }
}

// Runs pass(i) for each cached lane i (kCachedLive) of [lo, hi), marked
// live again first, in the block's tier: fn.template go<kTier>(i).
template <typename Fn>
__device__ __forceinline__ void for_cached_lanes(const Args& a, int lo, int hi,
                                                 const Fn& fn) {
  if (a.cache_words == 0) {
#pragma unroll 1
    for (int i = lo; i < hi; ++i)
      if (a.active[i] == kCachedLive) {
        a.active[i] = kLive;
        fn.template go<kGlobal>(i);
      }
  } else {
#pragma unroll 1
    for (int i = lo; i < hi; ++i)
      if (a.active[i] == kCachedLive) {
        a.active[i] = kLive;
        fn.template go<kShared>(i);
      }
  }
}

// One lane of a first-order kind through process_chunk in tier kTier (the
// pass for_cached_lanes runs).
template <int kKind, bool kStop, bool kRecord>
struct ChunkPass {
  const Args& a;
  int* n_steps;
  int* n_term;
  template <int kTier>
  __device__ __forceinline__ void go(int i) const {
    process_chunk<kKind, kStop, kRecord, 1, kTier>(a, i, i + 1, n_steps,
                                                   n_term);
  }
};

// Lower-bound bisection of N candidates in the sorted list col[plo, phi),
// as samplers.edge_exists runs it: at most `iters` halvings, a halving
// changing nothing once lo >= hi, so the loop ends when every candidate's
// range is empty.  found[n] is the membership test at the lower bound.  The
// N chains advance together, so their loads are in flight together.
template <int N>
__device__ __forceinline__ void bisect(const Args& a, int plo, int phi,
                                       const int (&y)[N], bool (&found)[N]) {
  int lo[N], hi[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    lo[n] = plo;
    hi[n] = phi;
  }
  for (int it = 0; it < a.bisect_iters; ++it) {
    bool any = false;
#pragma unroll
    for (int n = 0; n < N; ++n) any |= lo[n] < hi[n];
    if (!any) break;
    int probe[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int mid = lo[n] + ((hi[n] - lo[n]) >> 1);   // (lo + hi) / 2
      probe[n] = lo[n] < hi[n] ? __ldg(a.col + mid) : 0;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (lo[n] >= hi[n]) continue;
      const int mid = lo[n] + ((hi[n] - lo[n]) >> 1);
      if (probe[n] < y[n]) lo[n] = mid + 1;
      else hi[n] = mid;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    found[n] = lo[n] < phi && __ldg(a.col + lo[n]) == y[n];
}

// The Node2Vec bias of candidate y (samplers.n2v_bias): 1 at hop 0
// (vp < 0), 1/p on a return to vp, 1 for a neighbor of vp, 1/q otherwise.
__device__ __forceinline__ float n2v_bias(const Args& a, int vp, int y,
                                          bool common) {
  return vp < 0 ? 1.0f : (y == vp ? a.inv_p : (common ? 1.0f : a.inv_q));
}

// Rejection (samplers.rejection_choose over phase_program's csr gather):
// round j draws (u_col, u_acc) from counter (j, j + K) under the
// SALT_COLUMN key, the layout of task_uniforms(..., 2K, SALT_COLUMN);
// proposes col[addr + floor(u_col * deg)]; accepts iff u_acc * w_max <= w
// (one float32 product).  The last round is forced and the first accepted
// round wins, so the loop ends there.  Returns the chosen column.  In tier
// kShared or kGlobal the proposals read the cache's packed row at addr.
template <int kTier>
__device__ __forceinline__ int rejection_pick(const Args& a, uint2 pk,
                                              int addr, int deg, int vp,
                                              int plo, int phi) {
  const uint2 ck = walk::fold_in(pk, walk::kSaltColumn);
  int y[1] = {-1};
  for (int j = 0; j < a.rounds; ++j) {
    const uint2 r = walk::threefry2x32(ck.x, ck.y, static_cast<uint32_t>(j),
                                       static_cast<uint32_t>(j + a.rounds));
    const int prop = uniform_index(deg, walk::bits_to_uniform(r.x));
    y[0] = kTier != kGraph ? cache_base<kTier>(a)[a.c_col + clampi(addr + prop, 0,
                                                 a.cache_entries - 1)]
                : __ldg(a.col + clampi(addr + prop, 0, a.num_edges - 1));
    if (j == a.rounds - 1) break;
    bool common[1] = {false};
    if (vp >= 0 && y[0] != vp) bisect<1>(a, plo, phi, y, common);
    const float w = n2v_bias(a, vp, y[0], common[0]);
    if (__fmul_rn(walk::bits_to_uniform(r.y), a.w_max) <= w) break;
  }
  return y[0];
}

// Reservoir (phase_program.reservoir_scan): chunk c of CH candidates draws
// at salt SALT_CHUNK0 + c, draws t and t + pairs (pairs = (CH + 1) / 2)
// sharing counter (t, t + pairs) as in rng.key_bits(CH); candidate
// position p = c * CH + t < deg has weight w = w_edge * bias and E-S key
// log(u + 1e-20) / w where w > 0, else -inf, in IEEE float32 (logf, no
// fast math) as torch computes it on the card.  The reference keeps the
// first position of the largest key (first argmax within a chunk, strict
// > across chunks); candidates here come in pair order, so a key equal to
// the best takes its place only from a lower position, which keeps the
// same one.  Returns the chosen offset, clipped into [0, deg - 1].  In tier
// kShared or kGlobal the candidates and their weights read the cache's
// packed row at addr.
template <int kTier>
__device__ __forceinline__ int reservoir_pick(const Args& a, uint2 pk,
                                              int addr, int deg, int vp,
                                              int plo, int phi) {
  const int pairs = (a.chunk + 1) / 2;
  const float neg_inf = __uint_as_float(0xff800000u);
  float best_key = neg_inf;
  int best = 0;
  for (int base = 0, c = 0; base < deg; base += a.chunk, ++c) {
    const uint2 dk = walk::fold_in(pk, walk::kSaltChunk0 + c);
    const int n_valid = min(a.chunk, deg - base);
    for (int b = 0; b < pairs && b < n_valid; ++b) {
      const int t[2] = {b, b + pairs};
      const bool valid[2] = {true, b + pairs < n_valid};
      const uint2 r = walk::threefry2x32(
          dk.x, dk.y, static_cast<uint32_t>(b),
          b + pairs < a.chunk ? static_cast<uint32_t>(b + pairs) : 0u);
      const float u[2] = {walk::bits_to_uniform(r.x),
                          walk::bits_to_uniform(r.y)};
      int y[2];
      float w_edge[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        y[n] = -1;
        w_edge[n] = 0.0f;
        if (!valid[n]) continue;
        if (kTier != kGraph) {   // the row's packed columns and weights
          const int* cb = cache_base<kTier>(a);
          const int e = clampi(addr + base + t[n], 0, a.cache_entries - 1);
          y[n] = cb[a.c_col + e];
          w_edge[n] = a.c_wgt >= 0 ? __int_as_float(cb[a.c_wgt + e]) : 1.0f;
        } else {
          const int e = clampi(addr + base + t[n], 0, a.num_edges - 1);
          y[n] = __ldg(a.col + e);
          w_edge[n] = a.weights ? __ldg(a.weights + e) : 1.0f;
        }
      }
      bool common[2] = {false, false};
      if (vp >= 0) bisect<2>(a, plo, phi, y, common);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (!valid[n]) continue;
        const float w = __fmul_rn(w_edge[n], n2v_bias(a, vp, y[n], common[n]));
        const float key =
            w > 0.0f ? __fdiv_rn(logf(__fadd_rn(u[n], 1e-20f)), w) : neg_inf;
        const int pos = base + t[n];
        if (key > best_key || (key == best_key && pos < best)) {
          best_key = key;
          best = pos;
        }
      }
    }
  }
  return clampi(best, 0, max(deg - 1, 0));
}

// One lane of a Node2Vec kind: the stop draw, row access, the kind's pick
// (for a live lane, not stopped, with deg > 0), the column, and the
// advance.  In tier kShared or kGlobal the lane is cached (its cslot is
// >= 0), and its row access and v_curr-keyed gathers read the cache's
// block.
template <int kKind, bool kStop, bool kRecord, int kTier>
__device__ __forceinline__ void process_lane_n2v(const Args& a, int i,
                                                 int* n_steps, int* n_term);

// One lane of a Node2Vec kind in tier kTier (the pass for_cached_lanes
// runs).
template <int kKind, bool kStop, bool kRecord>
struct LanePassN2V {
  const Args& a;
  int* n_steps;
  int* n_term;
  template <int kTier>
  __device__ __forceinline__ void go(int i) const {
    process_lane_n2v<kKind, kStop, kRecord, kTier>(a, i, n_steps, n_term);
  }
};

template <int kKind, bool kStop, bool kRecord, int kTier>
__device__ __forceinline__ void process_lane_n2v(const Args& a, int i,
                                                 int* n_steps, int* n_term) {
  constexpr bool kHit = kTier != kGraph;
  if (a.active[i] != kLive) return;
  const int v = a.v_curr[i];
  const int h = a.hop[i];
  const int q = a.query_id[i];
  const uint2 pk = walk::task_prefix(a.key, q, h, a.epoch[i]);
  bool stop = false;
  if (kStop) {
    const uint2 sk = walk::fold_in(pk, walk::kSaltStop);
    stop = walk::bits_to_uniform(walk::threefry2x32(sk.x, sk.y, 0u, 0u).x) <
           a.stop_prob;
  }
  int addr = 0, deg = 0;
  if (a.num_vertices > 0) {
    const bool valid = v >= 0 && v < a.num_vertices;
    if (kHit) {   // the directory: hot_deg at word H, hot_off at 2H
      const int cs = a.cslot[i];
      addr = cache_base<kTier>(a)[2 * a.num_hot + cs];
      deg = valid ? cache_base<kTier>(a)[a.num_hot + cs] : 0;
    } else {
      const int vc = clampi(v, 0, a.num_vertices - 1);
      addr = __ldg(a.row_ptr + vc);
      const int end = __ldg(a.row_ptr + vc + 1);
      deg = valid ? end - addr : 0;
    }
  }
  int nxt = -1;
  if (!stop && deg > 0 && a.num_edges > 0) {
    const int vp = a.v_prev[i];
    const int vpc = clampi(vp, 0, a.num_vertices - 1);
    const int plo = __ldg(a.row_ptr + vpc);
    const int phi = __ldg(a.row_ptr + vpc + 1);
    if (kKind == kRejection) {
      nxt = rejection_pick<kTier>(a, pk, addr, deg, vp, plo, phi);
    } else {
      const int idx = reservoir_pick<kTier>(a, pk, addr, deg, vp, plo, phi);
      nxt = kHit ? cache_base<kTier>(a)[a.c_col + clampi(addr + idx, 0,
                                                  a.cache_entries - 1)]
                 : __ldg(a.col + clampi(addr + idx, 0, a.num_edges - 1));
    }
  }
  finish_lane<kRecord>(a, i, v, h, q, stop, deg > 0, nxt, n_steps, n_term);
}

template <int kKind, bool kStop, bool kRecord, bool kStatic>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_superstep_kernel(const Args a) {
  __shared__ long long s_stats[kNumStats];
  __shared__ long long s_head, s_staged, s_tail;
  __shared__ int s_scratch[kMaxWarps];

  const int tid = threadIdx.x;
  const long long per = (a.width + blockDim.x - 1) / blockDim.x;
  const int lo = static_cast<int>(min(tid * per, static_cast<long long>(a.width)));
  const int hi = static_cast<int>(min(lo + per, static_cast<long long>(a.width)));

  if (tid == 0) {
    for (int s = 0; s < kNumStats; ++s) s_stats[s] = a.ctl[kCtlStats + s];
    s_stats[kLaunches] += 1;   // once per launch, work or not
    s_head = a.ctl[kCtlHead];
    s_staged = a.ctl[kCtlStaged];
    s_tail = a.ctl[kCtlTail];
  }
  if (a.num_hot > 0) {
    // Stage the cache's block into shared memory (16 bytes a load where
    // it fits), and empty this thread's range of the tag table.
    if (a.cache_words > 0) {
      const int n4 = a.cache_words / 4;
      const int4* src = reinterpret_cast<const int4*>(a.cache);
      for (int w = tid; w < n4; w += blockDim.x) s_block[w] = src[w];
      int* dst = reinterpret_cast<int*>(s_block);
      for (int w = 4 * n4 + tid; w < a.cache_words; w += blockDim.x)
        dst[w] = a.cache[w];
    }
#pragma unroll 1
    for (int i = lo; i < hi; ++i) __stcg(a.tags + i, ~0ull);
  }
  int n_active = block_sum(count_live(a.active, lo, hi), s_scratch);

  for (int step = 0; step < a.k; ++step) {
    if (!(s_head < s_tail || n_active > 0)) break;   // block-uniform: no work

    if (a.num_hot > 0) {   // block-uniform
      cache_fill(a, lo, hi);
      __syncthreads();
      if (a.cache_words == 0)
        cache_resolve<kGlobal>(a, lo, hi, s_stats);
      else
        cache_resolve<kShared>(a, lo, hi, s_stats);
    }

    // The lanes, uncached then cached (one loop after the other, so the
    // cached pass's registers are not live beside the uncached pass's).
    int n_steps = 0, n_term = 0;
    if constexpr (kKind == kRejection || kKind == kReservoir) {
      for (int i = lo; i < hi; ++i)
        process_lane_n2v<kKind, kStop, kRecord, kGraph>(a, i, &n_steps,
                                                        &n_term);
      if (a.num_hot > 0)
        for_cached_lanes(a, lo, hi, LanePassN2V<kKind, kStop, kRecord>{
                                        a, &n_steps, &n_term});
    } else {
      for (int base = lo; base < hi; base += kChunk)
        process_chunk<kKind, kStop, kRecord, kChunk, kGraph>(
            a, base, hi, &n_steps, &n_term);
      if (a.num_hot > 0)
        for_cached_lanes(a, lo, hi, ChunkPass<kKind, kStop, kRecord>{
                                        a, &n_steps, &n_term});
    }
    n_steps = block_sum(n_steps, s_scratch);
    n_term = block_sum(n_term, s_scratch);
    // The superstep's queue counters, read here and not at its start, so
    // that they hold no register through the lane passes; thread 0 writes
    // s_head only after the barrier below.
    const long long head = s_head;
    const long long tail = s_tail;

    if (tid == 0) {
      // Stats: idle and upstream from the superstep's start.
      const long long idle = a.width - n_active;
      s_stats[kSteps] += n_steps;
      s_stats[kSlotSteps] += a.width;
      s_stats[kBubbles] += idle;
      s_stats[kStarved] += head < tail ? idle : 0;
      s_stats[kTerminations] += n_term;
      s_stats[kSupersteps] += 1;
      // Controller: observe head C supersteps late (Theorem VI.1).
      long long* hist = a.ctl + kCtlHist;
      for (int j = 0; j < a.delay; ++j) hist[j] = hist[j + 1];
      hist[a.delay] = head;
      s_staged = max(s_staged, min(hist[0] + a.depth, tail));
    }
    __syncthreads();

    // Refill: free lanes take the next staged arrivals, ranked by an
    // exclusive prefix count of free lanes in lane order.
    int my_free = 0;
    for (int i = lo; i < hi; ++i) my_free += a.active[i] != kLive;
    bool all_free = true;
    if (kStatic)   // bulk-synchronous: reload only a fully drained pool
      all_free = block_sum((hi - lo) - my_free, s_scratch) == 0;
    if (!all_free) my_free = 0;
    int total_free = 0;
    int rank = block_exclusive_scan(my_free, s_scratch, &total_free);
    const long long avail = max(s_staged - head, 0LL);
    for (int i = lo; i < hi; ++i) {
      const uint8_t mark = a.active[i];
      const bool free = mark != kLive && all_free;
      if (free && rank < avail) {
        const int nq = a.q_order[(head + rank) % a.num_queries];
        const int start = a.q_start[nq];
        a.v_curr[i] = start;
        a.v_prev[i] = -1;
        a.query_id[i] = nq;
        a.hop[i] = 0;
        a.active[i] = kLive;
        a.epoch[i] = a.q_epoch[nq];
        if (kRecord) {
          a.lengths[nq] = 1;
          a.paths[nq * (static_cast<long long>(a.max_hops) + 1)] = start;
        }
      } else if (mark == kEnded) {
        a.query_id[i] = -1;
        a.active[i] = kFree;
      }
      rank += free;
      // Every thread has resolved its lanes (barriers since): empty this
      // thread's range of the tag table for the next superstep's fill.
      if (a.num_hot > 0) __stcg(a.tags + i, ~0ull);
    }
    if (tid == 0) s_head = head + min(static_cast<long long>(total_free), avail);
    n_active = block_sum(count_live(a.active, lo, hi), s_scratch);
  }

  if (tid == 0) {
    for (int s = 0; s < kNumStats; ++s) a.ctl[kCtlStats + s] = s_stats[s];
    a.ctl[kCtlHead] = s_head;
    a.ctl[kCtlStaged] = s_staged;
    a.ctl[kCtlTail] = s_tail;
    a.ctl[kCtlWork] = (s_head < s_tail || n_active > 0) ? 1 : 0;
    a.ctl[kCtlSupersteps] = s_stats[kSupersteps];
  }
}

// What a launch does with one instantiation of the kernel, picked by
// dispatch() from the run-time kind and flags.
struct Launch {   // launch it on `stream`
  const Args& a;
  int smem;       // dynamic shared-memory bytes (the staged cache block)
  cudaStream_t stream;

  template <int kKind, bool kStop, bool kRecord, bool kStatic>
  int run() const {
    const auto kernel = fused_superstep_kernel<kKind, kStop, kRecord, kStatic>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int threads = min(kMaxThreads, (a.width + 31) / 32 * 32);
    kernel<<<1, threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

struct SmemLimit {   // the dynamic shared memory it can take, or -error
  template <int kKind, bool kStop, bool kRecord, bool kStatic>
  int run() const {
    int device = 0, optin = 0;
    cudaFuncAttributes attr{};
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(
          &attr, fused_superstep_kernel<kKind, kStop, kRecord, kStatic>);
    if (e != cudaSuccess) return -static_cast<int>(e);
    return optin - static_cast<int>(attr.sharedSizeBytes);
  }
};

template <typename Op, int kKind, bool kStop, bool kRecord>
int dispatch_mode(const Op& op, bool static_mode) {
  return static_mode ? op.template run<kKind, kStop, kRecord, true>()
                     : op.template run<kKind, kStop, kRecord, false>();
}

template <typename Op, int kKind, bool kStop>
int dispatch_record(const Op& op, bool record, bool static_mode) {
  return record ? dispatch_mode<Op, kKind, kStop, true>(op, static_mode)
                : dispatch_mode<Op, kKind, kStop, false>(op, static_mode);
}

template <typename Op, int kKind>
int dispatch_stop(const Op& op, bool stop, bool record, bool static_mode) {
  return stop ? dispatch_record<Op, kKind, true>(op, record, static_mode)
              : dispatch_record<Op, kKind, false>(op, record, static_mode);
}

// op.run<...>() for the instantiation of (kind, stop, record, static_mode),
// or cudaErrorInvalidValue for an unknown kind.
template <typename Op>
int dispatch(const Op& op, int kind, bool stop, bool record,
             bool static_mode) {
  switch (kind) {
    case kUniform:
      return dispatch_stop<Op, kUniform>(op, stop, record, static_mode);
    case kAlias:
      return dispatch_stop<Op, kAlias>(op, stop, record, static_mode);
    case kMetapath:
      return dispatch_stop<Op, kMetapath>(op, stop, record, static_mode);
    case kRejection:
      return dispatch_stop<Op, kRejection>(op, stop, record, static_mode);
    case kReservoir:
      return dispatch_stop<Op, kReservoir>(op, stop, record, static_mode);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// fused_superstep launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (or cudaErrorInvalidValue for an
// unknown kind, a width below 1, a Node2Vec kind with rounds, chunk or
// bisect_iters below 1, or a cache without its block, scratch or probe
// trips).  num_hot = 0 runs without the cache; cache_words > 0 stages the
// block's first cache_words words into shared memory.
extern "C" int fused_superstep(
    int* v_curr, int* v_prev, int* query_id, int* hop, uint8_t* active,
    int* epoch, const int* q_start, const int* q_order, const int* q_epoch,
    uint8_t* done, int* lengths, int* paths, long long* ctl,
    const int* row_ptr, const int* col, const float* alias_prob,
    const int* alias_idx, const int* type_offsets, const int* schedule,
    const float* weights, const int* cache, unsigned long long* tags,
    int* cslot, int width, int num_queries, int max_hops,
    int num_vertices, int num_edges, int type_stride, int schedule_len,
    int delay, int k, long long depth, unsigned int key0, unsigned int key1,
    float stop_prob, float inv_p, float inv_q, float w_max, int rounds,
    int chunk, int bisect_iters, int num_hot, int cache_entries,
    int probe_trips, int cache_words, int c_col, int c_wgt, int c_prob,
    int c_alias, int c_toff, int kind, int record_paths, int static_mode,
    void* stream) {
  if (width < 1 || ((kind == kRejection || kind == kReservoir) &&
                    (rounds < 1 || chunk < 1 || bisect_iters < 1)) ||
      (num_hot > 0 && (cache == nullptr || tags == nullptr ||
                       cslot == nullptr || probe_trips < 1 ||
                       cache_entries < 1 || cache_words < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{v_curr, v_prev, query_id, hop, active, epoch,
               q_start, q_order, q_epoch, done, lengths, paths, ctl,
               row_ptr, col, alias_prob, alias_idx, type_offsets, schedule,
               weights, width, num_queries, max_hops, num_vertices, num_edges,
               type_stride, schedule_len, delay, k, depth,
               make_uint2(key0, key1), stop_prob, inv_p, inv_q, w_max, rounds,
               chunk, bisect_iters, cache, tags, cslot, max(num_hot, 0),
               cache_entries, probe_trips, num_hot > 0 ? cache_words : 0,
               c_col, c_wgt, c_prob, c_alias, c_toff};
  const int smem = 4 * a.cache_words;
  return dispatch(Launch{a, (smem + 15) / 16 * 16,
                         static_cast<cudaStream_t>(stream)},
                  kind, stop_prob > 0.0f, record_paths != 0,
                  static_mode != 0);
}

// The dynamic shared memory (bytes) that the instantiation of (kind,
// stop_prob > 0, record_paths, static_mode) can take on the current
// device: the opt-in limit less its static shared memory; a negative
// cudaError on failure.  A cache block up to this size is staged.
extern "C" int fused_superstep_smem_limit(int kind, int stop, int record_paths,
                                          int static_mode) {
  return dispatch(SmemLimit{}, kind, stop != 0, record_paths != 0,
                  static_mode != 0);
}
