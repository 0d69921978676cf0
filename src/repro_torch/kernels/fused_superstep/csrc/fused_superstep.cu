// Fused superstep kernel for Hopper (sm_90a): k whole supersteps of the
// walk engine per launch, in one cooperative grid that spans the card.
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
// What bounds it on the H100: latency.  Each live lane derives its draws
// in-kernel: 2 Threefry blocks fold query id and hop into the key (a 3rd
// folds an epoch > 0), shared by the lane's draws, then each draw folds
// its salt and runs its block; ~80 int32 ops a block, so 4 blocks (~320
// ops) a lane for URW/DeepWalk/MetaPath and 6 (~480) for PPR, every
// superstep, and a few dependent gathers.  At the main path's W = 4,096
// that is ~2 M int32 ops a superstep, 0.1 us of the card's int32 rate; a
// superstep cannot be shorter than one lane's chain of dependent steps
// (its Threefry chain, its gathers, the refill's loads) plus the grid
// barrier that orders the refill after every lane's termination.
//
// What the design does about it.  The launch is cooperative
// (cudaLaunchCooperativeKernel): every block is resident, sized by the
// occupancy API for the instantiation and its dynamic shared memory
// (fused_superstep_grid), so the blocks can wait on each other.  The lanes
// are spread over the grid in lane order: block b owns a contiguous range,
// thread t of it a contiguous run, so lane order is (block, thread, index)
// order, the order the refill ranks ascend in.  The uniform, alias,
// metapath and rejection kinds take one thread a lane up to 132 x 512
// lanes (threads = W / #SMs rounded up to a warp, blocks = W / threads:
// at W = 4,096, 128 blocks of 32 threads), so the lanes' chains of
// dependent loads run side by side on as many warps as there are lanes.
//
// A superstep ends in one grid barrier, and the scalars every block needs
// are derived, not shared.  Each block (1) runs its
// lanes; (2) writes a partial record (steps, terminations, free lanes,
// reservoir chunks, the three cache counters) to its slot; (3) passes the
// barrier; (4) reads every block's record.  Every block then holds the
// same totals: its refill rank offset is the free lanes of the blocks
// before it, plus an exclusive scan inside it; static mode's `all_free` is
// live - terminated == 0; the next live count is live - terminated +
// min(free, avail).  So the queue counters and the stats are the same in
// every block without another barrier; the controller's head history,
// whose length (the injection delay + 1) is unbounded, is a per-block copy
// in the scratch, shifted by each block's thread 0; block 0 writes the
// control block at the end of the launch.  Records are double-buffered by
// superstep parity, since a fast block may write its next record while a
// slow one still reads the last.  One more barrier at the start of a
// launch publishes the live count and orders the scratch resets.  The
// state tensors are touched only by their lanes' owners; what one block
// writes and another reads (the records, the tag table, the reservoir's
// lane records and best words) is read through L2 (__ldcg) after a
// barrier, never through the non-coherent path.
//
// Barriers a superstep (plus one a launch): uniform, alias, metapath and
// rejection 1; reservoir 2; each one more with a cache.
//
// A lane's `active` byte is 0 (free) or 1 (live) between supersteps; inside
// one it is 2 for a lane that terminated this superstep, until the refill
// gives the lane a new query or frees it, and 3 for a live lane whose row
// is cached, from the cache's resolve pass until its lane pass.
//
// The rejection kind (unweighted Node2Vec) runs a lane's rounds on its
// owner thread, up to K, each reading N(v_prev) by the lower-bound
// bisection of samplers.edge_exists (its trip count, from the wrapper, and
// its compares; a halving with lo >= hi changes nothing, so the loop stops
// there).  It stops at the first accept, so its cost is that of the other
// kinds; its rounds run two at a time (rejection_pick).
//
// The reservoir (weighted Node2Vec) scans every candidate of N(v_curr),
// ceil(deg / CH) chunks of CH, each candidate's key bisecting N(v_prev):
// E[d^2]/E[d] = 575 on the WG stand-in, so ~9 chunks a live lane and 290
// for the hub.  Its unit of work is a (lane, chunk), handed out over all
// the grid's warps: a pre-pass has each owner draw the stop, read the row,
// decide termination and count its lanes' chunks; the records' chunk
// counts give every block the chunk offset of each block (a scan in shared
// memory), and the owners' lane records the offset inside the block; warp
// w takes the contiguous items [w * per, (w + 1) * per), per = ceil(total
// chunks / warps), finding its first lane by a 32-ary search of the
// offsets.  At CH = 64 a warp's 32 threads take exactly the chunk's 32
// pairs (the pair t, t + CH/2 that shares one Threefry block).  A chunk's
// draws are keyed by SALT_CHUNK0 + c, so chunks are independent; a lane's
// best is merged across chunks by a 64-bit atomicMax of (order-preserving
// bits of the key, then 0xffffffff - position), which keeps the first
// position of the largest key whatever order the chunks run in: the
// reference's first argmax in a chunk and strict > across chunks
// (samplers.es_chunk_score, es_merge).  -0.0 is mapped to +0.0 first, so
// the packed compare agrees with float ==; a lane whose keys are all -inf
// still picks position 0.  After a second barrier each owner reads its
// lanes' best words, resets them, and gathers the column.  So what bounds
// a reservoir superstep is the busiest warp's chunks (at most `per`), each
// a Threefry chain and a bisection's dependent loads, not a hub's whole
// neighbor list on one thread.
//
// The chunks' candidates are staged, the counterpart of the reference's
// ckcol / ckwgt ping-pong (make_async_copy in _reservoir_sample): each
// warp owns two slots in dynamic shared memory (kStageWarpBytes, ahead of
// the cache's block), and while it scores one window of its items it has
// the next window's columns and weights in flight into the other slot by
// cp.async (4-byte copies: a row starts on any word).  A window is a
// chunk's pairs [32j, 32j + 32), both positions of each pair, so at CH <=
// 64 an item is one window; each thread copies just the words that it
// then reads, with the direct read's clamps, so the staged words are the
// words read before and every bit stays as it was.  The window is waited
// (cp.async.wait_group 1, 0 when no copy follows it) and read, and a
// __syncwarp() orders both around the slot's reuse.  Items of a cached
// lane read the cache's block as before and issue no copy.  The warp's
// order of starts, waits and reads is declared in ../schedule.py
// (dma_schedule) and checked by the DMA pass; with Args.trace set, lane 0
// of one warp records what it issued, so the card shows the same order.
//
// The gather hierarchy (a runtime condition, num_hot > 0, so it adds no
// kernel instantiation): the wrapper passes the hot-vertex cache's packed
// block (graph/hot_cache.py: the sorted hot ids, their degrees and row
// offsets, and verbatim copies of their rows' columns and the kind's
// payloads) as one int32 array.  Where it fits beside the kernel's static
// shared memory (and the reservoir's staging slots, which come first),
// each block copies it into its dynamic shared memory at
// the start of each launch, the counterpart of the TPU kernel's VMEM; a
// larger block is read in place in device memory.  Each superstep starts
// with two passes over an owner's lanes: (1) every lane, idle or not,
// atomicMin's (lane << 32 | vv) into slot vv mod W of a W-word tag table,
// vv = clamp(v_curr, 0, V-1), so the slot keeps its smallest lane, the
// lane the reference's reverse-order fill leaves there; a grid barrier;
// (2) each lane reads its slot's word: it follows if that lane is another
// with the same vv, else leads; it probes the sorted hot ids (lower-bound
// bisection, the reference's _cache_probe) and writes its slot or -1 to
// the cslot scratch; live lanes count hits and misses (leaders) and
// coalesced (followers) into the block's record; a live lane whose probe
// hit is marked kCachedLive.  The tag table is double-buffered by
// superstep parity: an owner empties its range of this superstep's table
// in the refill pass, after the barrier that follows every resolve, and
// the next fill of that table comes two supersteps later.  Row access and
// every gather keyed on v_curr (the column, the alias probe, the typed
// row, the rejection proposal, the reservoir's candidates and weights)
// read the block for a cached lane, at offsets clamped into [0, P-1]; a
// follower has its leader's vertex and so its own probe gives the same
// slot.  The bisection of N(v_prev) always reads device memory.  The
// block is a verbatim copy, so a cached read returns what the graph
// holds: only the three counters differ from the uncached run.
//
// Registers: the reservoir's __launch_bounds__(1024, 1) allows 64 a
// thread, the other kinds' (512, 1) 128.  A cached lane is not live to
// the uncached lane pass, which is the kernel without a cache; a second
// loop then runs each cached lane through the same pass compiled for its
// tier (kShared: the block at a constant shared-memory address; kGlobal:
// the block in device memory).  The cache's loops are
// not unrolled, a thread's lanes run one at a time, and the queue
// counters, the live count and the cache counters stay in shared memory
// through the lane passes: each of these choices removed spills that
// ptxas reported for some instantiation (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "walk_common.cuh"

// Dynamic shared memory: the reservoir's staging slots (stage_bytes),
// then the cache's packed block, staged when it fits (cache_words > 0).
extern __shared__ int4 s_dyn[];

namespace {

namespace cg = cooperative_groups;

using walk::clampi;
using walk::uniform_index;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxBlocks = 512;     // the reservoir's chunk-offset table
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind {
  kUniform = 0, kAlias = 1, kMetapath = 2, kRejection = 3, kReservoir = 4
};

// Threads a block at most: the reservoir takes every warp a
// multiprocessor holds (64 registers a thread); the other kinds run one
// thread a lane, and 512 threads a block leave them 128 registers.
__host__ __device__ constexpr int max_threads(int kind) {
  return kind == kReservoir ? kMaxThreads : kMaxThreads / 2;
}

// The reservoir's staging: a warp's two slots, each a window's columns
// (kStageWords: entry n * 32 + t is position 32j + t + n * pairs of the
// chunk) and then its weights.
constexpr int kStageWords = 64;
constexpr int kSlotWords = 2 * kStageWords;
constexpr int kStageWarpBytes = 2 * kSlotWords * 4;

// Dynamic shared memory that the kind's staging takes ahead of the
// cache's block: the reservoir's slots for every warp a block may have.
__host__ __device__ constexpr int stage_bytes(int kind) {
  return kind == kReservoir ? kMaxWarps * kStageWarpBytes : 0;
}

// The cache's block in dynamic shared memory, after the kind's staging.
template <int kKind>
__device__ __forceinline__ int* shared_block() {
  return reinterpret_cast<int*>(s_dyn) + stage_bytes(kKind) / 4;
}

// The schedule trace (Args::trace, schedule.py): header words, then
// records of (op, buffer, slot, copy id).
enum TraceHeader {
  kTrWarp = 0, kTrCap, kTrRecords, kTrItems, kTrWindows, kTrNextCopy,
  kTrHeader = 8
};
enum TraceOp { kTrStart = 0, kTrWait = 1, kTrRead = 2 };
enum TraceBuf { kTrCol = 0, kTrWgt = 1, kTrCacheCol = 2, kTrCacheWgt = 3 };

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

// A block's partial record: int32 words.
enum Part {
  kPSteps = 0, kPTerm, kPFree, kPChunks, kPHits, kPMisses, kPCoalesced,
  kPLive, kPartWords
};

constexpr uint8_t kFree = 0, kLive = 1, kEnded = 2, kCachedLive = 3;

// The lane passes' tiers: kGraph reads the graph, kShared and kGlobal
// read the cache's block, staged in shared memory or in place.
constexpr int kGraph = 0, kShared = 1, kGlobal = 2;

// The scratch buffer (one allocation, laid out here): byte offsets, each
// 16-byte aligned.
struct Layout {
  long long tags;     // (2, W) u64: the tag tables, by superstep parity
  long long cslot;    // (W,) int32: each lane's cache slot, or -1
  long long best;     // (W,) u64: the reservoir's packed best per lane
  long long rlane;    // (W, 3) int4: the reservoir's lane records
  long long part;     // (2, blocks, kPartWords) int32: partial records
  long long hist;     // (blocks, delay + 1) int64: controller history
  long long bytes;
};

inline long long align16(long long x) {
  return (x + 15) / 16 * 16;
}

inline Layout layout(int width, int blocks, int delay) {
  Layout l{};
  long long at = 0;
  l.tags = at;  at = align16(at + 2LL * width * 8);
  l.cslot = at; at = align16(at + 4LL * width);
  l.best = at;  at = align16(at + 8LL * width);
  l.rlane = at; at = align16(at + 48LL * width);
  l.part = at;  at = align16(at + 2LL * blocks * kPartWords * 4);
  l.hist = at;  at = align16(at + 8LL * blocks * (delay + 1));
  l.bytes = at;
  return l;
}

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
  int num_hot;          // H; 0: no cache
  int cache_entries;    // P
  int probe_trips;      // HotVertexCache.probe_trips
  int cache_words;      // words staged into shared memory; 0: read in place
  int c_col;
  int c_wgt;
  int c_prob;
  int c_alias;
  int c_toff;
  // Scratch (see Layout).
  unsigned long long* tags;
  int* cslot;
  unsigned long long* best;
  int4* rlane;
  int* part;
  long long* hist;
  // The reservoir's schedule trace (schedule.py's layout); null in every
  // launch but a traced one.
  int* trace;
};

// Where the cache's block is read from in tier kTier.
template <int kKind, int kTier>
__device__ __forceinline__ const int* cache_base(const Args& a) {
  return kTier == kShared ? shared_block<kKind>() : a.cache;
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

// Gather hierarchy, pass 1: lanes [lo, hi) claim their slots of `tags`.
// A grid barrier follows before cache_resolve.
__device__ __forceinline__ void cache_fill(const Args& a,
                                           unsigned long long* tags, int lo,
                                           int hi) {
#pragma unroll 1
  for (int i = lo; i < hi; ++i) {
    const int vv = clampi(a.v_curr[i], 0, a.num_vertices - 1);
    atomicMin(tags + vv % a.width,
              static_cast<unsigned long long>(i) << 32 |
                  static_cast<unsigned>(vv));
  }
}

// Gather hierarchy, pass 2: lanes [lo, hi) resolve leader or follower,
// probe the cache and write their slot to cslot; the live ones' hits,
// misses (leaders) and coalesced (followers), summed over the warp, are
// added to the block's s_cnt (shared-memory atomics, no barrier), and a
// live lane whose row is cached is marked kCachedLive, for the cached lane
// pass.  Every thread calls it (a warp sum).
template <int kKind, int kTier>
__device__ __forceinline__ void cache_resolve(const Args& a,
                                              const unsigned long long* tags,
                                              int lo, int hi, int* s_cnt) {
  const int* cb = cache_base<kKind, kTier>(a);
  unsigned hits = 0, misses = 0, coalesced = 0;
#pragma unroll 1
  for (int i = lo; i < hi; ++i) {
    const int vv = clampi(a.v_curr[i], 0, a.num_vertices - 1);
    const unsigned long long tag = __ldcg(tags + vv % a.width);
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
    atomicAdd(s_cnt + 0, static_cast<int>(hits));
    atomicAdd(s_cnt + 1, static_cast<int>(misses));
    atomicAdd(s_cnt + 2, static_cast<int>(coalesced));
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

// One lane of a first-order kind: draws, row access, pick, column gather,
// terminate and advance.  Adds the lane's advance and termination to
// *n_steps and *n_term.  In tier kGraph the pass reads the graph (a cached
// lane, kCachedLive, is not live to it); in tier kShared or kGlobal the
// lane is cached (its cslot is >= 0): row access and the v_curr-keyed
// gathers read the cache's block, the lane's addr being an offset into
// the block's packed rows, and gathers clamp into [0, P-1].
template <int kKind, bool kStop, bool kRecord, int kTier>
__device__ __forceinline__ void process_lane(const Args& a, int i,
                                             int* n_steps, int* n_term) {
  constexpr bool kHit = kTier != kGraph;
  if (a.active[i] != kLive) return;
  const int v = a.v_curr[i];
  const int h = a.hop[i];
  const int q = a.query_id[i];

  // Draws: the stop draw (counter (0,0), word 0) and the column draw
  // (counter (0,0) word 0; alias: counter (0,1), words 0 and 1).
  const uint2 pk = walk::task_prefix(a.key, q, h, a.epoch[i]);
  bool stop = false;
  if (kStop) {
    const uint2 sk = walk::fold_in(pk, walk::kSaltStop);
    const uint2 y = walk::threefry2x32(sk.x, sk.y, 0u, 0u);
    stop = walk::bits_to_uniform(y.x) < a.stop_prob;
  }
  const uint2 ck = walk::fold_in(pk, walk::kSaltColumn);
  const uint2 y = walk::threefry2x32(ck.x, ck.y, 0u,
                                     kKind == kAlias ? 1u : 0u);
  const float u0 = walk::bits_to_uniform(y.x);
  const float u1 = kKind == kAlias ? walk::bits_to_uniform(y.y) : 0.0f;

  // Row access: the clamped vertex's (addr, deg); deg 0 out of range.
  int addr = 0, deg = 0;
  if (a.num_vertices > 0) {
    const bool valid = v >= 0 && v < a.num_vertices;
    if (kHit) {   // the directory: hot_deg at word H, hot_off at 2H
      const int cs = a.cslot[i];
      addr = cache_base<kKind, kTier>(a)[2 * a.num_hot + cs];
      deg = valid ? cache_base<kKind, kTier>(a)[a.num_hot + cs] : 0;
    } else {
      const int vc = clampi(v, 0, a.num_vertices - 1);
      addr = __ldg(a.row_ptr + vc);
      const int end = __ldg(a.row_ptr + vc + 1);
      deg = valid ? end - addr : 0;
    }
  }

  // Pick: the neighbor offset idx (before the column clamp).
  int idx = addr;
  bool pick = deg > 0;
  if (pick && kKind == kMetapath) {
    // Sub-segment of the scheduled type; none -> dead end.
    const int t = __ldg(a.schedule + h % a.schedule_len);
    int lo, cnt;
    if (kHit) {
      const int* row = cache_base<kKind, kTier>(a) + a.c_toff +
                       a.cslot[i] * a.type_stride;
      lo = row[t];
      cnt = row[t + 1] - lo;
    } else {
      const long long row =
          static_cast<long long>(clampi(v, 0, a.num_vertices - 1)) *
          a.type_stride;
      lo = __ldg(a.type_offsets + row + t);
      cnt = __ldg(a.type_offsets + row + t + 1) - lo;
    }
    idx = addr + lo + uniform_index(cnt, u0);
    if (cnt <= 0) deg = 0;
  } else if (pick && kKind == kAlias) {
    // Keep draw k with probability prob[addr+k], else take alias[addr+k].
    float p = 0.0f;
    int al = 0;
    const int kdraw = uniform_index(deg, u0);
    if (kHit) {
      const int e = clampi(addr + kdraw, 0, a.cache_entries - 1);
      p = __int_as_float(cache_base<kKind, kTier>(a)[a.c_prob + e]);
      al = cache_base<kKind, kTier>(a)[a.c_alias + e];
    } else if (a.num_edges > 0) {
      const int e = clampi(addr + kdraw, 0, a.num_edges - 1);
      p = __ldg(a.alias_prob + e);
      al = __ldg(a.alias_idx + e);
    } else {
      pick = false;   // no table to read: idx stays addr
    }
    if (pick) idx = addr + clampi(u1 < p ? kdraw : al, 0, max(deg - 1, 0));
  } else if (pick) {
    idx = addr + uniform_index(deg, u0);
  }

  // Column access, clamped into [0, E-1] (cached: [0, P-1]); no read when
  // E == 0.
  int nxt = -1;
  if (deg > 0) {
    const int* cb = cache_base<kKind, kTier>(a);
    if (kHit)
      nxt = cb[a.c_col + clampi(idx, 0, a.cache_entries - 1)];
    else if (a.num_edges > 0)
      nxt = __ldg(a.col + clampi(idx, 0, a.num_edges - 1));
  }

  // Terminate and advance.
  finish_lane<kRecord>(a, i, v, h, q, stop, deg > 0, nxt, n_steps, n_term);
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

// One lane of a first-order kind in tier kTier (the pass
// for_cached_lanes runs).
template <int kKind, bool kStop, bool kRecord>
struct LanePass {
  const Args& a;
  int* n_steps;
  int* n_term;
  template <int kTier>
  __device__ __forceinline__ void go(int i) const {
    process_lane<kKind, kStop, kRecord, kTier>(a, i, n_steps, n_term);
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
// round wins, so the loop ends there.  Rounds run two at a time, both
// draws, proposals and bisections of N(v_prev) in flight together, and
// are tested in order, so the pick is the sequential one's; a lane's
// chain of dependent bisections is half as long.  Returns the chosen
// column.  In tier kShared or kGlobal the proposals read the cache's
// packed row at addr.
template <int kTier>
__device__ __forceinline__ int rejection_pick(const Args& a, uint2 pk,
                                              int addr, int deg, int vp,
                                              int plo, int phi) {
  const uint2 ck = walk::fold_in(pk, walk::kSaltColumn);
  for (int j = 0;; j += 2) {
    int y[2];
    float u_acc[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {   // round j + n (past K: unused)
      const uint32_t r_j = static_cast<uint32_t>(j + n);
      const uint2 r = walk::threefry2x32(
          ck.x, ck.y, r_j, r_j + static_cast<uint32_t>(a.rounds));
      const int prop = uniform_index(deg, walk::bits_to_uniform(r.x));
      const int* cb = cache_base<kRejection, kTier>(a);
      y[n] = kTier != kGraph
                 ? cb[a.c_col + clampi(addr + prop, 0, a.cache_entries - 1)]
                 : __ldg(a.col + clampi(addr + prop, 0, a.num_edges - 1));
      u_acc[n] = walk::bits_to_uniform(r.y);
    }
    if (j >= a.rounds - 1) return y[0];   // round j is the forced last
    bool common[2] = {false, false};
    if (vp >= 0) bisect<2>(a, plo, phi, y, common);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (j + n == a.rounds - 1) return y[n];
      if (__fmul_rn(u_acc[n], a.w_max) <= n2v_bias(a, vp, y[n], common[n]))
        return y[n];
    }
  }
}

// One lane of the rejection kind: the stop draw, row access, the pick
// (for a live lane, not stopped, with deg > 0), the column, and the
// advance.  In tier kShared or kGlobal the lane is cached (its cslot is
// >= 0), and its row access and v_curr-keyed gathers read the cache's
// block.
template <bool kStop, bool kRecord, int kTier>
__device__ __forceinline__ void process_lane_rejection(const Args& a, int i,
                                                       int* n_steps,
                                                       int* n_term) {
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
      addr = cache_base<kRejection, kTier>(a)[2 * a.num_hot + cs];
      deg = valid ? cache_base<kRejection, kTier>(a)[a.num_hot + cs] : 0;
    } else {
      const int vc = clampi(v, 0, a.num_vertices - 1);
      addr = __ldg(a.row_ptr + vc);
      const int end = __ldg(a.row_ptr + vc + 1);
      deg = valid ? end - addr : 0;
    }
  }
  if (stop || deg <= 0 || a.num_edges <= 0) {   // no pick: nxt = -1
    finish_lane<kRecord>(a, i, v, h, q, stop, deg > 0, -1, n_steps, n_term);
    return;
  }
  const int vp = a.v_prev[i];
  const int vpc = clampi(vp, 0, a.num_vertices - 1);
  const int nxt = rejection_pick<kTier>(a, pk, addr, deg, vp,
                                        __ldg(a.row_ptr + vpc),
                                        __ldg(a.row_ptr + vpc + 1));
  // The lane's state, loaded again (its own, unchanged since) rather than
  // held in registers through the pick.
  finish_lane<kRecord>(a, i, __ldca(a.v_curr + i), __ldca(a.hop + i),
                       __ldca(a.query_id + i), false, true, nxt, n_steps,
                       n_term);
}

// One lane of the rejection kind in tier kTier (the pass for_cached_lanes
// runs).
template <bool kStop, bool kRecord>
struct LanePassRejection {
  const Args& a;
  int* n_steps;
  int* n_term;
  template <int kTier>
  __device__ __forceinline__ void go(int i) const {
    process_lane_rejection<kStop, kRecord, kTier>(a, i, n_steps, n_term);
  }
};

// ---------------------------------------------------------------- reservoir
//
// A lane record, three int4 a lane (rlane[3i ...]): {pk.x, pk.y, addr,
// deg}, {vp, plo, phi, tier}, {off, nch, 0, 0}: the lane's key prefix, its
// row (an offset into the cache's packed rows when tier != kGraph), its
// v_prev and N(v_prev)'s bounds, and its first chunk's item offset inside
// its block and its chunk count (0: no scan this superstep).

// The packed merge word of a candidate key at position pos: the key's
// order-preserving bits (-0.0 taken as +0.0) above 0xffffffff - pos, so
// the largest word is the largest key at its first position.
__device__ __forceinline__ unsigned long long pack_key(float key, int pos) {
  unsigned u = __float_as_uint(key == 0.0f ? 0.0f : key);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return static_cast<unsigned long long>(u) << 32 |
         (0xffffffffu - static_cast<unsigned>(pos));
}

// Reservoir pre-pass over lanes [lo, hi): for every live lane (cached
// or not), the stop draw and row access; a lane that stops or dead-ends is
// finished here, a lane with candidates gets its record and
// ceil(deg / CH) chunks (its termination, known now, is counted here:
// it advances, and ends iff h + 1 >= max_hops).  v[kPFree] counts the
// lanes that are free once the superstep's lanes are finished.
template <bool kStop, bool kRecord>
__device__ __forceinline__ void reservoir_prepass(const Args& a, int lo,
                                                  int hi, int* v) {
#pragma unroll 1
  for (int i = lo; i < hi; ++i) {
    const uint8_t mark = a.active[i];
    int nch = 0;
    if (mark == kLive || mark == kCachedLive) {
      const int tier = mark == kLive ? kGraph
                       : a.cache_words > 0 ? kShared : kGlobal;
      const int* cb =
          tier == kShared ? shared_block<kReservoir>() : a.cache;
      if (mark == kCachedLive) a.active[i] = kLive;
      const int vcur = a.v_curr[i];
      const int h = a.hop[i];
      const int q = a.query_id[i];
      const uint2 pk = walk::task_prefix(a.key, q, h, a.epoch[i]);
      bool stop = false;
      if (kStop) {
        const uint2 sk = walk::fold_in(pk, walk::kSaltStop);
        stop = walk::bits_to_uniform(
                   walk::threefry2x32(sk.x, sk.y, 0u, 0u).x) < a.stop_prob;
      }
      int addr = 0, deg = 0;
      if (a.num_vertices > 0) {
        const bool valid = vcur >= 0 && vcur < a.num_vertices;
        if (tier != kGraph) {   // the directory: hot_deg at H, hot_off at 2H
          const int cs = a.cslot[i];
          addr = cb[2 * a.num_hot + cs];
          deg = valid ? cb[a.num_hot + cs] : 0;
        } else {
          const int vc = clampi(vcur, 0, a.num_vertices - 1);
          addr = __ldg(a.row_ptr + vc);
          const int end = __ldg(a.row_ptr + vc + 1);
          deg = valid ? end - addr : 0;
        }
      }
      if (!stop && deg > 0 && a.num_edges > 0) {
        const int vp = a.v_prev[i];
        const int vpc = clampi(vp, 0, a.num_vertices - 1);
        nch = (deg + a.chunk - 1) / a.chunk;
        a.rlane[3 * i] = make_int4(static_cast<int>(pk.x),
                                   static_cast<int>(pk.y), addr, deg);
        a.rlane[3 * i + 1] = make_int4(vp, __ldg(a.row_ptr + vpc),
                                       __ldg(a.row_ptr + vpc + 1), tier);
        const bool term = h + 1 >= a.max_hops;
        v[kPSteps] += 1;
        v[kPTerm] += term;
        v[kPFree] += term;
      } else {
        finish_lane<kRecord>(a, i, vcur, h, q, stop, deg > 0, -1,
                             &v[kPSteps], &v[kPTerm]);
      }
    }
    v[kPFree] += a.active[i] != kLive;
    v[kPChunks] += nch;
    a.rlane[3 * i + 2].y = nch;
  }
}

// The last index j in [lo, hi) with key(j) <= x, for keys non-decreasing
// in j and key(lo) <= x: a 32-ary search by the whole warp, one load a
// lane a round.  Every lane of the warp calls it and gets the answer.
template <typename Key>
__device__ __forceinline__ int warp_last_le(int lo, int hi, long long x,
                                            const Key& key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const unsigned m = __ballot_sync(kFullMask, p < hi && key(p) <= x);
    const int last = lo + (__popc(m) - 1) * step;
    hi = min(last + step, hi);
    lo = last;
  }
  return lo;
}

// Block b's first lane: the lanes are split over the grid in lane order,
// every block taking floor or ceil(W / G) of them.
__device__ __forceinline__ int block_lane(int width, int b) {
  return static_cast<int>(static_cast<long long>(width) * b / gridDim.x);
}

// cp.async of one 4-byte word from device memory into shared memory, and
// the commit and wait of a warp's groups of them.
__device__ __forceinline__ void cp_async4(int* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Appends one record to the schedule trace; only lane 0 of the traced warp
// calls it.  Past the capacity only the count grows.
__device__ __forceinline__ void trace_op(int* tr, int op, int buf, int slot,
                                         int copy) {
  const int r = tr[kTrRecords]++;
  if (r < tr[kTrCap]) {
    int* rec = tr + kTrHeader + 4 * r;
    rec[0] = op;
    rec[1] = buf;
    rec[2] = slot;
    rec[3] = copy;
  }
}

// The pairs of chunk c (of a lane of degree deg) that draw: min(pairs,
// valid candidates).  The chunk is ceil(that / 32) windows.
__device__ __forceinline__ int chunk_span(const Args& a, int c, int deg) {
  return min((a.chunk + 1) / 2, min(a.chunk, deg - c * a.chunk));
}

// Starts window j of chunk c of a lane whose row is at addr (degree deg)
// into `slot` (kSlotWords: its columns, then its weights): thread t copies
// the words of pair b = 32j + t that reservoir_chunk has it read, position
// b and, where valid, b + pairs, each at clamp(addr + base + p, 0, E - 1)
// as the direct read took it; one commit group a window.  With `traced`,
// lane 0 records the starts on slot `parity`.
__device__ __forceinline__ void stage_window(const Args& a, int* slot,
                                             int addr, int deg, int c, int j,
                                             bool traced, int parity) {
  const int t = threadIdx.x & 31;
  const int pairs = (a.chunk + 1) / 2;
  const int base = c * a.chunk;
  const int n_valid = min(a.chunk, deg - base);
  const int b = 32 * j + t;
  if (b < pairs && b < n_valid) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int p = b + n * pairs;
      if (n == 1 && p >= n_valid) break;
      const int e = clampi(addr + base + p, 0, a.num_edges - 1);
      cp_async4(slot + 32 * n + t, a.col + e);
      if (a.weights)
        cp_async4(slot + kStageWords + 32 * n + t, a.weights + e);
    }
  }
  cp_async_commit();
  if (traced && t == 0) {
    trace_op(a.trace, kTrStart, kTrCol, parity, a.trace[kTrNextCopy]++);
    if (a.weights)
      trace_op(a.trace, kTrStart, kTrWgt, parity, a.trace[kTrNextCopy]++);
  }
}

// Window j of one (lane, chunk) item by the whole warp: chunk c of lane
// `lane`'s candidates, thread t taking pair b = 32j + t of the chunk (so
// at CH <= 64 the item is one window).  Chunk c of CH candidates draws at
// salt SALT_CHUNK0 + c, draws b and b + pairs (pairs = (CH + 1) / 2)
// sharing counter (b, b + pairs) as in rng.key_bits(CH); candidate
// position p = c * CH + b < deg has weight w = w_edge * bias and E-S key
// log(u + 1e-20) / w where w > 0, else -inf, in IEEE float32 (logf, no
// fast math) as torch computes it on the card.  An uncached lane's
// columns and weights are the window's staged `slot` (stage_window), a
// cached lane's the cache's block.  The warp's largest packed word goes to
// best[lane] by atomicMax.
__device__ __forceinline__ void reservoir_chunk(const Args& a, int lane_id,
                                                int c, int j, const int4 r0,
                                                const int4 r1,
                                                const int* slot) {
  const int addr = r0.z, deg = r0.w, vp = r1.x, plo = r1.y, phi = r1.z;
  const int tier = r1.w;
  const int* cb = tier == kShared ? shared_block<kReservoir>() : a.cache;
  const float neg_inf = __uint_as_float(0xff800000u);
  const int pairs = (a.chunk + 1) / 2;
  const int base = c * a.chunk;
  const int n_valid = min(a.chunk, deg - base);
  const int t = threadIdx.x & 31;
  const int b = 32 * j + t;
  const uint2 dk = walk::fold_in(
      make_uint2(static_cast<uint32_t>(r0.x), static_cast<uint32_t>(r0.y)),
      walk::kSaltChunk0 + c);
  unsigned long long best = 0;
  if (b < pairs && b < n_valid) {
    const int pos[2] = {b, b + pairs};
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
      if (tier != kGraph) {   // the row's packed columns and weights
        const int e = clampi(addr + base + pos[n], 0, a.cache_entries - 1);
        y[n] = cb[a.c_col + e];
        w_edge[n] = a.c_wgt >= 0 ? __int_as_float(cb[a.c_wgt + e]) : 1.0f;
      } else {                // the staged window
        y[n] = slot[32 * n + t];
        w_edge[n] =
            a.weights ? __int_as_float(slot[kStageWords + 32 * n + t]) : 1.0f;
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
      best = max(best, pack_key(key, base + pos[n]));
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(kFullMask, best, o));
  if (t == 0) atomicMax(a.best + lane_id, best);
}

// The lane whose items hold item x of the scan, with its first item and
// chunk count: 32-ary searches of the blocks' first items (s_base), then
// of the block's lanes' first items.  Every lane of the warp calls it.
__device__ __forceinline__ int scan_lane(const Args& a, const int* s_base,
                                         int x, int* first, int* nch) {
  const int b = warp_last_le(0, gridDim.x, x,
                             [&](int j) { return s_base[j]; });
  const int lo = block_lane(a.width, b), hi = block_lane(a.width, b + 1);
  const int lane_id = warp_last_le(lo, hi, x - s_base[b], [&](int j) {
    return __ldcg(&a.rlane[3 * j + 2].x);
  });
  const int4 r2 = __ldcg(a.rlane + 3 * lane_id + 2);
  *first = s_base[b] + r2.x;
  *nch = r2.y;
  return lane_id;
}

// The chunk scan: this warp's items [w * per, (w + 1) * per) of `total`,
// over the lanes' records; s_base[b] is block b's first item.  The items'
// windows pass through the warp's two staging slots in turn: before the
// warp scores a window it starts the next window's copies (the next
// item's, its lane found one item early), then waits for its own window
// and reads it.  A cached lane's windows start nothing.  With Args.trace
// set, lane 0 of the warp the trace names records its starts, waits and
// reads (a warp-uniform branch).
__device__ __forceinline__ void reservoir_scan(const Args& a,
                                               const int* s_base, int total) {
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int per = (total + warps - 1) / warps;
  const int x0 = w * per;
  const int x1 = min(total, x0 + per);
  if (x0 >= x1) return;
  int* const stage =
      reinterpret_cast<int*>(s_dyn) + (threadIdx.x >> 5) * 2 * kSlotWords;
  const bool traced = a.trace != nullptr && a.trace[kTrWarp] == w;
  const bool lead = (threadIdx.x & 31) == 0;
  if (traced && lead) a.trace[kTrItems] += x1 - x0;
  int first, nch;
  int lane_id = scan_lane(a, s_base, x0, &first, &nch);
  int4 r0 = __ldcg(a.rlane + 3 * lane_id);
  int4 r1 = __ldcg(a.rlane + 3 * lane_id + 1);
  int x = x0, j = 0;
  int fill = 0;                    // the slot the next staged window takes
  bool staged = r1.w == kGraph;    // this window's copies are in flight
  if (staged) {
    stage_window(a, stage, r0.z, r0.w, x - first, 0, traced, 0);
    fill = 1;
  }
  for (;;) {
    const int c = x - first;
    const bool adv = 32 * (j + 1) >= chunk_span(a, c, r0.w);   // next item
    const bool more = !adv || x + 1 < x1;
    int n_lane = lane_id, n_first = first, n_nch = nch;
    bool n_staged = false;
    if (more) {
      int n_addr = r0.z, n_deg = r0.w, n_tier = r1.w;
      if (adv && x + 1 >= first + nch) {
        n_lane = scan_lane(a, s_base, x + 1, &n_first, &n_nch);
        const int4 n_r0 = __ldcg(a.rlane + 3 * n_lane);
        n_addr = n_r0.z;
        n_deg = n_r0.w;
        n_tier = __ldcg(&a.rlane[3 * n_lane + 1].w);
      }
      n_staged = n_tier == kGraph;
      if (n_staged) {
        stage_window(a, stage + fill * kSlotWords, n_addr, n_deg,
                     adv ? x + 1 - n_first : c, adv ? 0 : j + 1, traced,
                     fill);
        fill ^= 1;
      }
    }
    const int* slot = nullptr;
    if (staged) {   // its slot: the one before the last started
      const int cur = n_staged ? fill : fill ^ 1;
      if (n_staged) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncwarp();
      slot = stage + cur * kSlotWords;
      if (traced && lead) {
        const int nbuf = a.weights ? 2 : 1;
        const int id = a.trace[kTrNextCopy] - nbuf * (n_staged ? 2 : 1);
        trace_op(a.trace, kTrWait, kTrCol, cur, id);
        if (a.weights) trace_op(a.trace, kTrWait, kTrWgt, cur, id + 1);
        trace_op(a.trace, kTrRead, kTrCol, cur, -1);
        if (a.weights) trace_op(a.trace, kTrRead, kTrWgt, cur, -1);
      }
    } else if (traced && lead && r1.w == kShared) {
      trace_op(a.trace, kTrRead, kTrCacheCol, 0, -1);
      if (a.c_wgt >= 0) trace_op(a.trace, kTrRead, kTrCacheWgt, 0, -1);
    }
    if (traced && lead) a.trace[kTrWindows] += 1;
    reservoir_chunk(a, lane_id, c, j, r0, r1, slot);
    __syncwarp();   // the slot's reads are done before it is refilled
    if (!more) break;
    if (adv) {
      x += 1;
      j = 0;
      if (n_lane != lane_id) {
        lane_id = n_lane;
        first = n_first;
        nch = n_nch;
        r0 = __ldcg(a.rlane + 3 * lane_id);
        r1 = __ldcg(a.rlane + 3 * lane_id + 1);
      }
    } else {
      j += 1;
    }
    staged = n_staged;
  }
}

// Reservoir finish over lanes [lo, hi): each lane that scanned takes its
// best word's position (clipped into [0, deg - 1]), resets the word,
// gathers the column and advances (counted in the pre-pass).
template <bool kRecord>
__device__ __forceinline__ void reservoir_finish(const Args& a, int lo,
                                                 int hi) {
#pragma unroll 1
  for (int i = lo; i < hi; ++i) {
    if (a.rlane[3 * i + 2].y == 0) continue;
    const int4 r0 = a.rlane[3 * i];
    const int tier = a.rlane[3 * i + 1].w;
    const unsigned long long best = __ldcg(a.best + i);
    __stcg(a.best + i, 0ull);
    const int pos = static_cast<int>(0xffffffffu -
                                     static_cast<unsigned>(best & 0xffffffffu));
    const int idx = clampi(pos, 0, max(r0.w - 1, 0));
    int nxt;
    if (tier != kGraph) {
      const int* cb =
          tier == kShared ? shared_block<kReservoir>() : a.cache;
      nxt = cb[a.c_col + clampi(r0.z + idx, 0, a.cache_entries - 1)];
    } else {
      nxt = __ldg(a.col + clampi(r0.z + idx, 0, a.num_edges - 1));
    }
    int steps = 0, term = 0;
    finish_lane<kRecord>(a, i, a.v_curr[i], a.hop[i], a.query_id[i], false,
                         true, nxt, &steps, &term);
  }
}

// ------------------------------------------------------- block and grid

// Publishes this thread's part of the block's record: v summed over the
// block, plus the cache counters that cache_resolve left in s_cnt (which
// are reset), goes to `rec` (kPartWords int32), and the exclusive prefix
// over the threads (thread order) of v[kPFree] and v[kPChunks] to
// *free_rank and *chunk_rank.  Every thread calls it.
__device__ void publish(const int (&v)[kPartWords], int* rec, int* s_red,
                        int* s_cnt, int* free_rank, int* chunk_rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x[kPartWords];
  int fr = v[kPFree], ch = v[kPChunks];
#pragma unroll
  for (int f = 0; f < kPartWords; ++f) x[f] = v[f];
  for (int o = 1; o < 32; o <<= 1) {   // inclusive scans of free, chunks
    const int yf = __shfl_up_sync(kFullMask, fr, o);
    const int yc = __shfl_up_sync(kFullMask, ch, o);
    if (lane >= o) {
      fr += yf;
      ch += yc;
    }
  }
#pragma unroll
  for (int f = 0; f < kPartWords; ++f)
    for (int o = 16; o > 0; o >>= 1)
      x[f] += __shfl_xor_sync(kFullMask, x[f], o);
  __syncthreads();   // the scratch's previous readers are done
  if (lane == 0)
    for (int f = 0; f < kPartWords; ++f) s_red[warp * kPartWords + f] = x[f];
  __syncthreads();
  int bf = 0, bc = 0;
  for (int w = 0; w < warp; ++w) {
    bf += s_red[w * kPartWords + kPFree];
    bc += s_red[w * kPartWords + kPChunks];
  }
  *free_rank = bf + fr - v[kPFree];
  *chunk_rank = bc + ch - v[kPChunks];
  if (threadIdx.x < kPartWords) {
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += s_red[w * kPartWords + threadIdx.x];
    if (threadIdx.x >= kPHits && threadIdx.x <= kPCoalesced)
      sum += atomicExch(s_cnt + threadIdx.x - kPHits, 0);
    __stcg(rec + threadIdx.x, sum);
  }
}

// After a grid barrier: every block's record of `slot` summed into
// s_tot[0, kPartWords), the free lanes of the blocks before this one into
// s_tot[kPartWords]; with `base` (the reservoir), base[b] = the chunks of
// the blocks before b (G <= blockDim.x).  Every thread calls it.
__device__ void gather(const int* slot, int* s_red, int* s_tot, int* base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  constexpr int kN = kPartWords + 1;
  int x[kN] = {};
  int chunks = 0;
#pragma unroll 4
  for (int j = threadIdx.x; j < gridDim.x; j += blockDim.x) {
    const int4 p0 = __ldcg(reinterpret_cast<const int4*>(slot + j * kPartWords));
    const int4 p1 =
        __ldcg(reinterpret_cast<const int4*>(slot + j * kPartWords + 4));
    x[0] += p0.x;
    x[1] += p0.y;
    x[2] += p0.z;
    x[3] += p0.w;
    x[4] += p1.x;
    x[5] += p1.y;
    x[6] += p1.z;
    x[7] += p1.w;
    x[kPartWords] += j < static_cast<int>(blockIdx.x) ? p0.z : 0;
    chunks = p0.w;   // one record a thread when base is asked for
  }
  int incl = chunks;
  if (base != nullptr)
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
#pragma unroll
  for (int f = 0; f < kN; ++f)
    for (int o = 16; o > 0; o >>= 1)
      x[f] += __shfl_xor_sync(kFullMask, x[f], o);
  __syncthreads();   // the scratch's previous readers are done
  if (lane == 0)
    for (int f = 0; f < kN; ++f) s_red[warp * (kN + 1) + f] = x[f];
  if (lane == 31) s_red[warp * (kN + 1) + kN] = incl;
  __syncthreads();
  if (threadIdx.x < kN) {
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += s_red[w * (kN + 1) + threadIdx.x];
    s_tot[threadIdx.x] = sum;
  }
  if (base != nullptr && threadIdx.x < gridDim.x) {
    int before = 0;
    for (int w = 0; w < warp; ++w) before += s_red[w * (kN + 1) + kN];
    base[threadIdx.x] = before + incl - chunks;
  }
  __syncthreads();
}

template <int kKind, bool kStop, bool kRecord, bool kStatic>
__global__ void __launch_bounds__(max_threads(kKind), 1)
fused_superstep_kernel(const Args a) {
  // The queue counters and the live count, the same in every block: head
  // and live double-buffered by superstep parity (thread 0 writes the next
  // superstep's while the others still read this one's), so that they
  // hold no register through the lane passes.
  __shared__ long long s_head[2], s_staged, s_tail;
  __shared__ int s_live[2];
  __shared__ long long s_stats[kNumStats];   // block 0's
  __shared__ int s_cnt[3];                   // cache hits, misses, coalesced
  __shared__ int s_red[kMaxWarps * (kPartWords + 2)];
  __shared__ int s_tot[kPartWords + 1];
  __shared__ int s_base[kKind == kReservoir ? kMaxBlocks : 1];
  constexpr bool kRes = kKind == kReservoir;
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int b_lo = block_lane(a.width, blockIdx.x);
  const int b_hi = block_lane(a.width, blockIdx.x + 1);
  const int per = (b_hi - b_lo + blockDim.x - 1) / blockDim.x;
  const int lo = min(b_lo + tid * per, b_hi);
  const int hi = min(lo + per, b_hi);

  if (tid == 0) {
    if (blockIdx.x == 0) {
      for (int s = 0; s < kNumStats; ++s) s_stats[s] = a.ctl[kCtlStats + s];
      s_stats[kLaunches] += 1;   // once per launch, work or not
    }
    s_head[0] = a.ctl[kCtlHead];
    s_staged = a.ctl[kCtlStaged];
    s_tail = a.ctl[kCtlTail];
    long long* hist = a.hist + blockIdx.x * (a.delay + 1LL);
    for (int j = 0; j <= a.delay; ++j) hist[j] = a.ctl[kCtlHist + j];
    s_cnt[0] = s_cnt[1] = s_cnt[2] = 0;
  }
  if (a.num_hot > 0) {
    // Stage the cache's block into shared memory (16 bytes a load where
    // it fits), and empty this thread's range of both tag tables.
    if (a.cache_words > 0) {
      const int n4 = a.cache_words / 4;
      const int4* src = reinterpret_cast<const int4*>(a.cache);
      int4* blk = reinterpret_cast<int4*>(shared_block<kKind>());
      for (int w = tid; w < n4; w += blockDim.x) blk[w] = src[w];
      int* dst = reinterpret_cast<int*>(blk);
      for (int w = 4 * n4 + tid; w < a.cache_words; w += blockDim.x)
        dst[w] = a.cache[w];
    }
#pragma unroll 1
    for (int i = lo; i < hi; ++i) {
      __stcg(a.tags + i, ~0ull);
      __stcg(a.tags + a.width + i, ~0ull);
    }
  }
  if (kRes)
    for (int i = lo; i < hi; ++i) __stcg(a.best + i, 0ull);
  {
    int v[kPartWords] = {};
    for (int i = lo; i < hi; ++i) v[kPLive] += a.active[i] == kLive;
    int fr, cr;
    publish(v, a.part + blockIdx.x * kPartWords, s_red, s_cnt, &fr, &cr);
  }
  grid.sync();
  gather(a.part, s_red, s_tot, nullptr);   // record slot 0
  if (tid == 0) s_live[0] = s_tot[kPLive];
  __syncthreads();

  int step = 0;
  for (; step < a.k; ++step) {
    if (!(s_head[step & 1] < s_tail || s_live[step & 1] > 0)) break;

    if (a.num_hot > 0) {   // grid-uniform; this superstep's tag table
      unsigned long long* tags = a.tags + (step & 1) * (a.width + 0LL);
      cache_fill(a, tags, lo, hi);
      grid.sync();
      if (a.cache_words == 0)
        cache_resolve<kKind, kGlobal>(a, tags, lo, hi, s_cnt);
      else
        cache_resolve<kKind, kShared>(a, tags, lo, hi, s_cnt);
    }

    // The lanes, uncached then cached (one loop after the other, so the
    // cached pass's registers are not live beside the uncached pass's);
    // the reservoir's pre-pass takes both.
    int v[kPartWords] = {};
    if constexpr (kRes) {
      reservoir_prepass<kStop, kRecord>(a, lo, hi, v);
    } else {
      int n_steps = 0, n_term = 0;
      if constexpr (kKind == kRejection) {
        for (int i = lo; i < hi; ++i)
          process_lane_rejection<kStop, kRecord, kGraph>(a, i, &n_steps,
                                                         &n_term);
        if (a.num_hot > 0)
          for_cached_lanes(a, lo, hi, LanePassRejection<kStop, kRecord>{
                                          a, &n_steps, &n_term});
      } else {
        for (int i = lo; i < hi; ++i)
          process_lane<kKind, kStop, kRecord, kGraph>(a, i, &n_steps,
                                                      &n_term);
        if (a.num_hot > 0)
          for_cached_lanes(a, lo, hi, LanePass<kKind, kStop, kRecord>{
                                          a, &n_steps, &n_term});
      }
      v[kPSteps] = n_steps;
      v[kPTerm] = n_term;
      for (int i = lo; i < hi; ++i) v[kPFree] += a.active[i] != kLive;
    }
    // Records: slot 0 took the launch's live counts; superstep s writes
    // slot (s + 1) & 1.
    int* const slot = a.part + ((step + 1) & 1) * G * kPartWords;
    int free_rank, chunk_rank;
    publish(v, slot + blockIdx.x * kPartWords, s_red, s_cnt, &free_rank,
            &chunk_rank);
    if constexpr (kRes) {   // each lane's first item inside its block
      for (int i = lo; i < hi; ++i) {
        a.rlane[3 * i + 2].x = chunk_rank;
        chunk_rank += a.rlane[3 * i + 2].y;
      }
    }
    grid.sync();
    gather(slot, s_red, s_tot, kRes ? s_base : nullptr);
    if constexpr (kRes) {
      reservoir_scan(a, s_base, s_tot[kPChunks]);
      grid.sync();
      reservoir_finish<kRecord>(a, lo, hi);
    }

    const int cur = step & 1;
    if (tid == 0) {
      const long long head = s_head[cur], tail = s_tail;
      const int live = s_live[cur], term = s_tot[kPTerm];
      if (blockIdx.x == 0) {
        // Stats: idle and upstream from the superstep's start.
        const long long idle = a.width - live;
        s_stats[kSteps] += s_tot[kPSteps];
        s_stats[kSlotSteps] += a.width;
        s_stats[kBubbles] += idle;
        s_stats[kStarved] += head < tail ? idle : 0;
        s_stats[kTerminations] += term;
        s_stats[kSupersteps] += 1;
        s_stats[kCacheHits] += s_tot[kPHits];
        s_stats[kCacheMisses] += s_tot[kPMisses];
        s_stats[kCacheCoalesced] += s_tot[kPCoalesced];
      }
      // Controller: observe head C supersteps late (Theorem VI.1).
      long long* hist = a.hist + blockIdx.x * (a.delay + 1LL);
      const long long seen = a.delay == 0 ? head : hist[1];
      for (int j = 0; j < a.delay; ++j) hist[j] = hist[j + 1];
      hist[a.delay] = head;
      const long long staged = max(s_staged, min(seen + a.depth, tail));
      s_staged = staged;
      // The next superstep's head and live count: every free lane (all
      // of them, in static mode only once the pool has drained) takes a
      // staged arrival while there are any.
      const bool all_free = !kStatic || live - term == 0;
      const long long taken =
          all_free ? min(static_cast<long long>(s_tot[kPFree]),
                         max(staged - head, 0LL))
                   : 0;
      s_head[cur ^ 1] = head + taken;
      s_live[cur ^ 1] = live - term + static_cast<int>(taken);
    }
    __syncthreads();

    // Refill: free lanes take the next staged arrivals, ranked by an
    // exclusive prefix count of free lanes in lane order.
    const long long head = s_head[cur];
    const long long avail = s_head[cur ^ 1] - head;   // the arrivals taken
    const bool all_free = !kStatic || s_live[cur] - s_tot[kPTerm] == 0;
    int rank = s_tot[kPartWords] + free_rank;
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
      // Every lane has resolved against this superstep's table (a barrier
      // since): empty this lane's slot for the fill two supersteps on.
      if (a.num_hot > 0) __stcg(a.tags + cur * (a.width + 0LL) + i, ~0ull);
    }
  }

  if (blockIdx.x == 0 && tid == 0) {
    const int cur = step & 1;
    for (int s = 0; s < kNumStats; ++s) a.ctl[kCtlStats + s] = s_stats[s];
    a.ctl[kCtlHead] = s_head[cur];
    a.ctl[kCtlStaged] = s_staged;
    a.ctl[kCtlTail] = s_tail;
    a.ctl[kCtlWork] = (s_head[cur] < s_tail || s_live[cur] > 0) ? 1 : 0;
    a.ctl[kCtlSupersteps] = s_stats[kSupersteps];
    for (int j = 0; j <= a.delay; ++j) a.ctl[kCtlHist + j] = a.hist[j];
  }
}

// The grid of an instantiation: threads a block, blocks, blocks an SM.
struct Grid {
  int blocks, threads, per_sm;
};

// Sets the instantiation's dynamic shared-memory limit where smem needs it.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The grid for `width` lanes with `smem` bytes of the cache's block in
// dynamic shared memory, beside the kind's staging (stage_bytes):
// the reservoir takes every resident warp (1,024 threads a block); the
// other kinds one thread a lane, threads = width / #SMs rounded up to a
// warp (at most 512), blocks = width / threads; never more blocks than
// the occupancy API says are resident at once, nor than kMaxBlocks.
struct GridOf {
  int width;
  int smem;
  Grid* out;
  template <int kKind, bool kStop, bool kRecord, bool kStatic>
  int run() const {
    const auto kernel = fused_superstep_kernel<kKind, kStop, kRecord, kStatic>;
    const int total = stage_bytes(kKind) + smem;
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = allow_smem(kernel, total);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    int threads = max_threads(kKind);
    if (kKind != kReservoir) {
      const int per_sm_lanes = (width + sms - 1) / sms;
      threads = min(threads, max(32, (per_sm_lanes + 31) / 32 * 32));
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      total);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    int blocks = min(per_sm * sms, kMaxBlocks);
    if (kKind != kReservoir) blocks = min(blocks, (width + threads - 1) / threads);
    *out = Grid{blocks, threads, per_sm};
    return 0;
  }
};

// What a launch does with one instantiation of the kernel, picked by
// dispatch() from the run-time kind and flags.
struct Launch {   // launch it on `stream`
  const Args& a;
  Grid grid;
  int smem;       // dynamic shared-memory bytes (staging and cache block)
  cudaStream_t stream;

  template <int kKind, bool kStop, bool kRecord, bool kStatic>
  int run() const {
    const auto kernel = fused_superstep_kernel<kKind, kStop, kRecord, kStatic>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (grid.threads > max_threads(kKind) ||
        (kKind == kReservoir && grid.blocks > grid.threads))
      return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {const_cast<Args*>(&a)};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3(grid.blocks),
        dim3(grid.threads), args, static_cast<size_t>(smem), stream));
  }
};

struct SmemLimit {   // the shared memory its cache block can take, or -error
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
    return optin - static_cast<int>(attr.sharedSizeBytes) - stage_bytes(kKind);
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
// fused_superstep_grid writes the grid that the instantiation of (kind,
// stop_prob > 0, record_paths, static_mode) takes for `width` lanes with
// `smem` bytes of the cache's block in dynamic shared memory (after the
// reservoir's staging slots) on the current device, and the
// scratch bytes a launch of it needs with injection delay `delay`:
// out = {blocks, threads, blocks a multiprocessor, scratch bytes}.
// Returns 0 or a cudaError.
extern "C" int fused_superstep_grid(int kind, int stop, int record_paths,
                                    int static_mode, int width, int smem,
                                    int delay, long long* out) {
  if (width < 1 || delay < 0 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Grid g{};
  const int e = dispatch(GridOf{width, smem, &g}, kind, stop != 0,
                         record_paths != 0, static_mode != 0);
  if (e != 0) return e;
  out[0] = g.blocks;
  out[1] = g.threads;
  out[2] = g.per_sm;
  out[3] = layout(width, g.blocks, delay).bytes;
  return 0;
}

// fused_superstep launches a grid of `blocks` x `threads` (what
// fused_superstep_grid gave) cooperatively on `stream`, does not
// synchronise, and returns the launch's cudaError (a grid that cannot be
// resident is refused by the launch itself), or cudaErrorInvalidValue for
// an unknown kind, a width below 1, a grid outside [1, 512] blocks of a
// whole number of warps up to 1,024 threads, a reservoir grid of more
// blocks than threads, scratch smaller than its layout, a Node2Vec kind
// with rounds, chunk or bisect_iters below 1, or a cache without its
// block or probe trips.  num_hot = 0 runs without the cache; cache_words
// > 0 stages the block's first cache_words words into shared memory.
// `trace` is null, or (the reservoir kind) a schedule trace buffer
// (schedule.py's layout) whose named warp records what it issues.
extern "C" int fused_superstep(
    int* v_curr, int* v_prev, int* query_id, int* hop, uint8_t* active,
    int* epoch, const int* q_start, const int* q_order, const int* q_epoch,
    uint8_t* done, int* lengths, int* paths, long long* ctl,
    const int* row_ptr, const int* col, const float* alias_prob,
    const int* alias_idx, const int* type_offsets, const int* schedule,
    const float* weights, const int* cache, void* scratch,
    long long scratch_bytes, int width, int num_queries, int max_hops,
    int num_vertices, int num_edges, int type_stride, int schedule_len,
    int delay, int k, long long depth, unsigned int key0, unsigned int key1,
    float stop_prob, float inv_p, float inv_q, float w_max, int rounds,
    int chunk, int bisect_iters, int num_hot, int cache_entries,
    int probe_trips, int cache_words, int c_col, int c_wgt, int c_prob,
    int c_alias, int c_toff, int kind, int record_paths, int static_mode,
    int blocks, int threads, int* trace, void* stream) {
  if (width < 1 || delay < 0 || blocks < 1 || blocks > kMaxBlocks ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      scratch == nullptr ||
      scratch_bytes < layout(width, blocks, delay).bytes ||
      ((kind == kRejection || kind == kReservoir) &&
       (rounds < 1 || chunk < 1 || bisect_iters < 1)) ||
      (num_hot > 0 && (cache == nullptr || probe_trips < 1 ||
                       cache_entries < 1 || cache_words < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(width, blocks, delay);
  char* s = static_cast<char*>(scratch);
  const Args a{v_curr, v_prev, query_id, hop, active, epoch,
               q_start, q_order, q_epoch, done, lengths, paths, ctl,
               row_ptr, col, alias_prob, alias_idx, type_offsets, schedule,
               weights, width, num_queries, max_hops, num_vertices, num_edges,
               type_stride, schedule_len, delay, k, depth,
               make_uint2(key0, key1), stop_prob, inv_p, inv_q, w_max, rounds,
               chunk, bisect_iters, cache, max(num_hot, 0), cache_entries,
               probe_trips, num_hot > 0 ? cache_words : 0,
               c_col, c_wgt, c_prob, c_alias, c_toff,
               reinterpret_cast<unsigned long long*>(s + l.tags),
               reinterpret_cast<int*>(s + l.cslot),
               reinterpret_cast<unsigned long long*>(s + l.best),
               reinterpret_cast<int4*>(s + l.rlane),
               reinterpret_cast<int*>(s + l.part),
               reinterpret_cast<long long*>(s + l.hist), trace};
  const int smem = stage_bytes(kind) + (4 * a.cache_words + 15) / 16 * 16;
  return dispatch(Launch{a, Grid{blocks, threads, 0}, smem,
                         static_cast<cudaStream_t>(stream)},
                  kind, stop_prob > 0.0f, record_paths != 0,
                  static_mode != 0);
}

// The dynamic shared memory (bytes) that the cache's block can take in the
// instantiation of (kind, stop_prob > 0, record_paths, static_mode) on the
// current device: the opt-in limit less its static shared memory and its
// staging slots (the reservoir's, stage_bytes); a negative cudaError on
// failure.  A cache block up to this size is staged.
extern "C" int fused_superstep_smem_limit(int kind, int stop, int record_paths,
                                          int static_mode) {
  return dispatch(SmemLimit{}, kind, stop != 0, record_paths != 0,
                  static_mode != 0);
}
