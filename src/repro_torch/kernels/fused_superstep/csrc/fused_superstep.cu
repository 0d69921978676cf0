// Fused superstep kernel for Hopper (sm_90a): k whole supersteps of the
// walk engine per launch, in one persistent thread block.
//
// Replaces the TPU kernel
//   repro/kernels/fused_superstep/fused_superstep.py::fused_superstep_kernel
// for its uniform (URW, and PPR with the stop draw), alias (DeepWalk) and
// metapath branches.  The Node2Vec branches and the hot-vertex cache tier
// are not ported; the wrapper raises for them.
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
// gives the lane a new query or frees it.

#include <cuda_runtime.h>

#include <cstdint>

#include "walk_common.cuh"

namespace {

using walk::clampi;
using walk::uniform_index;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunk = 4;           // lanes a thread carries through a pass
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kUniform = 0, kAlias = 1, kMetapath = 2 };

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

constexpr uint8_t kFree = 0, kLive = 1, kEnded = 2;

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
};

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

// One pass over up to kChunk of this thread's lanes, starting at `base`:
// draws, row access, pick, column gather, terminate and advance.  Adds the
// chunk's advancing and terminating lanes to *n_steps and *n_term.
template <int kKind, bool kStop, bool kRecord>
__device__ __forceinline__ void process_chunk(const Args& a, int base, int hi,
                                              int* n_steps, int* n_term) {
  bool live[kChunk], stop[kChunk];
  int v[kChunk], h[kChunk], q[kChunk], addr[kChunk], deg[kChunk];
  int idx[kChunk], nxt[kChunk];
  float u0[kChunk], u1[kChunk];
  const long long stride = static_cast<long long>(a.max_hops) + 1;

  // Draws: the stop draw (counter (0,0), word 0) and the column draw
  // (counter (0,0) word 0; alias: counter (0,1), words 0 and 1).
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
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
  for (int j = 0; j < kChunk; ++j) {
    addr[j] = 0;
    deg[j] = 0;
    if (!live[j] || a.num_vertices <= 0) continue;
    const int vc = clampi(v[j], 0, a.num_vertices - 1);
    addr[j] = __ldg(a.row_ptr + vc);
    const int end = __ldg(a.row_ptr + vc + 1);
    deg[j] = (v[j] >= 0 && v[j] < a.num_vertices) ? end - addr[j] : 0;
  }

  // Pick: the neighbor offset idx (before the column clamp).
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    idx[j] = addr[j];
    if (!live[j] || deg[j] <= 0) continue;
    if (kKind == kMetapath) {
      // Sub-segment of the scheduled type; none -> dead end.
      const int t = __ldg(a.schedule + h[j] % a.schedule_len);
      const long long row =
          static_cast<long long>(clampi(v[j], 0, a.num_vertices - 1)) *
          a.type_stride;
      const int lo = __ldg(a.type_offsets + row + t);
      const int cnt = __ldg(a.type_offsets + row + t + 1) - lo;
      idx[j] = addr[j] + lo + uniform_index(cnt, u0[j]);
      if (cnt <= 0) deg[j] = 0;
    } else if (kKind == kAlias) {
      // Keep draw k with probability prob[addr+k], else take alias[addr+k].
      if (a.num_edges <= 0) continue;
      const int kdraw = uniform_index(deg[j], u0[j]);
      const int e = clampi(addr[j] + kdraw, 0, a.num_edges - 1);
      const float p = __ldg(a.alias_prob + e);
      const int al = __ldg(a.alias_idx + e);
      const int pick = u1[j] < p ? kdraw : al;
      idx[j] = addr[j] + clampi(pick, 0, max(deg[j] - 1, 0));
    } else {
      idx[j] = addr[j] + uniform_index(deg[j], u0[j]);
    }
  }

  // Column access, clamped into [0, E-1]; no read when E == 0.
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    nxt[j] = -1;
    if (live[j] && deg[j] > 0 && a.num_edges > 0)
      nxt[j] = __ldg(a.col + clampi(idx[j], 0, a.num_edges - 1));
  }

  // Terminate and advance.
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (!live[j]) continue;
    const int i = base + j;
    const bool ok = deg[j] > 0;
    const bool adv = !stop[j] && ok;
    const int nh = adv ? h[j] + 1 : h[j];
    const bool term = stop[j] || !ok || nh >= a.max_hops;
    if (adv) {
      a.v_prev[i] = v[j];
      a.v_curr[i] = nxt[j];
      a.hop[i] = nh;
      if (kRecord) {
        a.lengths[q[j]] = nh + 1;
        a.paths[q[j] * stride + nh] = nxt[j];
      }
    }
    if (term) {
      a.done[q[j]] = 1;
      a.active[i] = kEnded;
    }
    *n_steps += adv;
    *n_term += term;
  }
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
  const long long stride = static_cast<long long>(a.max_hops) + 1;
  long long* hist = a.ctl + kCtlHist;

  if (tid == 0) {
    for (int s = 0; s < kNumStats; ++s) s_stats[s] = a.ctl[kCtlStats + s];
    s_stats[kLaunches] += 1;   // once per launch, work or not
    s_head = a.ctl[kCtlHead];
    s_staged = a.ctl[kCtlStaged];
    s_tail = a.ctl[kCtlTail];
  }
  int n_active = block_sum(count_live(a.active, lo, hi), s_scratch);

  for (int step = 0; step < a.k; ++step) {
    const long long head = s_head;
    const long long tail = s_tail;
    if (!(head < tail || n_active > 0)) break;   // block-uniform: no work

    int n_steps = 0, n_term = 0;
    for (int base = lo; base < hi; base += kChunk)
      process_chunk<kKind, kStop, kRecord>(a, base, hi, &n_steps, &n_term);
    n_steps = block_sum(n_steps, s_scratch);
    n_term = block_sum(n_term, s_scratch);

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
          a.paths[nq * stride] = start;
        }
      } else if (mark == kEnded) {
        a.query_id[i] = -1;
        a.active[i] = kFree;
      }
      rank += free;
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

template <int kKind, bool kStop, bool kRecord, bool kStatic>
int launch(const Args& a, cudaStream_t stream) {
  const int threads = min(kMaxThreads, (a.width + 31) / 32 * 32);
  fused_superstep_kernel<kKind, kStop, kRecord, kStatic>
      <<<1, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kKind, bool kStop, bool kRecord>
int launch_mode(const Args& a, bool static_mode, cudaStream_t stream) {
  return static_mode ? launch<kKind, kStop, kRecord, true>(a, stream)
                     : launch<kKind, kStop, kRecord, false>(a, stream);
}

template <int kKind, bool kStop>
int launch_record(const Args& a, bool record, bool static_mode,
                  cudaStream_t stream) {
  return record ? launch_mode<kKind, kStop, true>(a, static_mode, stream)
                : launch_mode<kKind, kStop, false>(a, static_mode, stream);
}

template <int kKind>
int launch_stop(const Args& a, bool record, bool static_mode,
                cudaStream_t stream) {
  return a.stop_prob > 0.0f
             ? launch_record<kKind, true>(a, record, static_mode, stream)
             : launch_record<kKind, false>(a, record, static_mode, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for an unknown kind or a width below 1).
extern "C" int fused_superstep(
    int* v_curr, int* v_prev, int* query_id, int* hop, uint8_t* active,
    int* epoch, const int* q_start, const int* q_order, const int* q_epoch,
    uint8_t* done, int* lengths, int* paths, long long* ctl,
    const int* row_ptr, const int* col, const float* alias_prob,
    const int* alias_idx, const int* type_offsets, const int* schedule,
    int width, int num_queries, int max_hops, int num_vertices,
    int num_edges, int type_stride, int schedule_len, int delay, int k,
    long long depth, unsigned int key0, unsigned int key1, float stop_prob,
    int kind, int record_paths, int static_mode, void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{v_curr, v_prev, query_id, hop, active, epoch,
               q_start, q_order, q_epoch, done, lengths, paths, ctl,
               row_ptr, col, alias_prob, alias_idx, type_offsets, schedule,
               width, num_queries, max_hops, num_vertices, num_edges,
               type_stride, schedule_len, delay, k, depth,
               make_uint2(key0, key1), stop_prob};
  const bool record = record_paths != 0, st = static_mode != 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kUniform: return launch_stop<kUniform>(a, record, st, s);
    case kAlias: return launch_stop<kAlias>(a, record, st, s);
    case kMetapath: return launch_stop<kMetapath>(a, record, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
