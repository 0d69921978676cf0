// Fused superstep kernel for Hopper (sm_90a): k whole supersteps of the
// walk engine per launch, in one persistent thread block.
//
// Replaces the TPU kernel
//   repro/kernels/fused_superstep/fused_superstep.py::fused_superstep_kernel
// for its uniform (URW, and PPR with the stop draw), alias (DeepWalk),
// metapath, rejection (unweighted Node2Vec, `_rejection_sample`) and
// reservoir (weighted Node2Vec, `_reservoir_sample`) branches.  The
// hot-vertex cache tier is not ported; the wrapper raises for it.
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
    if (live[j])
      finish_lane<kRecord>(a, base + j, v[j], h[j], q[j], stop[j], deg[j] > 0,
                           nxt[j], n_steps, n_term);
  }
}

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
// round wins, so the loop ends there.  Returns the chosen column.
__device__ __forceinline__ int rejection_pick(const Args& a, uint2 pk,
                                              int addr, int deg, int vp,
                                              int plo, int phi) {
  const uint2 ck = walk::fold_in(pk, walk::kSaltColumn);
  int y[1] = {-1};
  for (int j = 0; j < a.rounds; ++j) {
    const uint2 r = walk::threefry2x32(ck.x, ck.y, static_cast<uint32_t>(j),
                                       static_cast<uint32_t>(j + a.rounds));
    const int prop = uniform_index(deg, walk::bits_to_uniform(r.x));
    y[0] = __ldg(a.col + clampi(addr + prop, 0, a.num_edges - 1));
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
// same one.  Returns the chosen offset, clipped into [0, deg - 1].
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
        const int e = clampi(addr + base + t[n], 0, a.num_edges - 1);
        y[n] = valid[n] ? __ldg(a.col + e) : -1;
        w_edge[n] = valid[n] ? (a.weights ? __ldg(a.weights + e) : 1.0f)
                             : 0.0f;
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
// advance.
template <int kKind, bool kStop, bool kRecord>
__device__ __forceinline__ void process_lane_n2v(const Args& a, int i,
                                                 int* n_steps, int* n_term) {
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
    const int vc = clampi(v, 0, a.num_vertices - 1);
    addr = __ldg(a.row_ptr + vc);
    const int end = __ldg(a.row_ptr + vc + 1);
    deg = (v >= 0 && v < a.num_vertices) ? end - addr : 0;
  }
  int nxt = -1;
  if (!stop && deg > 0 && a.num_edges > 0) {
    const int vp = a.v_prev[i];
    const int vpc = clampi(vp, 0, a.num_vertices - 1);
    const int plo = __ldg(a.row_ptr + vpc);
    const int phi = __ldg(a.row_ptr + vpc + 1);
    if (kKind == kRejection) {
      nxt = rejection_pick(a, pk, addr, deg, vp, plo, phi);
    } else {
      const int idx = reservoir_pick(a, pk, addr, deg, vp, plo, phi);
      nxt = __ldg(a.col + clampi(addr + idx, 0, a.num_edges - 1));
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
    if constexpr (kKind == kRejection || kKind == kReservoir) {
      for (int i = lo; i < hi; ++i)
        process_lane_n2v<kKind, kStop, kRecord>(a, i, &n_steps, &n_term);
    } else {
      for (int base = lo; base < hi; base += kChunk)
        process_chunk<kKind, kStop, kRecord>(a, base, hi, &n_steps, &n_term);
    }
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
// cudaErrorInvalidValue for an unknown kind, a width below 1, or a
// Node2Vec kind with rounds, chunk or bisect_iters below 1).
extern "C" int fused_superstep(
    int* v_curr, int* v_prev, int* query_id, int* hop, uint8_t* active,
    int* epoch, const int* q_start, const int* q_order, const int* q_epoch,
    uint8_t* done, int* lengths, int* paths, long long* ctl,
    const int* row_ptr, const int* col, const float* alias_prob,
    const int* alias_idx, const int* type_offsets, const int* schedule,
    const float* weights, int width, int num_queries, int max_hops,
    int num_vertices, int num_edges, int type_stride, int schedule_len,
    int delay, int k, long long depth, unsigned int key0, unsigned int key1,
    float stop_prob, float inv_p, float inv_q, float w_max, int rounds,
    int chunk, int bisect_iters, int kind, int record_paths, int static_mode,
    void* stream) {
  if (width < 1 || ((kind == kRejection || kind == kReservoir) &&
                    (rounds < 1 || chunk < 1 || bisect_iters < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{v_curr, v_prev, query_id, hop, active, epoch,
               q_start, q_order, q_epoch, done, lengths, paths, ctl,
               row_ptr, col, alias_prob, alias_idx, type_offsets, schedule,
               weights, width, num_queries, max_hops, num_vertices, num_edges,
               type_stride, schedule_len, delay, k, depth,
               make_uint2(key0, key1), stop_prob, inv_p, inv_q, w_max, rounds,
               chunk, bisect_iters};
  const bool record = record_paths != 0, st = static_mode != 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kUniform: return launch_stop<kUniform>(a, record, st, s);
    case kAlias: return launch_stop<kAlias>(a, record, st, s);
    case kMetapath: return launch_stop<kMetapath>(a, record, st, s);
    case kRejection: return launch_stop<kRejection>(a, record, st, s);
    case kReservoir: return launch_stop<kReservoir>(a, record, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
