// Segment sum for Hopper (sm_90a): out[s] = sum of data[e] over ids[e] == s.
//
// Replaces the TPU kernel
//   repro/kernels/segment_sum/segment_sum.py::_kernel (wrapper
//   segment_sum_sorted :120)
//
// The TPU kernel turned the scatter into one-hot (RB x TILE_E) @ (TILE_E x D)
// matmuls on the MXU over destination-sorted edge tiles, with a host plan
// (`plan_tiles`) of the row blocks each tile touches.  On Hopper the sum
// needs neither a sort nor a plan: a deterministic sum needs only each
// segment's positions in ascending order, not a sorted id vector.
//
// What bounds it: bytes.  The output is dense, (S, D) float32, and is
// written whole (512 MiB at S = 2^20, D = 128), against E x D floats read;
// at the SGNS step's E (4,096 to 24,576) under 3% of the rows are non-empty.
// So a call is as fast as its zeros stream.
//
// What the design does about it.  One call is three launches:
//   1. fill: every output row's zeros (and a byte a position, `linked`,
//      to 0).  Nothing is loaded, so this is a plain fill: 128-thread
//      blocks of 16 rows (8 KiB at D = 128), 64 B a thread, 2,048
//      threads a multiprocessor, 0.165 ms for 512 MiB on an H100
//      (PERF.md).  A dense pass whose warps first loaded their rows'
//      chain heads, to skip the non-empty rows, took 0.189-0.199 ms:
//      under the pass's own write traffic a load takes microseconds, and
//      a block that waits on one holds its slot.
//   2. link: each position e with an id in [0, S) pushes itself onto its
//      segment's chain.  The chain's head is the first word of the
//      segment's own output row, which the fill has just zeroed, holding
//      the last linked position + 1: prev = atomicExch(row word, e + 1)
//      - 1, next[e] = prev, and linked[prev] = 1 (prev was displaced).
//      So no head array needs a reset.  Ids outside [0, S) are skipped,
//      so they are dropped.
//   3. rows: a warp a position, 1,536 threads a multiprocessor (at most
//      40 registers: the positions are latency-bound chains of loads, so
//      the warps in flight decide the time).  The position that was never
//      displaced (the chain's head) sums its segment's row and overwrites
//      the row, head word included; no warp reads a head word here, so
//      none can see it overwritten.  A position's id, linked byte and
//      next are loaded together, so a one-entry segment costs one round
//      of loads before its row's.
// A chain holds its positions in the arbitrary order the atomics ran in.
// The warp walks up to 32 of them into its lanes, sorts them (a bitonic
// sort over shuffles), and sums the rows in ascending position, 4 rows'
// loads in flight at a time.  A longer chain (a hub id drawn many times)
// is not walked: the warp scans the ids 32 at a time in position order
// (the next window's ids loading while this one's matches are summed), a
// ballot giving each window's matches in ascending order; so a hub of n
// rows costs E / 32 coalesced loads and ~n / 4 rounds of row loads on one
// warp.  Every chain lives in memory the call's
// fill has just written, so none outlives its call.
//
// Order, for determinism: the sum starts from 0.0 and adds the segment's
// rows in ascending position with IEEE round-to-nearest adds (__fadd_rn),
// so the result is the same every launch, and equal to index_add_ on the
// CPU over the ids in their original order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "dependent_launch.cuh"

namespace {

using walk::launch_dependent;
using walk::wait_for_previous_kernel;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 16;      // the fill: 2,048 threads a
                                      // multiprocessor, <= 32 registers
constexpr int kRowsBlocksPerSM = 12;  // the rows: <= 40 registers
constexpr int kRowsPerTile = 16;      // a fill block's rows: 8 KiB at D = 128
constexpr int kUnroll = 4;        // row loads in flight per warp
constexpr unsigned kAll = 0xffffffffu;

template <bool kVec>
__device__ __forceinline__ void store(float* o, int c, const float4& v) {
  if (kVec) __stcs(reinterpret_cast<float4*>(o) + c, v);
  else __stcs(o + c, v.x);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
segment_fill_kernel(float* __restrict__ out, uint8_t* __restrict__ linked,
                    int n, int num_segments, int dim) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kRowsPerTile;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kRowsPerTile), num_segments - first));
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads)
    linked[e] = 0;
  const int cols = kVec ? dim / 4 : dim;   // float4s or floats a row
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = warp; r < rows; r += kWarps) {
    float* o = out + (first + r) * dim;
    for (int c = lane; c < cols; c += 32) store<kVec>(o, c, zero);
  }
}

// A row's chain head while linking: the first word of the row itself
// (zeroed by the fill), holding the last linked position + 1.
__device__ __forceinline__ int* head_word(float* out, int id, int dim) {
  return reinterpret_cast<int*>(out + static_cast<long long>(id) * dim);
}

__global__ void __launch_bounds__(kThreads)
segment_link_kernel(const int* __restrict__ ids, float* __restrict__ out,
                    int* __restrict__ next, uint8_t* __restrict__ linked,
                    int n, int num_segments, int dim) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int id = e < n ? __ldg(ids + e) : -1;
  wait_for_previous_kernel();   // the fill's zeros
  if (id < 0 || id >= num_segments) return;
  const int prev = atomicExch(head_word(out, id, dim), e + 1) - 1;
  next[e] = prev;
  if (prev >= 0) linked[prev] = 1;   // displaced: not the chain's head
}

// Ascending sort of one int a lane over the warp (bitonic).
__device__ __forceinline__ int warp_sort(int v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(kAll, v, j);
      const bool keep_min = ((lane & k) == 0) == ((lane & j) == 0);
      v = keep_min ? min(v, other) : max(v, other);
    }
  }
  return v;
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x = __fadd_rn(acc.x, x.x);
  acc.y = __fadd_rn(acc.y, x.y);
  acc.z = __fadd_rn(acc.z, x.z);
  acc.w = __fadd_rn(acc.w, x.w);
}

// acc += data[e][c] for the positions e held in lanes [0, cnt) of `pos`
// (ascending), in that order; column c of this lane (float4 units when
// kVec).  Every lane of the warp calls it.
template <bool kVec>
__device__ __forceinline__ void accumulate(float4& acc, const float* data,
                                           int dim, int c, bool own, int pos,
                                           int cnt) {
  for (int b = 0; b < cnt; b += kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int e = __shfl_sync(kAll, pos, (b + j) & 31);
      x[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (own && b + j < cnt) {
        const long long row = static_cast<long long>(e) * dim;
        if (kVec)
          x[j] = __ldg(reinterpret_cast<const float4*>(data + row) + c);
        else
          x[j].x = __ldg(data + row + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (b + j < cnt) {
        if (kVec) add4(acc, x[j]);
        else acc.x = __fadd_rn(acc.x, x[j].x);
      }
  }
}

// Row s of a chain longer than 32 (a hub id drawn many times): the
// matches of each window of 32 ids, in position order (the next window's
// ids loading while this one's are summed).  Not inlined, so that its
// registers do not weigh on the short chains' path.  Every lane of the
// warp calls it.
template <bool kVec>
__device__ __noinline__ void sum_long_row(const float* __restrict__ data,
                                          const int* __restrict__ ids,
                                          float* o, int n, int dim, int s,
                                          int lane) {
  const int cols = kVec ? dim / 4 : dim;   // float4s or floats a row
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int c = c0 + lane;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int id = lane < n ? __ldg(ids + lane) : -1;
    for (int w0 = 0; w0 < n; w0 += 32) {
      const int e_next = w0 + 32 + lane;
      const int id_next = e_next < n ? __ldg(ids + e_next) : -1;
      const unsigned m = __ballot_sync(kAll, id == s);
      // Lane r takes the r-th match (ascending).
      int pos = 0, r = 0;
      for (unsigned mm = m; mm; mm &= mm - 1, ++r)
        if (lane == r) pos = w0 + __ffs(mm) - 1;
      accumulate<kVec>(acc, data, dim, c, c < cols, pos, r);
      id = id_next;
    }
    if (c < cols) store<kVec>(o, c, acc);
  }
}

// Row s, whose chain starts at position h (the head) and goes on at
// h_next: sum its rows in ascending position and store it.  x_h is this
// lane's column (c = lane) of row h, loaded already.  Every lane of the
// warp calls it.
template <bool kVec>
__device__ void sum_row(const float* __restrict__ data,
                        const int* __restrict__ ids,
                        const int* __restrict__ next, float* o, int n,
                        int dim, int s, int h, int h_next, float4 x_h,
                        int lane) {
  const int cols = kVec ? dim / 4 : dim;   // float4s or floats a row
  if (h_next < 0 && cols <= 32) {   // a one-row segment: 0.0 + row h
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    add4(acc, x_h);
    if (lane < cols) store<kVec>(o, lane, acc);
    return;
  }
  // Walk up to 32 chain entries, entry j into lane j.
  int mine = lane == 0 ? h : INT_MAX, cnt = 1, p = h_next;
  while (p >= 0 && cnt < 32) {
    if (lane == cnt) mine = p;
    p = __ldcg(next + p);
    ++cnt;
  }
  if (p < 0) {   // the whole chain: sort it and sum
    if (cnt > 1) mine = warp_sort(mine, lane);
    for (int c0 = 0; c0 < cols; c0 += 32) {
      const int c = c0 + lane;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      accumulate<kVec>(acc, data, dim, c, c < cols, mine, cnt);
      if (c < cols) store<kVec>(o, c, acc);
    }
    return;
  }
  sum_long_row<kVec>(data, ids, o, n, dim, s, lane);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kRowsBlocksPerSM)
segment_rows_kernel(const float* __restrict__ data,
                    const int* __restrict__ ids,
                    const int* __restrict__ next,
                    const uint8_t* __restrict__ linked,
                    float* __restrict__ out, int n, int num_segments,
                    int dim) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // The inputs first, while the link drains: the position's id and this
  // lane's column of its row.
  const int cols = kVec ? dim / 4 : dim;
  const int id = e < n ? __ldg(ids + e) : -1;
  float4 x_e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (e < n && lane < cols) {
    const long long row = static_cast<long long>(e) * dim;
    if (kVec) x_e = __ldg(reinterpret_cast<const float4*>(data + row) + lane);
    else x_e.x = __ldg(data + row + lane);
  }
  wait_for_previous_kernel();   // the link's chains
  if (id < 0 || id >= num_segments) return;
  const bool displaced = __ldcg(linked + e) != 0;
  const int e_next = __ldcg(next + e);
  // The chain's head position (the last linked, never displaced) owns the
  // row.
  if (displaced) return;
  sum_row<kVec>(data, ids, next, out + static_cast<long long>(id) * dim, n,
                dim, id, e, e_next, x_e, lane);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each issues its launch on
// `stream`, does not synchronise, and returns the launch's cudaError.
// `vec` takes float4 loads and stores (dim % 4 == 0, data and out
// 16-byte aligned; dim >= 1).  The link and the rows launch as
// programmatic dependents (launch_dependent), so each starts while the
// kernel before it drains.  `ids` in any order; `next` (n int32) and
// `linked` (n bytes) are scratch that a call overwrites (each at least
// one element).  segment_sum runs the three in order; chip_smoke.py times
// them apart.

// The fill: zeros into `out`, 0 into `linked`.
extern "C" int segment_sum_fill(float* out, uint8_t* linked, int n,
                                int num_segments, int dim, int vec,
                                void* stream) {
  const int tiles = (num_segments + kRowsPerTile - 1) / kRowsPerTile;
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    segment_fill_kernel<true><<<tiles, kThreads, 0, s>>>(
        out, linked, n, num_segments, dim);
  else
    segment_fill_kernel<false><<<tiles, kThreads, 0, s>>>(
        out, linked, n, num_segments, dim);
  return static_cast<int>(cudaGetLastError());
}

// The ordering: each position linked into its segment's chain.
extern "C" int segment_sum_link(const int* ids, float* out, int* next,
                                uint8_t* linked, int n, int num_segments,
                                int dim, void* stream) {
  if (n <= 0 || num_segments <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_dependent(
      segment_link_kernel, (n + kThreads - 1) / kThreads, kThreads,
      static_cast<cudaStream_t>(stream), ids, out, next, linked, n,
      num_segments, dim));
}

// The non-empty rows, over the chains that the link left.
extern "C" int segment_sum_rows(const float* data, const int* ids,
                                const int* next, const uint8_t* linked,
                                float* out, int n, int num_segments, int dim,
                                int vec, void* stream) {
  if (n <= 0 || num_segments <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_dependent(segment_rows_kernel<true>, blocks, kThreads, s,
                             data, ids, next, linked, out, n, num_segments,
                             dim)
          : launch_dependent(segment_rows_kernel<false>, blocks, kThreads, s,
                             data, ids, next, linked, out, n, num_segments,
                             dim));
}

// The whole sum (what the wrapper calls).
extern "C" int segment_sum(const float* data, const int* ids, float* out,
                           int* next, uint8_t* linked, int n,
                           int num_segments, int dim, int vec, void* stream) {
  int e = segment_sum_fill(out, linked, n, num_segments, dim, vec, stream);
  if (e == 0)
    e = segment_sum_link(ids, out, next, linked, n, num_segments, dim, stream);
  if (e == 0)
    e = segment_sum_rows(data, ids, next, linked, out, n, num_segments, dim,
                         vec, stream);
  return e;
}
