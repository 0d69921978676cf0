// Segment sum for Hopper (sm_90a): out[s] = sum of data[e] over ids[e] == s.
//
// Replaces the TPU kernel
//   repro/kernels/segment_sum/segment_sum.py::_kernel (wrapper
//   segment_sum_sorted :120)
//
// The TPU kernel turned the scatter into one-hot (RB x TILE_E) @ (TILE_E x D)
// matmuls on the MXU over destination-sorted edge tiles, with a host plan
// (`plan_tiles`) of the row blocks each tile touches.  On Hopper a sorted
// segmented reduction needs neither.  One warp owns 32 consecutive output
// rows: it finds where the first one's run starts in the ascending ids by
// a 32-ary search (each lane probes one of 32 evenly spaced ids, a ballot
// counts the probes below the row; three rounds for 24,576 ids), then
// walks its rows in order, finding each row's run end by a 32-wide ballot
// scan from the previous end, summing the run's rows (each lane a slice of
// the columns: one float4 a lane at D = 128) and writing the row.  So
// every output row is written exactly once, in coalesced 16 KiB stretches
// a warp: an empty segment, and every row past the last id, is exactly 0.
//
// What bounds it: bytes.  The output is dense, (S, D) float32, and is
// written whole (512 MiB at S = 2^20, D = 128), against E x D floats read.
// A hub's run is summed by one warp, so a segment holding a large share of
// the ids is the launch's straggler.
//
// Order, for determinism: the sum starts from 0.0 and adds the run's rows
// in ascending position with IEEE round-to-nearest adds (__fadd_rn), so
// the result is the same every launch, and equal to index_add_ on the CPU
// over the ids in their original order when the ids came through a stable
// sort (the wrapper's `order`; null means the ids are already sorted and
// the data is in that order).  Ids outside [0, S) never match a row, so
// they are dropped.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 32;
constexpr unsigned kAll = 0xffffffffu;

// First position in ids[0, n) whose id is >= s (ids ascending), found by
// the whole warp: each round probes 32 evenly spaced ids of [lo, hi) and
// keeps the stretch after the last probe below s.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ ids,
                                                int n, long long s, int lane) {
  int lo = 0, hi = n;   // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool below = p < hi && __ldg(ids + p) < s;
    const int k = __popc(__ballot_sync(kAll, below));   // a prefix: sorted
    if (k == 0) {
      hi = lo;
    } else {
      const int next = lo + k * step;
      lo = lo + (k - 1) * step + 1;
      hi = next < hi ? next : hi;
    }
  }
  return lo;
}

__device__ __forceinline__ long long source(const long long* __restrict__ order,
                                            int e) {
  return order == nullptr ? e : __ldg(order + e);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ data,
                   const int* __restrict__ sorted_ids,
                   const long long* __restrict__ order,
                   float* __restrict__ out, int n, int num_segments, int dim) {
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  if (first >= num_segments) return;
  const long long last = first + kRowsPerWarp < num_segments
                             ? first + kRowsPerWarp : num_segments;
  int lo = warp_lower_bound(sorted_ids, n, first, lane);
  for (long long s = first; s < last; ++s) {
    // ids[lo..] >= s, so the ids equal to s are a prefix of them.
    int hi = lo;
    for (;;) {
      const int p = hi + lane;
      const int k = __popc(__ballot_sync(kAll, p < n && __ldg(sorted_ids + p) == s));
      hi += k;
      if (k < 32) break;
    }
    float* o = out + s * dim;
    if (kVec) {
      for (int c = lane; c < dim / 4; c += 32) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int e = lo; e < hi; ++e) {
          const float4 x = __ldg(
              reinterpret_cast<const float4*>(data + source(order, e) * dim) + c);
          acc.x = __fadd_rn(acc.x, x.x);
          acc.y = __fadd_rn(acc.y, x.y);
          acc.z = __fadd_rn(acc.z, x.z);
          acc.w = __fadd_rn(acc.w, x.w);
        }
        reinterpret_cast<float4*>(o)[c] = acc;
      }
    } else {
      for (int c = lane; c < dim; c += 32) {
        float acc = 0.0f;
        for (int e = lo; e < hi; ++e) {
          acc = __fadd_rn(acc, __ldg(data + source(order, e) * dim + c));
        }
        o[c] = acc;
      }
    }
    lo = hi;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  `sorted_ids` ascend; `order`
// (int64, may be null for the identity) maps a sorted position to its row
// of `data`.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int segment_sum(const float* data, const int* sorted_ids,
                           const long long* order, float* out, int n,
                           int num_segments, int dim, int vec, void* stream) {
  const long long rows_per_block = static_cast<long long>(kWarps) * kRowsPerWarp;
  const int blocks = static_cast<int>((num_segments + rows_per_block - 1) /
                                      rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    segment_sum_kernel<true><<<blocks, kThreads, 0, s>>>(
        data, sorted_ids, order, out, n, num_segments, dim);
  } else {
    segment_sum_kernel<false><<<blocks, kThreads, 0, s>>>(
        data, sorted_ids, order, out, n, num_segments, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
