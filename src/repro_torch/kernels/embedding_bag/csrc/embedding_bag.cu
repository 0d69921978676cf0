// Embedding bag for Hopper (sm_90a): out[b] = sum_h w[b,h] * table[idx[b,h]].
//
// Replaces the TPU kernel
//   repro/kernels/embedding_bag/embedding_bag.py::_kernel (wrapper :84)
//
// What bounds it on the H100: bytes, and the launch.  Each bag reads H
// table rows of D floats at random and writes one row; there is one
// multiply-add per float read, so the kernel moves rows and does next to
// no arithmetic.  The SGNS step's gathers (H = 1, D = 128, B = 4,096 and
// 20,480 over a 512 MiB table) read 2 and 10 MiB of random rows.  On an
// H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md) a call from a cold L2
// takes its rows' time from device memory past the launch floor, plus,
// when the kernel before left L2 dirty (AdamW has just rewritten the
// tables), the write-back of the lines its rows and outputs evict; a warm
// call runs at L2's rate.  What is left to win is the launch: a few
// microseconds a call, against 1.5-10 of work.
//
// What the design does about it:
//   - A programmatic dependent launch: the kernel may start while the
//     kernel before it on the stream drains, and waits for it
//     (wait_for_previous_kernel) before it reads an index, so its launch
//     and ramp overlap that kernel's tail.  The SGNS step's three gathers
//     run back to back, so two of the three overlap a gather.
//   - One warp a bag, each lane a slice of the columns, so a row is one
//     coalesced 512-byte request (D = 128: one float4 a lane) and the
//     lanes' index load is one broadcast request a warp.  32 registers a
//     thread, so 8 blocks of 256 threads a multiprocessor and 64 rows in
//     flight on each; the blocks of a large B follow each other as slots
//     free up.
//   - Every load goes through L2 (__ldcg): a dependent launch must not
//     meet a line that L1 kept from before the kernel it waited for, and
//     a row read once gains nothing from L1.
// Timed against it in turns on the same card and not kept
// (kernels/tuning/gather_variants.cu; PERF.md): a grid of only the
// resident blocks, its warps walking the bags in grid-stride order (at
// parity); a warp that loads its run's indices 32 at a time, hands them
// out by __shfl_sync and keeps 4 or 8 rows a lane in flight (57-96
// registers, 2-4 blocks a multiprocessor: at parity or slower cold,
// slower warm); L1 no-allocate or evict-first row loads (slower warm).
//
// Arithmetic, kept bit-equal to the plain version (ref.py) and to the
// reference: slot h = 0 sets the sum to row * w (a rounded product, not
// 0 + product); each later slot is an IEEE fused multiply-add
// fma(row, w, sum), in h order, as XLA compiles the reference's
// `acc + row * w`.  A slot with idx < 0 has w = 0 and still adds row * 0
// (so a signed zero or a NaN in the row shows, as in the reference); ids
// clamp into [0, R-1].  Rows are read as float4 when D % 4 == 0 and the
// table and output are 16-byte aligned (the wrapper decides), else one
// float a lane.

#include <cuda_runtime.h>

#include "dependent_launch.cuh"

namespace {

using walk::launch_dependent;
using walk::wait_for_previous_kernel;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The slot's row index and weight (w = 1 when no weights are given).
__device__ __forceinline__ void slot(const int* __restrict__ idx,
                                     const float* __restrict__ w, long long i,
                                     int rows, int* row, float* weight) {
  const int id = __ldcg(idx + i);
  *row = clampi(id, 0, rows - 1);
  *weight = id < 0 ? 0.0f : (w == nullptr ? 1.0f : __ldcg(w + i));
}

__device__ __forceinline__ float term(float x, float wt, float acc, int h) {
  return h == 0 ? __fmul_rn(x, wt) : __fmaf_rn(x, wt, acc);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                     const float* __restrict__ table, float* __restrict__ out,
                     int bags, int hots, int rows, int dim) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (bag >= bags) return;
  wait_for_previous_kernel();   // idx, w and the table
  const long long first = bag * hots;
  float* o = out + bag * dim;
  if (kVec) {
    const int quads = dim / 4;
    for (int c = lane; c < quads; c += 32) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int h = 0; h < hots; ++h) {
        int r;
        float wt;
        slot(idx, w, first + h, rows, &r, &wt);
        const float4 x = __ldcg(
            reinterpret_cast<const float4*>(table + static_cast<long long>(r) * dim) + c);
        acc.x = term(x.x, wt, acc.x, h);
        acc.y = term(x.y, wt, acc.y, h);
        acc.z = term(x.z, wt, acc.z, h);
        acc.w = term(x.w, wt, acc.w, h);
      }
      reinterpret_cast<float4*>(o)[c] = acc;
    }
  } else {
    for (int c = lane; c < dim; c += 32) {
      float acc = 0.0f;
      for (int h = 0; h < hots; ++h) {
        int r;
        float wt;
        slot(idx, w, first + h, rows, &r, &wt);
        acc = term(__ldcg(table + static_cast<long long>(r) * dim + c), wt,
                   acc, h);
      }
      o[c] = acc;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  `weights` may be null (every
// weight 1).  Launches on `stream`, does not synchronise, and returns the
// launch's cudaError.
extern "C" int embedding_bag(const int* indices, const float* weights,
                             const float* table, float* out, int bags,
                             int hots, int rows, int dim, int vec,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (bags + kWarps - 1) / kWarps;
  return static_cast<int>(
      vec ? launch_dependent(embedding_bag_kernel<true>, blocks, kThreads, s,
                             indices, weights, table, out, bags, hots, rows,
                             dim)
          : launch_dependent(embedding_bag_kernel<false>, blocks, kThreads, s,
                             indices, weights, table, out, bags, hots, rows,
                             dim));
}
