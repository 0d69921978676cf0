// Embedding bag for Hopper (sm_90a): out[b] = sum_h w[b,h] * table[idx[b,h]].
//
// Replaces the TPU kernel
//   repro/kernels/embedding_bag/embedding_bag.py::_kernel (wrapper :84)
//
// What bounds it on the H100: bytes.  Each bag reads H table rows of D
// floats at random and writes one row; there is one multiply-add per float
// read, so the kernel moves rows and does next to no arithmetic.  The TPU
// kernel streamed the rows through VMEM with a double-buffered DMA per
// (bag, hot) pair; here one warp owns one bag, each lane a slice of its
// columns, so a row is read as one coalesced 512-byte request (D = 128:
// one float4 a lane) and the many resident warps keep enough rows in
// flight to hide the gather latency.  Nothing is staged in shared memory.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // one bag a warp

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The slot's row index and weight (w = 1 when no weights are given).
__device__ __forceinline__ void slot(const int* __restrict__ idx,
                                     const float* __restrict__ w, long long i,
                                     int rows, int* row, float* weight) {
  const int id = __ldg(idx + i);
  *row = clampi(id, 0, rows - 1);
  *weight = id < 0 ? 0.0f : (w == nullptr ? 1.0f : __ldg(w + i));
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
        const float4 x = __ldg(
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
        acc = term(__ldg(table + static_cast<long long>(r) * dim + c), wt, acc,
                   h);
      }
      o[c] = acc;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  `weights` may be null (every
// weight 1).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int embedding_bag(const int* indices, const float* weights,
                             const float* table, float* out, int bags,
                             int hots, int rows, int dim, int vec,
                             void* stream) {
  const int blocks = (bags + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    embedding_bag_kernel<true><<<blocks, kThreads, 0, s>>>(
        indices, weights, table, out, bags, hots, rows, dim);
  } else {
    embedding_bag_kernel<false><<<blocks, kThreads, 0, s>>>(
        indices, weights, table, out, bags, hots, rows, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
