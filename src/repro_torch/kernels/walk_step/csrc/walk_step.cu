// One-hop walk-step kernels for Hopper (sm_90a): Row Access -> Sampling ->
// Column Access for every walker lane, one thread per lane.
//
// Replaces the TPU kernels
//   repro/kernels/walk_step/walk_step.py::walk_step_uniform_kernel (URW, PPR)
//   repro/kernels/walk_step/walk_step.py::walk_step_alias_kernel   (DeepWalk)
//
// What bounds them on the H100: bytes and dependent latency, not arithmetic.
// Each lane does a handful of integer ops but a chain of two (uniform) or
// three (alias) dependent gathers: row_ptr[v], row_ptr[v+1] -> col[a+k]
// (alias: -> prob/alias[a+k] -> col[a+idx]).  The lane I/O (v, u, v_next,
// deg) is coalesced; every gather touches one 32-byte sector per lane.  The
// TPU kernel hid gather latency with double-buffered DMA loops over the
// lanes of a tile; here the resident warps of many blocks hide it, so the
// kernel is a straight-line gather chain with no staging.  At the walker's
// lane counts (thousands) a launch moves well under a megabyte, so launch
// overhead, not the gathers, dominates its time.
//
// The bounds mirror the reference's clips exactly: v clamps into
// [0, V-1]; an edge offset clamps into [0, E-1]; deg == 0 gives -1; with
// E == 0 no col/prob/alias word is read at all.  k is computed in float32
// as floor(u * float(deg)), rounded to nearest with no contraction
// (`walk::uniform_index`, shared with the fused superstep kernel).

#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using walk::clampi;
using walk::uniform_index;

constexpr int kThreads = 256;

// Row access: (addr, deg) of the clamped vertex; false when V == 0.
__device__ __forceinline__ bool row_access(const int* __restrict__ row_ptr,
                                           int v, int num_vertices, int* addr,
                                           int* deg) {
  if (num_vertices <= 0) return false;
  v = clampi(v, 0, num_vertices - 1);
  const int a = __ldg(row_ptr + v);
  const int b = __ldg(row_ptr + v + 1);
  *addr = a;
  *deg = b - a;
  return true;
}

__global__ void __launch_bounds__(kThreads)
walk_step_uniform_kernel(const int* __restrict__ v_curr,
                         const float* __restrict__ u_col,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         int* __restrict__ v_next, int* __restrict__ deg_out,
                         int width, int num_vertices, int num_edges) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= width) return;
  int addr = 0, deg = 0;
  row_access(row_ptr, v_curr[i], num_vertices, &addr, &deg);
  int out = -1;
  if (deg > 0 && num_edges > 0) {
    const int k = uniform_index(deg, u_col[i]);
    out = __ldg(col + clampi(addr + k, 0, num_edges - 1));
  }
  v_next[i] = out;
  deg_out[i] = deg;
}

__global__ void __launch_bounds__(kThreads)
walk_step_alias_kernel(const int* __restrict__ v_curr,
                       const float* __restrict__ u_col,
                       const float* __restrict__ u_acc,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ col,
                       const float* __restrict__ alias_prob,
                       const int* __restrict__ alias_idx,
                       int* __restrict__ v_next, int* __restrict__ deg_out,
                       int width, int num_vertices, int num_edges) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= width) return;
  int addr = 0, deg = 0;
  row_access(row_ptr, v_curr[i], num_vertices, &addr, &deg);
  int out = -1;
  if (deg > 0 && num_edges > 0) {
    const int k = uniform_index(deg, u_col[i]);
    const int ek = clampi(addr + k, 0, num_edges - 1);
    const int idx = u_acc[i] < __ldg(alias_prob + ek) ? k : __ldg(alias_idx + ek);
    out = __ldg(col + clampi(addr + idx, 0, num_edges - 1));
  }
  v_next[i] = out;
  deg_out[i] = deg;
}

inline int blocks_for(int width) { return (width + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of the launch.

extern "C" int walk_step_uniform(const int* v_curr, const float* u_col,
                                 const int* row_ptr, const int* col,
                                 int* v_next, int* deg, int width,
                                 int num_vertices, int num_edges,
                                 void* stream) {
  walk_step_uniform_kernel<<<blocks_for(width), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      v_curr, u_col, row_ptr, col, v_next, deg, width, num_vertices,
      num_edges);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int walk_step_alias(const int* v_curr, const float* u_col,
                               const float* u_acc, const int* row_ptr,
                               const int* col, const float* alias_prob,
                               const int* alias_idx, int* v_next, int* deg,
                               int width, int num_vertices, int num_edges,
                               void* stream) {
  walk_step_alias_kernel<<<blocks_for(width), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      v_curr, u_col, u_acc, row_ptr, col, alias_prob, alias_idx, v_next, deg,
      width, num_vertices, num_edges);
  return static_cast<int>(cudaGetLastError());
}
