// One-hop walk-step kernels for Hopper (sm_90a): Row Access -> Sampling ->
// Column Access for every walker lane, one thread per lane.
//
// Replaces the TPU kernels
//   repro/kernels/walk_step/walk_step.py::walk_step_uniform_kernel (URW, PPR)
//   repro/kernels/walk_step/walk_step.py::walk_step_alias_kernel   (DeepWalk)
//
// What bounds them on the H100: bytes and dependent latency, not arithmetic.
// Each lane does a handful of integer ops but a chain of dependent gathers:
// row_ptr[v], row_ptr[v+1] -> col[a+k] (uniform), or row_ptr ->
// {prob[a+k], alias[a+k]} -> col[a+idx] (alias).  The lane I/O (v, u,
// v_next, deg) is coalesced; every gather touches one 32-byte sector per
// lane.  The TPU kernel hid gather latency with double-buffered DMA loops
// over the lanes of a tile.  At the walker's lane counts (thousands) a
// launch moves well under a megabyte, so a launch takes its ramp plus one
// lane's chain of round trips, not the bytes' time.
//
// Both kernels are built for that:
//   - A grid over the card: kThreads = 32 threads a block, so the main
//     path's W = 4,096 lanes land on 128 of the 132 multiprocessors, not
//     on 16 blocks of 256, and the lanes' uncoalesced gathers pass through
//     128 SMs' load queues.  32, 64, 128 and 256 threads a block were
//     timed in turns for the uniform kernel on an NVIDIA H100 80GB HBM3
//     (700 W; PERF.md, by kernels/tuning/gather_variants.py): none was
//     faster than another, so 32, which spreads the lanes furthest, stays.
//   - A programmatic dependent launch: it may start while the kernel
//     before it on the stream drains (on the main path, the copy of the
//     last column uniform after its Threefry), and waits for that one
//     (wait_for_previous_kernel) before it reads v_curr or the uniforms,
//     so its launch and ramp overlap the other's tail.
//   - The lane inputs are loaded together (through L2: the kernel before
//     may have just written them), so the uniforms' loads sit beside v's
//     and not behind row_ptr.
//   - The alias kernel loads prob[a+k] and alias[a+k] in the same round
//     trip, and then picks the column offset: the chain is v -> row_ptr
//     -> {prob, alias} -> col, where a load of alias[a+k] behind the
//     accept test would be one more round trip for the lanes that reject
//     (and a warp waits for its slowest lane).
// Written as plain loads and a ternary, the compiler undoes both: the
// SASS of the first builds on an H100 (printed by
// kernels/tuning/gather_variants.py with `cuobjdump -sass`) had the
// uniforms' loads sunk into the deg > 0 branch, behind row_ptr's, and
// alias[a+k] loaded under the predicate that the accept test sets, after
// prob's load returned: the same chain as the 256-thread kernel before.
// So (1) `load_now` reads the uniforms with a volatile load (through L2,
// as __ldcg does), which the compiler does not move into the branch; and
// (2) the kernel computes the column offset of both outcomes and picks
// one with a mask that an empty asm statement hides from the compiler, so
// it cannot tell that alias[a+k] is needed only on reject.  In the SASS
// of this source both uniforms load before the branch, and prob and
// alias load unpredicated, back to back, before the compare.  (A ternary
// on alias[a+k] with its load made volatile was still predicated; the
// uniform kernel's u load issues beside row_ptr's as written.)
// The bounds mirror the reference's clips exactly: v clamps into
// [0, V-1]; an edge offset clamps into [0, E-1]; deg == 0 gives -1; with
// E == 0 no col/prob/alias word is read at all.  k is computed in float32
// as floor(u * float(deg)), rounded to nearest with no contraction
// (`walk::uniform_index`, shared with the fused superstep kernel).

#include <cuda_runtime.h>

#include "dependent_launch.cuh"
#include "walk_common.cuh"

namespace {

using walk::clampi;
using walk::launch_dependent;
using walk::uniform_index;
using walk::wait_for_previous_kernel;

constexpr int kThreads = 32;   // both kernels' blocks

// *p, loaded where it is written: a volatile load, which the compiler does
// not sink into a branch (see above).
__device__ __forceinline__ float load_now(const float* p) {
  float x;
  asm volatile("ld.volatile.global.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}

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
  wait_for_previous_kernel();   // v_curr and u_col
  const int v = __ldcg(v_curr + i);
  const float u = __ldcg(u_col + i);
  int addr = 0, deg = 0;
  row_access(row_ptr, v, num_vertices, &addr, &deg);
  int out = -1;
  if (deg > 0 && num_edges > 0) {
    const int k = uniform_index(deg, u);
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
  wait_for_previous_kernel();   // v_curr, u_col and u_acc
  const int v = __ldcg(v_curr + i);
  const float uc = load_now(u_col + i);
  const float ua = load_now(u_acc + i);
  int addr = 0, deg = 0;
  row_access(row_ptr, v, num_vertices, &addr, &deg);
  int out = -1;
  if (deg > 0 && num_edges > 0) {
    const int k = uniform_index(deg, uc);
    const int ek = clampi(addr + k, 0, num_edges - 1);
    const float prob = __ldg(alias_prob + ek);   // one round trip for both
    const int alias = __ldg(alias_idx + ek);
    const int ea = clampi(addr + alias, 0, num_edges - 1);
    unsigned accept = ua < prob ? ~0u : 0u;
    asm("" : "+r"(accept));   // which outcome: hidden (see above)
    out = __ldg(col + (accept ? ek : ea));
  }
  v_next[i] = out;
  deg_out[i] = deg;
}

inline int blocks_for(int width, int threads) {
  return (width + threads - 1) / threads;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns the launch's cudaError.

extern "C" int walk_step_uniform(const int* v_curr, const float* u_col,
                                 const int* row_ptr, const int* col,
                                 int* v_next, int* deg, int width,
                                 int num_vertices, int num_edges,
                                 void* stream) {
  return static_cast<int>(launch_dependent(
      walk_step_uniform_kernel, blocks_for(width, kThreads),
      kThreads, static_cast<cudaStream_t>(stream), v_curr, u_col,
      row_ptr, col, v_next, deg, width, num_vertices, num_edges));
}

extern "C" int walk_step_alias(const int* v_curr, const float* u_col,
                               const float* u_acc, const int* row_ptr,
                               const int* col, const float* alias_prob,
                               const int* alias_idx, int* v_next, int* deg,
                               int width, int num_vertices, int num_edges,
                               void* stream) {
  return static_cast<int>(launch_dependent(
      walk_step_alias_kernel, blocks_for(width, kThreads), kThreads,
      static_cast<cudaStream_t>(stream), v_curr, u_col, u_acc, row_ptr, col,
      alias_prob, alias_idx, v_next, deg, width, num_vertices, num_edges));
}
