// Design variants of the embedding-bag and walk-step kernels, for
// gather_variants.py to build and time in turns on one card.  The walker
// never loads this file: the kernels it runs are embedding_bag.cu and
// walk_step.cu.  Each build picks one variant with -D flags:
//
//   EB_SPLIT   0: a warp a bag, one block per 8 bags (embedding_bag.cu);
//              1: the same warp body over a grid of only the resident
//                 blocks, each warp walking the bags in grid-stride order;
//              2: a grid of the resident blocks, each warp owning a
//                 contiguous run of bags, loading the run's slots 32 at a
//                 time (one a lane), handing each slot's (row, weight) out
//                 by __shfl_sync, and issuing EB_UNROLL row loads a lane
//                 before the first multiply-add.
//   EB_UNROLL  rows in flight a lane (EB_SPLIT 2), default 8.
//   EB_MINB    the kernel's minimum blocks a multiprocessor, default 1.
//   EB_LOAD    row loads: 0 __ldg, 1 __ldcg, 2 __ldcs (evict-first),
//              3 ld.global.nc.L1::no_allocate.
//   PDL        1: a programmatic dependent launch (griddepcontrol.wait
//              before the first read; indices through L2).
//   WS_THREADS the uniform walk step's threads a block, default 32.
//   WS_U_EARLY 1: u loaded beside v (walk_step.cu); 0: after row_ptr, in
//              the deg > 0 branch (the kernel before this redesign).
//   WA_THREADS the alias walk step's threads a block, default 32.
//   WA_EARLY   2: both uniforms loaded beside v with walk_step.cu's
//              load_now (a volatile load, issued where written), then
//              prob[a+k] and alias[a+k] (alias with load_now too under
//              WA_SELECT 0); 1: the same source with plain loads, which
//              the compiler turns back into 0's chain;
//              0: the uniforms loaded after row_ptr and alias[a+k] in the
//              false arm of the accept test (the kernel before its
//              redesign).
//   WA_SELECT  how WA_EARLY 1 and 2 pick k or alias[a+k] after the accept
//              test: 0 a ternary; 1 alias + ((k - alias) & m); 2 the bit
//              select alias ^ ((k ^ alias) & m); 3 a ternary on m of the
//              two column offsets (walk_step.cu); m all ones when u_acc <
//              prob, else zero, through an empty asm statement the
//              compiler cannot see past.
//
// Every variant keeps the shipped kernels' arithmetic (slot 0 a rounded
// product, later slots fma in h order; walk::uniform_index), so each must
// be bit-equal to the plain versions; gather_variants.py checks that.

#include <cuda_runtime.h>

#include "walk_common.cuh"

#ifndef EB_SPLIT
#define EB_SPLIT 0
#endif
#ifndef EB_UNROLL
#define EB_UNROLL 8
#endif
#ifndef EB_MINB
#define EB_MINB 1
#endif
#ifndef EB_LOAD
#define EB_LOAD 0
#endif
#ifndef PDL
#define PDL 0
#endif
#ifndef WS_THREADS
#define WS_THREADS 32
#endif
#ifndef WS_U_EARLY
#define WS_U_EARLY 1
#endif
#ifndef WA_THREADS
#define WA_THREADS 32
#endif
#ifndef WA_EARLY
#define WA_EARLY 2
#endif
#ifndef WA_SELECT
#define WA_SELECT 3
#endif

namespace {

using walk::clampi;
using walk::uniform_index;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void wait_previous() {
#if PDL
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

template <typename K, typename... A>
cudaError_t launch(K kernel, int blocks, int threads, cudaStream_t s,
                   A... args) {
#if PDL
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
#else
  kernel<<<blocks, threads, 0, s>>>(args...);
  return cudaGetLastError();
#endif
}

template <typename T>
__device__ __forceinline__ T load_input(const T* p) {
  return PDL ? __ldcg(p) : __ldg(p);
}

// walk_step.cu's load_now: a volatile load, issued where it is written.
__device__ __forceinline__ int load_now(const int* p) {
  int x;
  asm volatile("ld.volatile.global.s32 %0, [%1];" : "=r"(x) : "l"(p));
  return x;
}
__device__ __forceinline__ float load_now(const float* p) {
  float x;
  asm volatile("ld.volatile.global.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}

__device__ __forceinline__ float4 load_row(const float4* p) {
#if EB_LOAD == 1
  return __ldcg(p);
#elif EB_LOAD == 2
  return __ldcs(p);
#elif EB_LOAD == 3
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
#else
  return __ldg(p);
#endif
}

__device__ __forceinline__ float load_row(const float* p) {
  return EB_LOAD == 1 ? __ldcg(p) : __ldg(p);
}

__device__ __forceinline__ void slot(const int* __restrict__ idx,
                                     const float* __restrict__ w, long long i,
                                     int rows, int* row, float* weight) {
  const int id = load_input(idx + i);
  *row = clampi(id, 0, rows - 1);
  *weight = id < 0 ? 0.0f : (w == nullptr ? 1.0f : load_input(w + i));
}

__device__ __forceinline__ float term(float x, float wt, float acc, int h) {
  return h == 0 ? __fmul_rn(x, wt) : __fmaf_rn(x, wt, acc);
}

__device__ __forceinline__ float4 term(const float4& x, float wt,
                                       const float4& acc, int h) {
  return make_float4(term(x.x, wt, acc.x, h), term(x.y, wt, acc.y, h),
                     term(x.z, wt, acc.z, h), term(x.w, wt, acc.w, h));
}

// One bag over one warp (EB_SPLIT 0 and 1): lane `lane` takes words lane,
// lane + 32, ... of the row, V = float4 or float.
template <typename V>
__device__ __forceinline__ void one_bag(const int* __restrict__ idx,
                                        const float* __restrict__ w,
                                        const float* __restrict__ table,
                                        float* __restrict__ out, long long bag,
                                        int hots, int rows, int dim,
                                        int lane) {
  const int words = dim * sizeof(float) / sizeof(V);
  const long long first = bag * hots;
  for (int c = lane; c < words; c += 32) {
    V acc{};
    for (int h = 0; h < hots; ++h) {
      int r;
      float wt;
      slot(idx, w, first + h, rows, &r, &wt);
      const V* row = reinterpret_cast<const V*>(
          table + static_cast<long long>(r) * dim);
      acc = term(load_row(row + c), wt, acc, h);
    }
    reinterpret_cast<V*>(out + bag * dim)[c] = acc;
  }
}

// A run of bags [b0, b1) over one warp (EB_SPLIT 2).
template <typename V>
__device__ __forceinline__ void one_run(const int* __restrict__ idx,
                                        const float* __restrict__ w,
                                        const float* __restrict__ table,
                                        float* __restrict__ out, long long b0,
                                        long long b1, int hots, int rows,
                                        int dim, int lane) {
  constexpr int U = EB_UNROLL;
  const int words = dim * sizeof(float) / sizeof(V);
  const long long s1 = b1 * hots;
  for (int c0 = 0; c0 < words; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < words;
    V acc{};
    int h = 0;
    long long bag = b0;
    for (long long t = b0 * hots; t < s1; t += 32) {
      const int n = static_cast<int>(min(32LL, s1 - t));
      int r = 0;
      float wt = 0.0f;
      if (lane < n) slot(idx, w, t + lane, rows, &r, &wt);
      for (int j = 0; j < n; j += U) {
        int rr[U];
        float ww[U];
        V x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          rr[u] = __shfl_sync(kAll, r, j + u);
          ww[u] = __shfl_sync(kAll, wt, j + u);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (on && j + u < n)
            x[u] = load_row(reinterpret_cast<const V*>(
                       table + static_cast<long long>(rr[u]) * dim) + c);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u >= n) continue;
          if (on) acc = term(x[u], ww[u], acc, h);
          if (++h == hots) {
            if (on) reinterpret_cast<V*>(out + bag * dim)[c] = acc;
            h = 0;
            ++bag;
          }
        }
      }
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads, EB_MINB)
eb_kernel(const int* __restrict__ idx, const float* __restrict__ w,
          const float* __restrict__ table, float* __restrict__ out, int bags,
          int hots, int rows, int dim, int run) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
#if EB_SPLIT == 0
  if (warp >= bags) return;
  wait_previous();
  one_bag<V>(idx, w, table, out, warp, hots, rows, dim, lane);
#elif EB_SPLIT == 1
  if (warp >= bags) return;
  wait_previous();
  for (long long bag = warp; bag < bags;
       bag += static_cast<long long>(gridDim.x) * kWarps)
    one_bag<V>(idx, w, table, out, bag, hots, rows, dim, lane);
#else
  const long long b0 = warp * run;
  if (b0 >= bags) return;
  wait_previous();
  one_run<V>(idx, w, table, out, b0,
             min(b0 + run, static_cast<long long>(bags)), hots, rows, dim,
             lane);
#endif
}

// The blocks of `kernel` that fit on the card at once.
template <typename K>
int resident_blocks(K kernel) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * per_sm;
}

template <typename V>
int eb_launch(const int* idx, const float* w, const float* table, float* out,
              int bags, int hots, int rows, int dim, cudaStream_t s,
              int* grid) {
  int blocks = (bags + kWarps - 1) / kWarps, run = 1;
  if (EB_SPLIT != 0) {
    const int resident = resident_blocks(eb_kernel<V>);
    if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    if (EB_SPLIT == 1) {
      blocks = min(blocks, resident);
    } else {
      const long long warps = static_cast<long long>(resident) * kWarps;
      run = static_cast<int>((bags + warps - 1) / warps);
      const long long used = (bags + run - 1) / run;
      blocks = static_cast<int>((used + kWarps - 1) / kWarps);
    }
  }
  grid[0] = blocks;
  grid[1] = run;
  return static_cast<int>(launch(eb_kernel<V>, blocks, kThreads, s, idx, w,
                                 table, out, bags, hots, rows, dim, run));
}

__global__ void __launch_bounds__(WS_THREADS)
ws_kernel(const int* __restrict__ v_curr, const float* __restrict__ u_col,
          const int* __restrict__ row_ptr, const int* __restrict__ col,
          int* __restrict__ v_next, int* __restrict__ deg_out, int width,
          int num_vertices, int num_edges) {
  const int i = blockIdx.x * WS_THREADS + threadIdx.x;
  if (i >= width) return;
  wait_previous();
  const int v = load_input(v_curr + i);
#if WS_U_EARLY
  const float u = load_input(u_col + i);
#endif
  int addr = 0, deg = 0;
  if (num_vertices > 0) {
    const int c = clampi(v, 0, num_vertices - 1);
    addr = __ldg(row_ptr + c);
    deg = __ldg(row_ptr + c + 1) - addr;
  }
  int out = -1;
  if (deg > 0 && num_edges > 0) {
#if !WS_U_EARLY
    const float u = load_input(u_col + i);
#endif
    out = __ldg(col + clampi(addr + uniform_index(deg, u), 0, num_edges - 1));
  }
  v_next[i] = out;
  deg_out[i] = deg;
}

__global__ void __launch_bounds__(WA_THREADS)
wa_kernel(const int* __restrict__ v_curr, const float* __restrict__ u_col,
          const float* __restrict__ u_acc, const int* __restrict__ row_ptr,
          const int* __restrict__ col, const float* __restrict__ alias_prob,
          const int* __restrict__ alias_idx, int* __restrict__ v_next,
          int* __restrict__ deg_out, int width, int num_vertices,
          int num_edges) {
  const int i = blockIdx.x * WA_THREADS + threadIdx.x;
  if (i >= width) return;
  wait_previous();
  const int v = load_input(v_curr + i);
#if WA_EARLY
#if WA_EARLY == 2
  const float uc = load_now(u_col + i);
  const float ua = load_now(u_acc + i);
#else
  const float uc = load_input(u_col + i);
  const float ua = load_input(u_acc + i);
#endif
#endif
  int addr = 0, deg = 0;
  if (num_vertices > 0) {
    const int c = clampi(v, 0, num_vertices - 1);
    addr = __ldg(row_ptr + c);
    deg = __ldg(row_ptr + c + 1) - addr;
  }
  int out = -1;
  if (deg > 0 && num_edges > 0) {
#if WA_EARLY
    const int k = uniform_index(deg, uc);
    const int ek = clampi(addr + k, 0, num_edges - 1);
    const float prob = __ldg(alias_prob + ek);
#if WA_EARLY == 2 && WA_SELECT == 0
    const int alias = load_now(alias_idx + ek);
#else
    const int alias = __ldg(alias_idx + ek);
#endif
    unsigned m = ua < prob ? ~0u : 0u;
    asm("" : "+r"(m));
    const unsigned uk = k, ua_ = alias;
#if WA_SELECT == 1
    const int idx = static_cast<int>(ua_ + ((uk - ua_) & m));
#elif WA_SELECT == 2
    const int idx = static_cast<int>(ua_ ^ ((uk ^ ua_) & m));
#else
    const int idx = ua < prob ? k : alias;
#endif
#if WA_SELECT == 3
    const int ea = clampi(addr + alias, 0, num_edges - 1);
    out = __ldg(col + (m ? ek : ea));
#else
    out = __ldg(col + clampi(addr + idx, 0, num_edges - 1));
#endif
#else
    const int k = uniform_index(deg, load_input(u_col + i));
    const int ek = clampi(addr + k, 0, num_edges - 1);
    const int idx = load_input(u_acc + i) < __ldg(alias_prob + ek)
                        ? k : __ldg(alias_idx + ek);
    out = __ldg(col + clampi(addr + idx, 0, num_edges - 1));
#endif
  }
  v_next[i] = out;
  deg_out[i] = deg;
}

}  // namespace

// The embedding bag (the wrapper's signature) writing its launch to
// grid = {blocks, bags a warp}; returns the launch's cudaError.
extern "C" int eb_variant(const int* indices, const float* weights,
                          const float* table, float* out, int bags, int hots,
                          int rows, int dim, int vec, void* stream,
                          int* grid) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? eb_launch<float4>(indices, weights, table, out, bags, hots,
                                 rows, dim, s, grid)
             : eb_launch<float>(indices, weights, table, out, bags, hots,
                                rows, dim, s, grid);
}

// The uniform walk step (the wrapper's signature).
extern "C" int ws_variant(const int* v_curr, const float* u_col,
                          const int* row_ptr, const int* col, int* v_next,
                          int* deg, int width, int num_vertices,
                          int num_edges, void* stream) {
  return static_cast<int>(launch(
      ws_kernel, (width + WS_THREADS - 1) / WS_THREADS, WS_THREADS,
      static_cast<cudaStream_t>(stream), v_curr, u_col, row_ptr, col, v_next,
      deg, width, num_vertices, num_edges));
}

// The alias walk step (the wrapper's signature).
extern "C" int wa_variant(const int* v_curr, const float* u_col,
                          const float* u_acc, const int* row_ptr,
                          const int* col, const float* alias_prob,
                          const int* alias_idx, int* v_next, int* deg,
                          int width, int num_vertices, int num_edges,
                          void* stream) {
  return static_cast<int>(launch(
      wa_kernel, (width + WA_THREADS - 1) / WA_THREADS, WA_THREADS,
      static_cast<cudaStream_t>(stream), v_curr, u_col, u_acc, row_ptr, col,
      alias_prob, alias_idx, v_next, deg, width, num_vertices, num_edges));
}
