// Programmatic dependent launch (sm_90): a kernel launched this way may
// start while the kernel before it on the stream drains, so its launch
// and ramp overlap that kernel's tail.  It must call
// wait_for_previous_kernel() before it reads anything that kernel (or
// one before it) wrote, and read such data through L2 (__ldcg), never
// through a line L1 kept from before the wait.
#pragma once

#include <cuda_runtime.h>

namespace walk {

// Waits until the kernel before this one on the stream has finished and
// its writes are visible.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches `kernel` on a grid of `blocks` x `threads` as a programmatic
// dependent of the kernel before it on `stream`; returns the launch's
// cudaError.  A refused launch's error is also cleared from the thread's
// last-error state, so a later wrapper that reads cudaGetLastError()
// reports only its own launch.
template <typename... Params, typename... Actual>
cudaError_t launch_dependent(void (*kernel)(Params...), int blocks,
                             int threads, cudaStream_t stream,
                             Actual... args) {
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

}  // namespace walk
