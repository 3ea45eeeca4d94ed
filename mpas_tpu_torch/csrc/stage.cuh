// Staging of a contiguous tile from device memory into shared memory, shared
// by the kernels of this directory.
#pragma once

#include <cuda_pipeline.h>

#include <cstdint>

// Start copying n values from src (device memory) to dst (shared memory)
// with all threads of the block, by cp.async: 16 bytes a copy where src and
// dst are both 16-byte aligned, else one value a copy (as for a view with a
// storage offset). Consecutive threads copy consecutive bytes. The caller
// commits and waits (__pipeline_commit, __pipeline_wait_prior(0)) and then
// synchronises the block before reading dst.
template <typename T>
__device__ inline void stage_async(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const int nv = n / V;
    for (int j = threadIdx.x; j < nv; j += blockDim.x)
      __pipeline_memcpy_async(dst + j * V, src + j * V, 16);
    done = nv * V;
  }
  for (int j = done + threadIdx.x; j < n; j += blockDim.x)
    __pipeline_memcpy_async(dst + j, src + j, sizeof(T));
}
