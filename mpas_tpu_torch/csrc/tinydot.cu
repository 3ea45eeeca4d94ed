// Per-cell tiny contraction (K2) for Hopper (sm_90a):
//     out[c, p, k] = sum_i w[c, p, i] * x[c, i, k]
// for w (nC, P, I), x (nC, I, K), out (nC, P, K), all contiguous.
//
// Replaces the Pallas TPU kernel mpas_tpu/kernels/tinydot.py
// (tinydot / _tinydot_kernel). On the dycore's path it carries the
// cell-assembled TRiSK operator (P = I = maxEdges: 6 on the icosahedral
// meshes, 8 on the variable-resolution one; K = nz or 2*nz) and the
// quadratic-fit second derivatives of the advection (P = 3, I = maxEdges,
// K = nz); on the shallow-water path the same TRiSK operator at K = 1 (the
// tangential velocity) and K = 2 (the q pair).
//
// What bounds it: device memory. Each output costs I multiply-adds, and a
// cell moves P*I + I*K + P*K values (660 at (6, 6, 52)), so the least time
// is the bytes over 3.35 TB/s (kernels/tinydot.py:bytes_moved). At the
// paths' small shapes (under ~20 MB a call) the chain of one load round
// trip, the contraction and the stores sets the time instead; ptxas gives
// 57 registers a thread in f32 (76 in f64), no spills, so an SM holds at
// most 4 blocks of 256 threads.
//
// Design, one for every K: a block owns a tile of `cols` consecutive cells,
// whose slices of w (cols*P*I values) and x (cols*I*K) are each one
// contiguous range. The block copies both into shared memory with cp.async
// (stage.cuh: 16 bytes a copy where the tile start is 16-byte aligned, one
// value a copy where it is not, as for a view with a storage offset). Then
// a thread takes one (cell, k): it holds the column x[c, :, k] in
// registers, and for each p sums
// w[c, p, i] * x[c, i, k] over i left to right, as the TPU kernel's
// unrolled loop does, with w read from shared memory (one address for all
// the threads of a cell at large K). The stores of out[c, p, :] run along k,
// so they are coalesced where K is large; at K = 1 and 2 a warp's stores
// cover a contiguous stretch of 32*P*K values over P instructions. So no
// thread reloads w from device memory, and every device load is coalesced
// at every K. The host (kernels/tinydot.py:plan) picks `cols` so that a
// block uses at most 24 KB. The gather that builds x stays outside.

#include <cuda_runtime.h>

#include "stage.cuh"

#define MPAS_TINYDOT_MAX_I 16  // kernels/tinydot.py:MAX_I

// Byte offset of the x tile in shared memory: after the w tile, 16-aligned.
static __host__ __device__ inline long long x_offset(int cols, int P, int I,
                                                     int size) {
  return ((long long)cols * P * I * size + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(256) tinydot_kernel(
    long long nC, int P, int I, int K, int cols, const T* __restrict__ w,
    const T* __restrict__ x, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long c0 = (long long)blockIdx.x * cols;
  const int nc = (int)min((long long)cols, nC - c0);  // ragged last tile
  T* s_w = reinterpret_cast<T*>(smem);
  T* s_x = reinterpret_cast<T*>(smem + x_offset(cols, P, I, sizeof(T)));
  stage_async(s_w, w + c0 * P * I, nc * P * I);
  stage_async(s_x, x + c0 * I * K, nc * I * K);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  T* o = out + c0 * P * K;
  for (int t = threadIdx.x; t < nc * K; t += blockDim.x) {
    const int c = t / K, k = t - c * K;
    const T* xc = s_x + c * I * K + k;
    T xr[MPAS_TINYDOT_MAX_I];
#pragma unroll
    for (int i = 0; i < MPAS_TINYDOT_MAX_I; ++i)
      if (i < I) xr[i] = xc[i * K];
    const T* wc = s_w + c * P * I;
    T* oc = o + c * P * K + k;
    for (int p = 0; p < P; ++p) {
      const T* wr = wc + p * I;
      T acc = wr[0] * xr[0];
#pragma unroll
      for (int i = 1; i < MPAS_TINYDOT_MAX_I; ++i)
        if (i < I) acc += wr[i] * xr[i];
      oc[p * K] = acc;
    }
  }
}

template <typename T>
static int launch_tinydot(int device, long long nC, int P, int I, int K,
                          int cols, int threads, long long smem, const T* w,
                          const T* x, T* out, void* stream) {
  // the host's plan must describe this kernel's tile layout
  if (I < 1 || I > MPAS_TINYDOT_MAX_I || P < 1 || K < 1 || cols < 1
      || threads < 1 || threads > 256
      || smem != x_offset(cols, P, I, sizeof(T))
                     + (long long)cols * I * K * (long long)sizeof(T))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tinydot_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((nC + cols - 1) / cols);
  tinydot_kernel<T><<<blocks, threads, (size_t)smem, (cudaStream_t)stream>>>(
      nC, P, I, K, cols, w, x, out);
  return (int)cudaGetLastError();
}

// C entry points, launching on `stream` of CUDA device `device` one block of
// `threads` threads (at most 256) with `smem` bytes of shared memory per tile
// of `cols` cells. Return cudaErrorInvalidValue, launching nothing, where
// `smem` is not this kernel's layout (the w tile padded to 16 bytes, then
// the x tile), I is above MPAS_TINYDOT_MAX_I or the block size is out of
// range; else the error of the shared-memory attribute, if one was needed
// and refused, else cudaGetLastError() after the launch.
extern "C" int mpas_tinydot_f32(int device, long long nC, int P, int I, int K,
                                int cols, int threads, long long smem,
                                const void* w, const void* x, void* out,
                                void* stream) {
  return launch_tinydot<float>(device, nC, P, I, K, cols, threads, smem,
                               (const float*)w, (const float*)x, (float*)out,
                               stream);
}

extern "C" int mpas_tinydot_f64(int device, long long nC, int P, int I, int K,
                                int cols, int threads, long long smem,
                                const void* w, const void* x, void* out,
                                void* stream) {
  return launch_tinydot<double>(device, nC, P, I, K, cols, threads, smem,
                                (const double*)w, (const double*)x,
                                (double*)out, stream);
}
