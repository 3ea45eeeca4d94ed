// Per-cell tiny contraction (K2) for Hopper (sm_90a):
//     out[c, p, k] = sum_i w[c, p, i] * x[c, i, k]
// for w (nC, P, I), x (nC, I, K), out (nC, P, K), all contiguous.
//
// Replaces the Pallas TPU kernel mpas_tpu/kernels/tinydot.py
// (tinydot / _tinydot_kernel). On the dycore's path it carries the
// cell-assembled TRiSK operator (P = I = maxEdges = 6, K = nz or 2*nz) and
// the quadratic-fit second derivatives of the advection (P = 3, I = 6,
// K = nz).
//
// What bounds it: memory. Each output costs I multiply-adds against I
// loads of x, so at these widths the kernel moves bytes, not flops.
//
// Design (the simple correct version): one thread per (c, k) output column,
// looping over p and i. Consecutive threads take consecutive k, so the
// loads of x[c, i, :] and the stores of out[c, p, :] are coalesced along k,
// and w[c, p, i] is the same address across the threads of one cell (a
// broadcast). The accumulation runs over i left to right, as the TPU
// kernel's unrolled loop does. The gather that builds x (edgesOnCell or
// cellsOnCell rows) stays outside; fusing it in, so x never exists in
// device memory, is later work.

#include <cuda_runtime.h>

template <typename T>
__global__ void tinydot_kernel(long long nC, int P, int I, int K,
                               const T* __restrict__ w,
                               const T* __restrict__ x,
                               T* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nC * K) return;
  const long long c = t / K;
  const int k = (int)(t - c * K);
  const T* wc = w + c * P * I;
  const T* xc = x + c * I * K + k;
  T* oc = out + c * P * K + k;
  for (int p = 0; p < P; ++p) {
    T acc = wc[p * I] * xc[0];
    for (int i = 1; i < I; ++i) acc += wc[p * I + i] * xc[(long long)i * K];
    oc[(long long)p * K] = acc;
  }
}

template <typename T>
static int launch_tinydot(int device, long long nC, int P, int I, int K,
                          const T* w, const T* x, T* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int threads = 256;
  const long long n = nC * K;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  tinydot_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      nC, P, I, K, w, x, out);
  return (int)cudaGetLastError();
}

// C entry points, launching on `stream` of CUDA device `device`; return
// cudaGetLastError() after the launch.
extern "C" int mpas_tinydot_f32(int device, long long nC, int P, int I, int K,
                                const void* w, const void* x, void* out,
                                void* stream) {
  return launch_tinydot<float>(device, nC, P, I, K, (const float*)w, (const float*)x,
                               (float*)out, stream);
}

extern "C" int mpas_tinydot_f64(int device, long long nC, int P, int I, int K,
                                const void* w, const void* x, void* out,
                                void* stream) {
  return launch_tinydot<double>(device, nC, P, I, K, (const double*)w,
                                (const double*)x, (double*)out, stream);
}
