// Acoustic-substep column update (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mpas_tpu/kernels/acoustic.py
// (acoustic_cell_update / _acoustic_cell_kernel): the cell-local half of one
// forward-backward acoustic substep of the split-explicit dycore
// (ref: atm_advance_acoustic_step_work, mpas_atm_time_integration.F:2447-2723).
// Per column: the rs/ts corrections with the old rw_p, the implicit-w
// right-hand side at interfaces 1..nz-1, the pre-factored tridiagonal Thomas
// solve (forward, then back), implicit Rayleigh damping of w, the
// rho_pp/rtheta_pp back-substitution and both wwAvg accumulations.
//
// What bounds it: device memory. Each column reads 18 arrays of nz or nz+1
// values and writes 4 (586 values at nz = 26) and does ~60 flops per level,
// far below the card's flop:byte balance. The least time is the bytes over
// 3.35 TB/s (kernels/acoustic.py:bytes_moved). ptxas gives 30 registers a
// thread in f32 (32 in f64) and no spills.
//
// Design: a block owns a tile of `cols` consecutive columns. The arrays are
// row-major (nC, nz) and (nC, nz+1), so a tile of each operand is one
// contiguous range. The block first copies all 18 tiles into shared memory
// with cp.async, 16 bytes a copy where the tile start allows it (else one
// value a copy, as for a view with a storage offset), so the whole tile is
// in flight at once and each warp's copies are contiguous whatever nz is.
// Then, split by __syncthreads():
//   A1  over levels: the rs/ts corrections, in place of rs_pre/ts_pre;
//   A2  over interfaces: the implicit-w right-hand side and the forward
//       sweep's coefficients -a*alpha and rhs*alpha, in rows padded to an
//       odd stride (no bank conflicts in B);
//   B   one thread per column: the two Thomas sweeps over shared memory, in
//       the order of the one-thread-per-column version, so float64 agrees
//       with the plain version to rounding;
//   C1  over interfaces: the Rayleigh damping, rw_p and wwAvg (stored);
//   C2  over levels: the rho_pp/rtheta_pp back-substitution (stored).
// Consecutive threads take consecutive values in A1, A2, C1 and C2, so the
// stores are coalesced too. Nothing is parked in device memory and read
// back. The host (kernels/acoustic.py:plan) picks `cols`, the block size and
// so the shared memory (~2.2 KB a column at nz = 26 in f32, ~9.4 KB at
// nz = 55 in f64); the launcher refuses a plan whose bytes are not
// tile_bytes(cols, nz).

#include <cuda_runtime.h>

#include "stage.cuh"

// Row stride of the sweep arrays in shared memory: nz+1 rounded up to odd.
static __host__ __device__ inline int sweep_stride(int nz) {
  return (nz + 1) | 1;
}

// Bytes of one shared-memory region of `values` values, 16-byte aligned.
static __host__ __device__ inline long long region(long long values,
                                                   int size) {
  return (values * size + 15) / 16 * 16;
}

// Shared memory of a tile: the 6 level and 12 interface inputs, then the
// two sweep rows of each column.
static __host__ __device__ inline long long tile_bytes(int cols, int nz,
                                                       int size) {
  return 6 * region((long long)cols * nz, size)
      + 12 * region((long long)cols * (nz + 1), size)
      + 2 * region((long long)cols * sweep_stride(nz), size);
}

template <typename T>
__global__ void __launch_bounds__(256) acoustic_cell_kernel(
    long long nC, int nz, int cols, T resm, T dts, T ww_old, T ww_new,
    const T* __restrict__ rs_pre, const T* __restrict__ ts_pre,
    const T* __restrict__ rw_p0, const T* __restrict__ wwavg0,
    const T* __restrict__ tend_rw, const T* __restrict__ rho_pp0,
    const T* __restrict__ rtheta_pp0, const T* __restrict__ cofwz,
    const T* __restrict__ cofwr, const T* __restrict__ cofwt,
    const T* __restrict__ coftz, const T* __restrict__ cofrz,
    const T* __restrict__ rdzw, const T* __restrict__ a_tri,
    const T* __restrict__ alpha_tri, const T* __restrict__ gamma_tri,
    const T* __restrict__ zz, const T* __restrict__ dss_int,
    const T* __restrict__ dw_term, const T* __restrict__ wdamp,
    T* __restrict__ rw_p, T* __restrict__ rho_pp, T* __restrict__ rtheta_pp,
    T* __restrict__ wwavg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n1 = nz + 1, si = sweep_stride(nz);
  const long long c0 = (long long)blockIdx.x * cols;
  const int nc = (int)min((long long)cols, nC - c0);  // ragged last tile
  const int nl = nc * nz, ni = nc * n1;
  const long long L0 = c0 * nz, I0 = c0 * n1;  // tile offsets

  // carve the regions in the order of tile_bytes, staging each input tile
  unsigned char* next = smem;
  auto level = [&](const T* g) {
    T* r = reinterpret_cast<T*>(next);
    next += region((long long)cols * nz, sizeof(T));
    stage_async(r, g + L0, nl);
    return r;
  };
  auto iface = [&](const T* g) {
    T* r = reinterpret_cast<T*>(next);
    next += region((long long)cols * n1, sizeof(T));
    stage_async(r, g + I0, ni);
    return r;
  };
  T* s_rs = level(rs_pre);            // then rs
  T* s_ts = level(ts_pre);            // then ts
  const T* s_rho0 = level(rho_pp0);
  const T* s_rt0 = level(rtheta_pp0);
  const T* s_cofwt = level(cofwt);
  const T* s_zz = level(zz);
  const T* s_rw0 = iface(rw_p0);
  const T* s_ww0 = iface(wwavg0);
  const T* s_tend = iface(tend_rw);
  const T* s_cofwz = iface(cofwz);
  const T* s_cofwr = iface(cofwr);
  const T* s_coftz = iface(coftz);
  const T* s_a = iface(a_tri);
  const T* s_alpha = iface(alpha_tri);
  const T* s_gamma = iface(gamma_tri);
  const T* s_dss = iface(dss_int);
  const T* s_dw = iface(dw_term);
  const T* s_wdamp = iface(wdamp);
  T* s_am = reinterpret_cast<T*>(next);  // cols * si: -a*alpha, then rw_p
  T* s_bm = reinterpret_cast<T*>(next + region((long long)cols * si,
                                               sizeof(T)));  // rhs*alpha, y, x
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // A1: provisional rs/ts of level k, corrected with the old rw_p
  // (ref :2551-2560)
  for (int j = threadIdx.x; j < nl; j += blockDim.x) {
    const int c = j / nz, k = j - c * nz, e = c * n1 + k;
    const T lo = s_rw0[e], hi = s_rw0[e + 1];
    s_rs[j] = s_rs[j] - cofrz[k] * resm * (hi - lo);
    s_ts[j] = s_ts[j]
        - resm * rdzw[k] * (s_coftz[e + 1] * hi - s_coftz[e] * lo);
  }
  __syncthreads();

  // A2: rhs at interface i = 1..nz-1 (ref :2577-2592) and the coefficients
  // of the forward sweep y[i] = (-a[i]*alpha[i]) * y[i-1] + rhs[i]*alpha[i]
  for (int j = threadIdx.x; j < ni; j += blockDim.x) {
    const int c = j / n1, i = j - c * n1;
    if (i == 0 || i == nz) continue;
    const int l = c * nz + i;          // level i of the tile's column c
    const T zz_lo = s_zz[l - 1], zz_hi = s_zz[l];
    const T rt_lo = s_rt0[l - 1], rt_hi = s_rt0[l];
    const T rs_lo = s_rs[l - 1], rs_hi = s_rs[l];
    const T ts_lo = s_ts[l - 1], ts_hi = s_ts[l];
    const T rhs = s_rw0[j] + dts * s_tend[j]
        - s_cofwz[j] * ((zz_hi * ts_hi - zz_lo * ts_lo)
                        + resm * (zz_hi * rt_hi - zz_lo * rt_lo))
        - s_cofwr[j] * ((rs_hi + rs_lo) + resm * (s_rho0[l] + s_rho0[l - 1]))
        + s_cofwt[l] * (ts_hi + resm * rt_hi)
        + s_cofwt[l - 1] * (ts_lo + resm * rt_lo);
    const T al = s_alpha[j];
    s_am[c * si + i] = -s_a[j] * al;
    s_bm[c * si + i] = rhs * al;
  }
  __syncthreads();

  // B: the Thomas sweeps, one thread per column: y with y[0] = 0, then
  // x[i] = y[i] - gamma[i]*x[i+1] with x[nz] = 0 (ref :2596-2604)
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const T* am = s_am + c * si;
    const T* gm = s_gamma + c * n1;
    T* bm = s_bm + c * si;
    T y = T(0);
    for (int i = 1; i < nz; ++i) {
      y = am[i] * y + bm[i];
      bm[i] = y;
    }
    T x = T(0);
    for (int i = nz - 1; i >= 1; --i) {
      x = (-gm[i]) * x + bm[i];
      bm[i] = x;
    }
  }
  __syncthreads();

  // C1: implicit Rayleigh damping (ref :2608-2616), rw_p and both wwAvg
  // accumulations; the damped rw_p goes to shared memory for C2
  for (int j = threadIdx.x; j < ni; j += blockDim.x) {
    const int c = j / n1, i = j - c * n1;
    T rwp = T(0);
    if (i == 0 || i == nz) {
      wwavg[I0 + j] = s_ww0[j];
    } else {
      const T x = s_bm[c * si + i];
      const T dss = s_dss[j], dw = s_dw[j];
      rwp = ((x + dw - dts * dss * s_wdamp[j]) / (T(1) + dts * dss)) - dw;
      wwavg[I0 + j] = (s_ww0[j] + ww_old * s_rw0[j]) + ww_new * rwp;
    }
    rw_p[I0 + j] = rwp;
    s_am[c * si + i] = rwp;
  }
  __syncthreads();

  // C2: the level back-substitution (ref :2618-2650)
  for (int j = threadIdx.x; j < nl; j += blockDim.x) {
    const int c = j / nz, k = j - c * nz, e = c * n1 + k, s = c * si + k;
    const T lo = s_am[s], hi = s_am[s + 1];
    rho_pp[L0 + j] = s_rs[j] - cofrz[k] * (hi - lo);
    rtheta_pp[L0 + j] = s_ts[j]
        - rdzw[k] * (s_coftz[e + 1] * hi - s_coftz[e] * lo);
  }
}

template <typename T>
static int launch_acoustic(int device, long long nC, int nz, int cols,
                           int threads, long long smem, double epssm,
                           double dts, const T* const* in, T* const* out,
                           void* stream) {
  // the host's plan must describe this kernel's tile layout
  if (nz < 2 || cols < 1 || threads < 1 || threads > 256
      || smem != tile_bytes(cols, nz, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(acoustic_cell_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const double resm = (1.0 - epssm) / (1.0 + epssm);
  const unsigned blocks = (unsigned)((nC + cols - 1) / cols);
  acoustic_cell_kernel<T><<<blocks, threads, (size_t)smem,
                            (cudaStream_t)stream>>>(
      nC, nz, cols, T(resm), T(dts), T(0.5 * (1.0 - epssm)),
      T(0.5 * (1.0 + epssm)), in[0], in[1], in[2], in[3], in[4], in[5], in[6],
      in[7], in[8], in[9], in[10], in[11], in[12], in[13], in[14], in[15],
      in[16], in[17], in[18], in[19], out[0], out[1], out[2], out[3]);
  return (int)cudaGetLastError();
}

// C entry points, launching on `stream` of CUDA device `device` one block of
// `threads` threads (at most 256) with `smem` bytes of shared memory per tile
// of `cols` columns. `in` holds the 20 input pointers in the order of the
// kernel's parameters (rs_pre .. wdamp); `out` holds rw_p, rho_pp,
// rtheta_pp, wwavg. Return cudaErrorInvalidValue, launching nothing, where
// `smem` is not tile_bytes(cols, nz) or the block size is out of range; else
// the error of the shared-memory attribute, if one was needed and refused,
// else cudaGetLastError() after the launch.
extern "C" int mpas_acoustic_cell_update_f32(int device, long long nC, int nz,
                                             int cols, int threads,
                                             long long smem, double epssm,
                                             double dts,
                                             const void* const* in,
                                             void* const* out, void* stream) {
  return launch_acoustic<float>(device, nC, nz, cols, threads, smem, epssm,
                                dts, (const float* const*)in,
                                (float* const*)out, stream);
}

extern "C" int mpas_acoustic_cell_update_f64(int device, long long nC, int nz,
                                             int cols, int threads,
                                             long long smem, double epssm,
                                             double dts,
                                             const void* const* in,
                                             void* const* out, void* stream) {
  return launch_acoustic<double>(device, nC, nz, cols, threads, smem, epssm,
                                 dts, (const double* const*)in,
                                 (double* const*)out, stream);
}
