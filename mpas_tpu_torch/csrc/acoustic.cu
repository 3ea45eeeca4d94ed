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
// What bounds it: memory. Each column streams ~20 arrays of nz or nz+1
// values once and does a few flops per value (far below the card's
// flop:byte balance), so time is device-memory traffic plus latency.
//
// Design (the simple correct version): one thread per cell column, walking
// the levels sequentially, as the reference's k-loops do. The TPU kernel's
// masked-roll affine scan existed only because levels sat in vector lanes;
// here the recurrence is a plain loop in registers. No per-thread arrays:
// the forward sweep parks the provisional rs/ts in the rho_pp/rtheta_pp
// outputs and the Thomas forward value y in the rw_p output, and the back
// sweep reads each back once and overwrites it with the final value.
// Known cost: with levels minor, a warp's 32 threads read addresses nz+1
// elements apart, so loads are not coalesced. A levels-major layout or a
// warp-per-block-of-columns staging through shared memory is the first
// thing to fix.

#include <cuda_runtime.h>

template <typename T>
__global__ void acoustic_cell_kernel(
    long long nC, int nz, T resm, T dts, T ww_old, T ww_new,
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
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nC) return;
  const long long L = c * nz;        // row offset of level arrays
  const long long I = c * (nz + 1);  // row offset of interface arrays

  // provisional rs/ts of level k, corrected with the old rw_p (ref :2551-2560)
  auto level = [&](int k, T& rs, T& ts) {
    const T lo = rw_p0[I + k], hi = rw_p0[I + k + 1];
    rs = rs_pre[L + k] - cofrz[k] * resm * (hi - lo);
    ts = ts_pre[L + k] - resm * rdzw[k] * (coftz[I + k + 1] * hi - coftz[I + k] * lo);
    rho_pp[L + k] = rs;
    rtheta_pp[L + k] = ts;
  };

  // forward sweep: rhs at interface i (ref :2577-2592), then
  // y[i] = (-a[i]*alpha[i]) * y[i-1] + rhs[i]*alpha[i] with y[0] = 0
  T rs_lo, ts_lo;
  level(0, rs_lo, ts_lo);
  T y = T(0);
  rw_p[I] = T(0);
  for (int i = 1; i < nz; ++i) {
    T rs_hi, ts_hi;
    level(i, rs_hi, ts_hi);
    const T zz_lo = zz[L + i - 1], zz_hi = zz[L + i];
    const T rt_lo = rtheta_pp0[L + i - 1], rt_hi = rtheta_pp0[L + i];
    const T rhs = rw_p0[I + i] + dts * tend_rw[I + i]
        - cofwz[I + i] * ((zz_hi * ts_hi - zz_lo * ts_lo)
                          + resm * (zz_hi * rt_hi - zz_lo * rt_lo))
        - cofwr[I + i] * ((rs_hi + rs_lo)
                          + resm * (rho_pp0[L + i] + rho_pp0[L + i - 1]))
        + cofwt[L + i] * (ts_hi + resm * rt_hi)
        + cofwt[L + i - 1] * (ts_lo + resm * rt_lo);
    const T al = alpha_tri[I + i];
    y = (-a_tri[I + i] * al) * y + rhs * al;
    rw_p[I + i] = y;
    rs_lo = rs_hi;
    ts_lo = ts_hi;
  }

  // back sweep: x[i] = y[i] - gamma[i]*x[i+1] with x[nz] = 0, then the
  // implicit Rayleigh damping (ref :2608-2616), the second wwAvg
  // accumulation and the level back-substitution (ref :2618-2650)
  T x = T(0);
  T rwp_up = T(0);  // damped rw_p at the interface above
  rw_p[I + nz] = T(0);
  wwavg[I] = wwavg0[I];
  wwavg[I + nz] = wwavg0[I + nz];
  for (int i = nz - 1; i >= 0; --i) {
    T rwp = T(0);
    if (i > 0) {
      x = (-gamma_tri[I + i]) * x + rw_p[I + i];
      const T dss = dss_int[I + i], dw = dw_term[I + i];
      rwp = ((x + dw - dts * dss * wdamp[I + i]) / (T(1) + dts * dss)) - dw;
      rw_p[I + i] = rwp;
      wwavg[I + i] = (wwavg0[I + i] + ww_old * rw_p0[I + i]) + ww_new * rwp;
    }
    rho_pp[L + i] = rho_pp[L + i] - cofrz[i] * (rwp_up - rwp);
    rtheta_pp[L + i] = rtheta_pp[L + i]
        - rdzw[i] * (coftz[I + i + 1] * rwp_up - coftz[I + i] * rwp);
    rwp_up = rwp;
  }
}

template <typename T>
static int launch_acoustic(int device, long long nC, int nz, double epssm,
                           double dts, const T* const* in, T* const* out,
                           void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const double resm = (1.0 - epssm) / (1.0 + epssm);
  const int threads = 128;
  const unsigned blocks = (unsigned)((nC + threads - 1) / threads);
  acoustic_cell_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      nC, nz, T(resm), T(dts), T(0.5 * (1.0 - epssm)), T(0.5 * (1.0 + epssm)),
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], in[12], in[13], in[14], in[15], in[16], in[17], in[18],
      in[19], out[0], out[1], out[2], out[3]);
  return (int)cudaGetLastError();
}

// C entry points, launching on `stream` of CUDA device `device`. `in` holds
// the 20 input pointers in the order of the kernel's parameters
// (rs_pre .. wdamp); `out` holds rw_p, rho_pp, rtheta_pp, wwavg. Returns
// cudaGetLastError() after the launch.
extern "C" int mpas_acoustic_cell_update_f32(int device, long long nC, int nz,
                                             double epssm, double dts,
                                             const void* const* in,
                                             void* const* out, void* stream) {
  return launch_acoustic<float>(device, nC, nz, epssm, dts,
                                (const float* const*)in, (float* const*)out,
                                stream);
}

extern "C" int mpas_acoustic_cell_update_f64(int device, long long nC, int nz,
                                             double epssm, double dts,
                                             const void* const* in,
                                             void* const* out, void* stream) {
  return launch_acoustic<double>(device, nC, nz, epssm, dts,
                                 (const double* const*)in, (double* const*)out,
                                 stream);
}
