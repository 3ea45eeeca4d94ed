// Implicit vertical-mix column solve (K3) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the ocean's implicit
// vertical mix (mpas_tpu/cores/ocean/core.py:implicit_vertical_mix, ref:
// ocn_vmix implicit solves, mpas_ocn_vmix.F) to XLA, which fuses its Thomas
// loop over the levels into one program. In PyTorch that loop launched
// about 8 elementwise kernels a level and a solve, some 6,200 launches an
// ocean step, each moving ~1 MB, so the host's dispatch set the pace. K3
// does each backward-Euler solve in one launch: the velocity solve (with
// the linearised quadratic bottom drag at each edge's last live level, the
// solution written times (1 - boundaryEdge)), and all tracers of the
// tracer solve, which share one matrix: it is factored once a column and
// applied to every right-hand side of the (n, nz, ntr) layout.
//
// Per column, from h (n, nz), kappa (n, nz-1) at the inner interfaces and
// the level mask (n, nz) (null: every level live), as
// kernels/vmix.py:vmix_solve_plain builds them:
//   hi  = max(0.5 (h[k+1] + h[k]), 1e-12),  g[k] = dt (kappa[k] mask[k+1])/hi
//   a[k] = -g[k-1] / hs[k],  c[k] = -g[k] / hs[k],  b[k] = 1 - a[k] - c[k]
// with hs = max(h, 1e-12), g[-1] = g[nz-1] = 0, and with drag > 0
//   b[k] += bot[k] dt drag spd / hs[k],  bot[k] = mask[k] (1 - mask[k+1]),
//   spd = sum_k |field[k]| bot[k]
// (bot = 1 at level nz-1 alone without a mask; spd summed across a warp,
// exact where bot is one-hot, as a 0/1 mask makes it). Dead levels get
// a = c = 0 and b = 1, so x = d there. The sweeps run in the plain loop's
// order (den = b - a cp, cp = c / den, dp = (d - a dp) / den, then
// x = dp - cp x), with every product rounded on its own (__fmul_rn /
// __dmul_rn, no contraction into an FMA), so the kernel repeats the plain
// path's roundings.
//
// What bounds it: device memory. A column moves 2 nz ntr + 3 nz - 1 values
// (field in and out, h, kappa, mask) for ~7 flops a level and right-hand
// side, far under the card's balance: the least time is the bytes over
// 3.35 TB/s (kernels/vmix.py:bytes_moved).
//
// Design: a block owns a tile of `cols` consecutive columns, whose slice of
// each operand is one contiguous range of device memory. The block copies
// the slices row by row (a warp a column, lanes along the row, cp.async 16
// bytes a copy where the rows allow it, else one value) into shared memory
// rows of a padded stride: h, kappa and the mask into three rows of S >= nz
// values, an odd number of 16-byte words, and the field into rows of the
// same stride (one right-hand side) or of SF >= nz ntr with SF = ntr modulo
// 128 / sizeof(T) (more: a warp's (column, tracer) threads on distinct
// banks). Then, split by __syncthreads():
//   A   a warp a column, lanes along the levels (nz <= 32 MAXE): each lane
//       reads its levels' h, kappa and mask into registers, computes hs, g
//       below (g above from the lane before), a, c, b and, with drag, the
//       bottom term (the column's spd a sum over the warp), and after
//       __syncwarp writes a, c and b over h, kappa and the mask: every
//       division but those of the recurrence runs here, in parallel;
//   B   with one right-hand side, a thread a column: the factor and the
//       forward sweep in one loop, then the back sweep; with more, the
//       block's last warp factors its columns, a thread a column (den over
//       b, cp over c), a chunk of levels ahead of the sweep threads, a
//       thread a (column, tracer), which follow with the forward sweeps of
//       their right-hand sides in place in the field rows (a column's
//       threads read the same a, den: broadcasts), a __syncthreads() a
//       chunk, and then run the back sweeps;
//   C   a warp a column: the field rows stored, coalesced.
// The sweeps load each level's operands before they store the level
// before, so the shared-memory latency stays off the recurrence, and write
// the solution already times (1 - boundary). A division whose numerator is
// zero (the top and bottom rows, every dead level) would take the
// hardware's slow path: quot gives it its signed zero by a product. No a, b
// or c array is written to device memory. The host (kernels/vmix.py:plan)
// picks `cols` and the block size; the launcher refuses a plan whose bytes
// are not tile_bytes(cols, nz, ntr), or nz above 32 MAXE, and asks for the
// largest shared-memory carveout, so that as many tiles as fit share an SM.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>

#include <cstdint>
#include <type_traits>

#define MPAS_VMIX_MAXE 4    // levels a lane holds in phase A: nz <= 128
#define MPAS_VMIX_CHUNK 8   // levels the factor runs ahead of the sweeps

// Row stride of h, kappa and the mask (then a, c, b, and den, cp): the
// least >= nz that is an odd number of 16-byte words, so that rows copy 16
// bytes a copy and the 16-byte words of eight rows meet no bank conflict.
static __host__ __device__ inline int coef_stride(int nz, int size) {
  const int v = 16 / size, words = (nz + v - 1) / v;
  return (words | 1) * v;
}

// Row stride of the field: with one right-hand side the coefficients'
// stride, else the least >= nz * ntr that is ntr modulo the values of one
// 128-byte bank row (a warp's (column, tracer) threads on distinct banks).
static __host__ __device__ inline int field_stride(int nz, int ntr,
                                                   int size) {
  if (ntr == 1) return coef_stride(nz, size);
  const int w = 128 / size, len = nz * ntr;
  return len + ((ntr - len) % w + w) % w;
}

// Bytes of one shared-memory region of `values` values, 16-byte aligned.
static __host__ __device__ inline long long region(long long values,
                                                   int size) {
  return (values * size + 15) / 16 * 16;
}

// Shared memory of a tile: the field rows, then the h, kappa, mask rows.
static __host__ __device__ inline long long tile_bytes(int cols, int nz,
                                                       int ntr, int size) {
  return region((long long)cols * field_stride(nz, ntr, size), size)
      + 3 * region((long long)cols * coef_stride(nz, size), size);
}

static __device__ inline float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
static __device__ inline double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// x / y rounded as the IEEE division is. A zero numerator would send the
// division to its slow path; its exact signed zero is x * y, so the
// division divides 1 instead.
template <typename T>
__device__ inline T quot(T x, T y) {
  const bool zero = x == T(0);
  const T q = (zero ? T(1) : x) / y;
  return zero ? mul_rn(x, y) : q;
}

// Start copying `rows` rows of `len` values, contiguous at src, into rows
// of stride `stride` at dst: a warp a row, lanes along it, 16 bytes a copy
// where src, dst, len and stride allow it, else one value a copy. The
// caller commits, waits and synchronises the block.
template <typename T>
__device__ inline void stage_rows_async(T* dst, int stride, const T* src,
                                        int rows, int len) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if ((((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
        & 15) | (len % V) | (stride % V)) == 0) {
    const int nv = len / V;
    for (int r = warp; r < rows; r += warps)
      for (int j = lane; j < nv; j += 32)
        __pipeline_memcpy_async(dst + (long long)r * stride + j * V,
                                src + (long long)r * len + j * V, 16);
  } else {
    for (int r = warp; r < rows; r += warps)
      for (int j = lane; j < len; j += 32)
        __pipeline_memcpy_async(dst + (long long)r * stride + j,
                                src + (long long)r * len + j, sizeof(T));
  }
}

// The back sweep x = dp - cp x of one right-hand side f[0], f[step], ...
// (holding dp), writing x * keep in place.
template <typename T>
__device__ inline void back_sweep(T* f, int step, const T* cp, int nz,
                                  T keep, bool kept) {
  T x = f[(nz - 1) * step];
  if (kept) f[(nz - 1) * step] = mul_rn(x, keep);
  if (nz < 2) return;
  T p = f[(nz - 2) * step], ck = cp[nz - 2];
  for (int k = nz - 2; k >= 0; --k) {
    T p1 = T(0), c1 = T(0);
    if (k > 0) {
      p1 = f[(k - 1) * step];
      c1 = cp[k - 1];
    }
    x = p - mul_rn(ck, x);
    f[k * step] = kept ? mul_rn(x, keep) : x;
    p = p1;
    ck = c1;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) vmix_kernel(
    long long n, int nz, int ntr, int cols, T dt, T drag,
    const T* __restrict__ field, const T* __restrict__ h,
    const T* __restrict__ kappa, const T* __restrict__ mask,
    const T* __restrict__ boundary, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = coef_stride(nz, sizeof(T));
  const int SF = field_stride(nz, ntr, sizeof(T));
  const int len = nz * ntr;
  const long long c0 = (long long)blockIdx.x * cols;
  const int nc = (int)min((long long)cols, n - c0);  // ragged last tile
  const bool masked = mask != nullptr, dragged = drag > T(0);
  const bool kept = boundary != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  T* s_f = reinterpret_cast<T*>(smem);
  unsigned char* next = smem + region((long long)cols * SF, sizeof(T));
  T* s_a = reinterpret_cast<T*>(next);               // h, then a
  next += region((long long)cols * S, sizeof(T));
  T* s_c = reinterpret_cast<T*>(next);               // kappa, c, then cp
  next += region((long long)cols * S, sizeof(T));
  T* s_b = reinterpret_cast<T*>(next);               // mask, b, then den
  stage_rows_async(s_f, SF, field + c0 * len, nc, len);
  stage_rows_async(s_a, S, h + c0 * nz, nc, nz);
  stage_rows_async(s_c, S, kappa + c0 * (nz - 1), nc, nz - 1);
  if (masked) stage_rows_async(s_b, S, mask + c0 * nz, nc, nz);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // A: a, c and b of each level, a warp a column; g above a level is g
  // below the level before, from the lane before
  const T eps = T(1e-12), one = T(1), half = T(0.5);
  for (int c = warp; c < nc; c += warps) {
    T* ar = s_a + c * S;
    T* cr = s_c + c * S;
    T* br = s_b + c * S;
    const T* f = s_f + c * SF;
    T hv[MPAS_VMIX_MAXE], gv[MPAS_VMIX_MAXE], botv[MPAS_VMIX_MAXE];
    T spd = T(0);
#pragma unroll
    for (int i = 0; i < MPAS_VMIX_MAXE; ++i) {
      const int k = lane + 32 * i;
      hv[i] = gv[i] = botv[i] = T(0);
      if (k >= nz) continue;
      const T hk = ar[k];
      const T mn = k + 1 < nz ? (masked ? br[k + 1] : one) : T(0);
      if (k + 1 < nz) {
        const T kap = masked ? mul_rn(cr[k], mn) : cr[k];
        gv[i] = quot(mul_rn(dt, kap), max(mul_rn(half, ar[k + 1] + hk), eps));
      }
      hv[i] = max(hk, eps);
      botv[i] = masked ? mul_rn(br[k], one - mn) : one - mn;
      if (dragged) spd += mul_rn(fabs(f[k]), botv[i]);
    }
    if (dragged) {
      for (int o = 16; o > 0; o >>= 1) spd += __shfl_xor_sync(~0u, spd, o);
    }
    T up[MPAS_VMIX_MAXE];
#pragma unroll
    for (int i = 0; i < MPAS_VMIX_MAXE; ++i) {
      const T from_lane = __shfl_up_sync(~0u, gv[i], 1);
      const T from_chunk = __shfl_sync(~0u, i > 0 ? gv[i - 1] : T(0), 31);
      up[i] = lane > 0 ? from_lane : from_chunk;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MPAS_VMIX_MAXE; ++i) {
      const int k = lane + 32 * i;
      if (k >= nz) continue;
      const T a = quot(-up[i], hv[i]);
      const T cc = quot(-gv[i], hv[i]);
      T b = one - a - cc;
      if (dragged) {
        const T num = mul_rn(mul_rn(mul_rn(botv[i], dt), drag), spd);
        if (num != T(0)) b = b + num / hv[i];
      }
      ar[k] = a;
      cr[k] = cc;
      br[k] = b;
    }
  }
  __syncthreads();

  if (ntr == 1) {
    // B: a thread a column: the factor and the forward sweep in one loop
    // (cp over c, dp over d), then the back sweep
    for (int c = threadIdx.x; c < nc; c += blockDim.x) {
      const T* ar = s_a + c * S;
      const T* br = s_b + c * S;
      T* cr = s_c + c * S;
      T* f = s_f + c * SF;
      T cp = T(0), dp = T(0), ak = ar[0], bk = br[0], ck = cr[0], dk = f[0];
      for (int k = 0; k < nz; ++k) {
        T a1 = T(0), b1 = T(1), c1 = T(0), d1 = T(0);
        if (k + 1 < nz) {
          a1 = ar[k + 1];
          b1 = br[k + 1];
          c1 = cr[k + 1];
          d1 = f[k + 1];
        }
        const T den = bk - mul_rn(ak, cp);
        if (k + 1 < nz) {
          cp = quot(ck, den);
          cr[k] = cp;
        }
        dp = quot(dk - mul_rn(ak, dp), den);
        f[k] = dp;
        ak = a1;
        bk = b1;
        ck = c1;
        dk = d1;
      }
      back_sweep(f, 1, cr, nz, kept ? one - boundary[c0 + c] : one, kept);
    }
  } else {
    // B: the block's last warp factors its columns (den over b, cp over
    // c) a chunk of MPAS_VMIX_CHUNK levels ahead of the sweep threads, a
    // thread a (column, tracer), which follow one chunk behind with the
    // forward sweep of their right-hand side; then the back sweeps
    const bool factors = warp == warps - 1 && lane < nc;
    const bool sweeping = threadIdx.x < nc * ntr;
    const int cs = threadIdx.x / ntr, t = threadIdx.x - cs * ntr;
    const T* ar = s_a + (factors ? lane : cs) * S;
    T* br = s_b + (factors ? lane : cs) * S;
    T* cr = s_c + (factors ? lane : cs) * S;
    T* f = s_f + cs * SF + t;
    T cp = T(0), dp = T(0), ak = T(0), bk = T(1), ck = T(0);
    if (factors) {
      ak = ar[0];
      bk = br[0];
      ck = cr[0];
    }
    const int chunks = (nz + MPAS_VMIX_CHUNK - 1) / MPAS_VMIX_CHUNK;
    for (int q = 0; q <= chunks; ++q) {
      if (factors && q < chunks) {
        const int k1 = min(nz, (q + 1) * MPAS_VMIX_CHUNK);
        for (int k = q * MPAS_VMIX_CHUNK; k < k1; ++k) {
          T a1 = T(0), b1 = T(1), c1 = T(0);
          if (k + 1 < nz) {
            a1 = ar[k + 1];
            b1 = br[k + 1];
            c1 = cr[k + 1];
          }
          const T den = bk - mul_rn(ak, cp);
          br[k] = den;
          if (k + 1 < nz) {
            cp = quot(ck, den);
            cr[k] = cp;
          }
          ak = a1;
          bk = b1;
          ck = c1;
        }
      }
      if (sweeping && q > 0) {
        const int k0 = (q - 1) * MPAS_VMIX_CHUNK;
        const int k1 = min(nz, q * MPAS_VMIX_CHUNK);
        T d = f[k0 * ntr], a = ar[k0], den = br[k0];
        for (int k = k0; k < k1; ++k) {
          T d1 = T(0), a1 = T(0), den1 = T(1);
          if (k + 1 < k1) {
            d1 = f[(k + 1) * ntr];
            a1 = ar[k + 1];
            den1 = br[k + 1];
          }
          dp = quot(d - mul_rn(a, dp), den);
          f[k * ntr] = dp;
          d = d1;
          a = a1;
          den = den1;
        }
      }
      __syncthreads();
    }
    if (sweeping)
      back_sweep(f, ntr, cr, nz, kept ? one - boundary[c0 + cs] : one, kept);
  }
  __syncthreads();

  // C: the field rows stored, a warp a column, 16 bytes a store where the
  // rows allow it
  constexpr int V = 16 / sizeof(T);
  using Vec = typename std::conditional<sizeof(T) == 4, float4,
                                        double2>::type;
  T* o = out + c0 * len;
  if ((((reinterpret_cast<uintptr_t>(o)) & 15) | (len % V) | (SF % V)) == 0) {
    for (int c = warp; c < nc; c += warps)
      for (int j = lane; j < len / V; j += 32)
        reinterpret_cast<Vec*>(o + (long long)c * len)[j] =
            reinterpret_cast<const Vec*>(s_f + c * SF)[j];
  } else {
    for (int c = warp; c < nc; c += warps)
      for (int j = lane; j < len; j += 32)
        o[(long long)c * len + j] = s_f[c * SF + j];
  }
}

template <typename T>
static int launch_vmix(int device, long long n, int nz, int ntr, int cols,
                       int threads, long long smem, double dt, double drag,
                       const T* field, const T* h, const T* kappa,
                       const T* mask, const T* boundary, T* out,
                       void* stream) {
  // the host's plan must describe this kernel's tile layout; bottom drag
  // changes the matrix per right-hand side, so it takes one
  if (nz < 1 || nz > 32 * MPAS_VMIX_MAXE || ntr < 1 || cols < 1
      || threads < 32 || threads > 256
      || (ntr > 1 && (cols > 32 || cols * ntr > threads - 32))
      || threads % 32 != 0 || (drag != 0.0 && ntr != 1)
      || smem != tile_bytes(cols, nz, ntr, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static bool carved = false;  // per type: the largest shared carveout
  if (!carved) {
    err = cudaFuncSetAttribute(vmix_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    carved = true;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(vmix_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((n + cols - 1) / cols);
  vmix_kernel<T><<<blocks, threads, (size_t)smem, (cudaStream_t)stream>>>(
      n, nz, ntr, cols, T(dt), T(drag), field, h, kappa, mask, boundary,
      out);
  return (int)cudaGetLastError();
}

// C entry points, launching on `stream` of CUDA device `device` one block of
// `threads` threads (a multiple of 32, at most 256) with `smem` bytes of
// shared memory per tile of `cols` columns. field and out are (n, nz, ntr),
// h and mask (n, nz), kappa (n, nz-1), boundary (n,), all contiguous; mask
// and boundary may be null (every level live; no factor on the store).
// drag > 0 adds the bottom drag and needs ntr = 1. Return
// cudaErrorInvalidValue, launching nothing, where `smem` is not
// tile_bytes(cols, nz, ntr) or the block size or drag is out of range; else
// the error of the shared-memory attribute, if one was needed and refused,
// else cudaGetLastError() after the launch.
extern "C" int mpas_vmix_solve_f32(int device, long long n, int nz, int ntr,
                                   int cols, int threads, long long smem,
                                   double dt, double drag, const void* field,
                                   const void* h, const void* kappa,
                                   const void* mask, const void* boundary,
                                   void* out, void* stream) {
  return launch_vmix<float>(device, n, nz, ntr, cols, threads, smem, dt, drag,
                            (const float*)field, (const float*)h,
                            (const float*)kappa, (const float*)mask,
                            (const float*)boundary, (float*)out, stream);
}

extern "C" int mpas_vmix_solve_f64(int device, long long n, int nz, int ntr,
                                   int cols, int threads, long long smem,
                                   double dt, double drag, const void* field,
                                   const void* h, const void* kappa,
                                   const void* mask, const void* boundary,
                                   void* out, void* stream) {
  return launch_vmix<double>(device, n, nz, ntr, cols, threads, smem, dt,
                             drag, (const double*)field, (const double*)h,
                             (const double*)kappa, (const double*)mask,
                             (const double*)boundary, (double*)out, stream);
}
