// Gradient-enhanced covariance assembly (K1) and its theta-cotangent (K2)
// for NVIDIA Hopper (sm_90a), with a plain C interface loaded by
// gpgradpy_torch/ops/cuda_assembly.py through ctypes.
//
// K1 replaces the Pallas kernel gpgradpy_tpu/ops/pallas_assembly.py
// ::_kern_tile_kernel (pallas_call at :224).  K2 replaces
// ::_kern_vjp_tile_kernel (pallas_call at :416).
//
// Both kernels are radial: k(x1, x2) = phi(W), W = sum_c theta_c R_c^2 with
// R_c = x1_c - x2_c, and the (1+d)^2 derivative blocks are closed forms in
// phi', phi'', phi''' (see gpgradpy_torch/ops/kernels.py).  The covariance is
// laid out values first, then the gradient blocks grouped by coordinate:
// row a*n1 + i, column b*n2 + j holds block (a, b) of point pair (i, j).
//
// What bounds them on an H100: device memory.  K1 writes (1+d)^2 n1 n2
// elements and K2 reads as many; the arithmetic is a few operations per
// element plus one transcendental per point pair, far below the card's
// f64 rate.  So both designs aim at touching each output (K1) or cotangent
// (K2) element exactly once with coalesced accesses:
//   * one block per (row tile of 32 points, column tile of 32 points, batch
//     row); its x1/x2 tiles and theta sit in shared memory, transposed so
//     that neighbouring threads read neighbouring words;
//   * phi and its derivatives are computed once per point pair, kept in
//     registers (4 point pairs per thread) and reused by all (1+d)^2
//     derivative blocks, which a loop inside the block walks -- the loop
//     takes the place of the TPU's sequential trailing grid dimensions;
//   * a warp covers 32 neighbouring columns of one row, so every load and
//     store of a derivative block is one 256-byte (f64) transaction.
// Ragged n is handled by masking; no padding sentinels are needed.
//
// K2 contracts theta_bar_c = sum_{a,b,i,j} Gbar[a,b]_ij dK_ab,ij/dtheta_c
// without building the (d, N, N) tensor dK/dtheta.  TPU grid steps ran in
// order and summed into one VMEM accumulator; GPU blocks run in no order,
// so each block writes its (d,) partial sum to a scratch buffer and a
// second small kernel adds the partials in a fixed order.  No atomics: the
// MLL gradient is bitwise the same from run to run.  The TPU kernel used a
// quadratic-form identity (x1c^2 . rowsum(M) + colsum(M) . x2c^2
// - 2 x1^T M x2) to feed its matrix unit; here each thread accumulates
// R_c^2 * M_W directly, which needs no matrix unit and avoids the
// cancellation of that identity when |x| is large against |R|.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTJ = 32;             // columns per tile = threads in x (one warp)
constexpr int kTY = 8;              // threads in y
constexpr int kRPT = 4;             // rows per thread
constexpr int kTI = kTY * kRPT;     // rows per tile
constexpr int kThreads = kTJ * kTY;

enum Family { kSqExp = 0, kMa5f2 = 1, kRatQu = 2 };

__device__ __forceinline__ float k_exp(float v) { return expf(v); }
__device__ __forceinline__ double k_exp(double v) { return exp(v); }
__device__ __forceinline__ float k_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double k_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float k_pow(float b, float e) { return powf(b, e); }
__device__ __forceinline__ double k_pow(double b, double e) { return pow(b, e); }

// phi(W) and its first three derivatives in W.  The Matern-5/2 phi''' is
// singular at W = 0 (the diagonal of K); it only ever multiplies products
// of R that vanish there, so it is set to 0 (0 * inf would give NaN).
template <typename T, int F>
__device__ __forceinline__ void phi_derivs(T W, T alpha, T& p0, T& p1, T& p2,
                                           T& p3) {
  if constexpr (F == kSqExp) {
    const T e = k_exp(-W);
    p0 = e;
    p1 = -e;
    p2 = e;
    p3 = -e;
  } else if constexpr (F == kMa5f2) {
    const T s5 = T(2.2360679774997896964091736687312762);
    const bool pos = W > T(0);
    const T nu = pos ? k_sqrt(W) : T(0);
    const T e = k_exp(-s5 * nu);
    p0 = (T(1) + s5 * nu + (T(5) / T(3)) * W) * e;
    p1 = -(T(5) / T(6)) * (T(1) + s5 * nu) * e;
    p2 = (T(25) / T(12)) * e;
    p3 = pos ? -(T(25) * s5 / T(24)) * e / nu : T(0);
  } else {
    const T B = T(1) + W / alpha;
    p0 = k_pow(B, -alpha);
    p1 = -k_pow(B, -alpha - T(1));
    p2 = (T(1) + T(1) / alpha) * k_pow(B, -alpha - T(2));
    p3 = -(T(1) + T(1) / alpha) * (T(1) + T(2) / alpha) *
         k_pow(B, -alpha - T(3));
  }
}

// Shared-memory tiles: sx1[c*kTI + r] = x1[i0 + r, c], sx2[c*kTJ + s] =
// x2[j0 + s, c] (zero past the ragged edge), sth[c] = theta[bt, c].
template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ x1,
                                           const T* __restrict__ x2,
                                           const T* __restrict__ theta, T* sx1,
                                           T* sx2, T* sth, int n1, int n2,
                                           int d, int i0, int j0, int bt,
                                           int tid) {
  for (int t = tid; t < d * kTI; t += kThreads) {
    const int c = t / kTI, r = t % kTI, i = i0 + r;
    sx1[t] = i < n1 ? x1[(size_t)i * d + c] : T(0);
  }
  for (int t = tid; t < d * kTJ; t += kThreads) {
    const int c = t / kTJ, s = t % kTJ, j = j0 + s;
    sx2[t] = j < n2 ? x2[(size_t)j * d + c] : T(0);
  }
  for (int t = tid; t < d; t += kThreads) sth[t] = theta[(size_t)bt * d + t];
}

// K1: out[bt] = gradient-enhanced K(x1, x2; theta[bt], alpha[bt]),
// out shape (B, (1+d) n1, (1+d) n2), row-major.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    kern_grad_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ theta, const T* __restrict__ alpha,
                     T* __restrict__ out, int n1, int n2, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx1 = reinterpret_cast<T*>(smem_raw);
  T* sx2 = sx1 + d * kTI;
  T* sth = sx2 + d * kTJ;

  const int bt = blockIdx.z;
  const int i0 = blockIdx.y * kTI, j0 = blockIdx.x * kTJ;
  const int tx = threadIdx.x, ty = threadIdx.y;
  load_tiles(x1, x2, theta, sx1, sx2, sth, n1, n2, d, i0, j0, bt,
             ty * kTJ + tx);
  __syncthreads();

  const T a = alpha[bt];
  const int j = j0 + tx;
  T p0[kRPT], p1[kRPT], p2[kRPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int il = ty + r * kTY;
    T W = T(0);
    for (int c = 0; c < d; ++c) {
      const T rc = sx1[c * kTI + il] - sx2[c * kTJ + tx];
      W += sth[c] * rc * rc;
    }
    T p3;
    phi_derivs<T, F>(W, a, p0[r], p1[r], p2[r], p3);
  }

  const int A = d + 1;
  const size_t ld = (size_t)A * n2;
  T* outb = out + (size_t)bt * A * n1 * ld;
  const bool jok = j < n2;
  for (int ab = 0; ab < A; ++ab) {
    const T tha = ab > 0 ? sth[ab - 1] : T(0);
    T Ra[kRPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r)
      Ra[r] = ab > 0 ? sx1[(ab - 1) * kTI + ty + r * kTY] -
                           sx2[(ab - 1) * kTJ + tx]
                     : T(0);
    for (int bb = 0; bb < A; ++bb) {
      const T thb = bb > 0 ? sth[bb - 1] : T(0);
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        const int i = i0 + ty + r * kTY;
        if (!jok || i >= n1) continue;
        const T Rb = bb > 0 ? sx1[(bb - 1) * kTI + ty + r * kTY] -
                                  sx2[(bb - 1) * kTJ + tx]
                            : T(0);
        T v;
        if (ab == 0 && bb == 0) {
          v = p0[r];
        } else if (ab == 0) {
          v = T(-2) * thb * Rb * p1[r];
        } else if (bb == 0) {
          v = T(2) * tha * Ra[r] * p1[r];
        } else {
          v = T(-4) * (tha * Ra[r]) * (thb * Rb) * p2[r];
          if (ab == bb) v += T(-2) * tha * p1[r];
        }
        outb[(size_t)(ab * n1 + i) * ld + (size_t)bb * n2 + j] = v;
      }
    }
  }
}

// K2, first pass: partial[bt, block, c] = this block's share of theta_bar_c.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    kern_vjp_theta_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                          const T* __restrict__ theta,
                          const T* __restrict__ alpha,
                          const T* __restrict__ gbar, T* __restrict__ partial,
                          int n1, int n2, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx1 = reinterpret_cast<T*>(smem_raw);
  T* sx2 = sx1 + d * kTI;
  T* sth = sx2 + d * kTJ;
  T* acc = sth + d;  // acc[c * kThreads + tid]: this thread's sum for theta_c

  const int bt = blockIdx.z;
  const int i0 = blockIdx.y * kTI, j0 = blockIdx.x * kTJ;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTJ + tx;
  load_tiles(x1, x2, theta, sx1, sx2, sth, n1, n2, d, i0, j0, bt, tid);
  for (int c = 0; c < d; ++c) acc[c * kThreads + tid] = T(0);
  __syncthreads();

  const T a = alpha[bt];
  const int j = j0 + tx;
  const int A = d + 1;
  const size_t ld = (size_t)A * n2;
  const T* gb = gbar + (size_t)bt * A * n1 * ld;

  for (int r = 0; r < kRPT; ++r) {
    const int il = ty + r * kTY;
    const int i = i0 + il;
    if (j >= n2 || i >= n1) continue;
    T W = T(0);
    for (int c = 0; c < d; ++c) {
      const T rc = sx1[c * kTI + il] - sx2[c * kTJ + tx];
      W += sth[c] * rc * rc;
    }
    T p0, p1, p2, p3;
    phi_derivs<T, F>(W, a, p0, p1, p2, p3);

    // mw: coefficient of R_c^2 (the chain through W), summed over blocks.
    // acc[c]: the explicit d/dtheta_c of the theta_a / theta_b factors.
    T mw = T(0);
    for (int ab = 0; ab < A; ++ab) {
      const int ca = ab - 1;
      const T tha = ab > 0 ? sth[ca] : T(0);
      const T Ra = ab > 0 ? sx1[ca * kTI + il] - sx2[ca * kTJ + tx] : T(0);
      const T ua = tha * Ra;
      const T* grow = gb + (size_t)(ab * n1 + i) * ld + j;
      T row_acc = T(0);  // explicit terms that go to theta_{ca}
      for (int bb = 0; bb < A; ++bb) {
        const T g = grow[(size_t)bb * n2];
        if (ab == 0 && bb == 0) {
          mw += p1 * g;
          continue;
        }
        const int cb = bb - 1;
        const T thb = bb > 0 ? sth[cb] : T(0);
        const T Rb = bb > 0 ? sx1[cb * kTI + il] - sx2[cb * kTJ + tx] : T(0);
        const T ub = thb * Rb;
        if (ab == 0) {
          mw += T(-2) * p2 * ub * g;
          acc[cb * kThreads + tid] += T(-2) * Rb * p1 * g;
        } else if (bb == 0) {
          mw += T(2) * p2 * ua * g;
          row_acc += T(2) * Ra * p1 * g;
        } else {
          mw += T(-4) * p3 * ua * ub * g;
          row_acc += T(-4) * Ra * p2 * ub * g;
          acc[cb * kThreads + tid] += T(-4) * Rb * p2 * ua * g;
          if (ab == bb) {
            mw += T(-2) * p2 * tha * g;
            row_acc += T(-2) * p1 * g;
          }
        }
      }
      if (ab > 0) acc[ca * kThreads + tid] += row_acc;
    }
    for (int c = 0; c < d; ++c) {
      const T rc = sx1[c * kTI + il] - sx2[c * kTJ + tx];
      acc[c * kThreads + tid] += rc * rc * mw;
    }
  }
  __syncthreads();

  // fixed-order tree reduction over the block's threads, every c at once
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int c = 0; c < d; ++c)
        acc[c * kThreads + tid] += acc[c * kThreads + tid + s];
    __syncthreads();
  }
  const size_t nblk = (size_t)gridDim.x * gridDim.y;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int c = tid; c < d; c += kThreads)
    partial[((size_t)bt * nblk + blk) * d + c] = acc[c * kThreads];
}

// K2, second pass: out[bt, c] = sum over blocks of partial[bt, :, c], in
// block order.
template <typename T>
__global__ void kern_vjp_theta_reduce(const T* __restrict__ partial,
                                      T* __restrict__ out, int nblk, int d,
                                      int B) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * d) return;
  const int bt = t / d, c = t % d;
  const T* p = partial + (size_t)bt * nblk * d + c;
  T s = T(0);
  for (int k = 0; k < nblk; ++k) s += p[(size_t)k * d];
  out[t] = s;
}

size_t tile_smem_bytes(int d, size_t elem, bool with_acc) {
  return ((size_t)d * (kTI + kTJ + 1) + (with_acc ? (size_t)d * kThreads : 0)) *
         elem;
}

dim3 tile_grid(int n1, int n2, int B) {
  return dim3((n2 + kTJ - 1) / kTJ, (n1 + kTI - 1) / kTI, B);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int F>
cudaError_t launch_k1(const void* x1, const void* x2, const void* theta,
                      const void* alpha, void* out, int B, int n1, int n2,
                      int d, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(d, sizeof(T), false);
  cudaError_t err = allow_smem(kern_grad_kernel<T, F>, smem);
  if (err != cudaSuccess) return err;
  kern_grad_kernel<T, F><<<tile_grid(n1, n2, B), dim3(kTJ, kTY), smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const T*>(theta), static_cast<const T*>(alpha),
      static_cast<T*>(out), n1, n2, d);
  return cudaGetLastError();
}

template <typename T, int F>
cudaError_t launch_k2(const void* x1, const void* x2, const void* theta,
                      const void* alpha, const void* gbar, void* partial,
                      void* out, int B, int n1, int n2, int d,
                      cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(d, sizeof(T), true);
  cudaError_t err = allow_smem(kern_vjp_theta_kernel<T, F>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = tile_grid(n1, n2, B);
  kern_vjp_theta_kernel<T, F><<<grid, dim3(kTJ, kTY), smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const T*>(theta), static_cast<const T*>(alpha),
      static_cast<const T*>(gbar), static_cast<T*>(partial), n1, n2, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nblk = grid.x * grid.y;
  const int threads = 128;
  kern_vjp_theta_reduce<T><<<(B * d + threads - 1) / threads, threads, 0,
                             stream>>>(static_cast<const T*>(partial),
                                       static_cast<T*>(out), nblk, d, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the K2 scratch buffer (per call) for these sizes.
long long kern_vjp_theta_scratch(int B, int n1, int n2, int d) {
  const dim3 g = tile_grid(n1, n2, B);
  return (long long)B * g.x * g.y * d;
}

// Largest d the kernels take with the given element size (shared memory).
int kern_max_dim(int elem_bytes) {
  int d = 1;
  while (tile_smem_bytes(d + 1, (size_t)elem_bytes, true) <= 227 * 1024) ++d;
  return d;
}

// dtype: 0 = float32, 1 = float64.  family: 0 SqExp, 1 Ma5f2, 2 RatQu.
int kern_grad_launch(int dtype, int family, const void* x1, const void* x2,
                     const void* theta, const void* alpha, void* out, int B,
                     int n1, int n2, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_CASE(T, F) return (int)launch_k1<T, F>(x1, x2, theta, alpha, out, B, n1, n2, d, s)
  if (dtype == 1) {
    if (family == kSqExp) K1_CASE(double, kSqExp);
    if (family == kMa5f2) K1_CASE(double, kMa5f2);
    if (family == kRatQu) K1_CASE(double, kRatQu);
  } else if (dtype == 0) {
    if (family == kSqExp) K1_CASE(float, kSqExp);
    if (family == kMa5f2) K1_CASE(float, kMa5f2);
    if (family == kRatQu) K1_CASE(float, kRatQu);
  }
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
}

int kern_vjp_theta_launch(int dtype, int family, const void* x1,
                          const void* x2, const void* theta, const void* alpha,
                          const void* gbar, void* partial, void* out, int B,
                          int n1, int n2, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_CASE(T, F) \
  return (int)launch_k2<T, F>(x1, x2, theta, alpha, gbar, partial, out, B, n1, n2, d, s)
  if (dtype == 1) {
    if (family == kSqExp) K2_CASE(double, kSqExp);
    if (family == kMa5f2) K2_CASE(double, kMa5f2);
    if (family == kRatQu) K2_CASE(double, kRatQu);
  } else if (dtype == 0) {
    if (family == kSqExp) K2_CASE(float, kSqExp);
    if (family == kMa5f2) K2_CASE(float, kMa5f2);
    if (family == kRatQu) K2_CASE(float, kRatQu);
  }
#undef K2_CASE
  return (int)cudaErrorInvalidValue;
}

const char* kern_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
