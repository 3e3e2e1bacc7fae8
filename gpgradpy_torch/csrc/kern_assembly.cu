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
// elements and K2 reads as many, each once; the arithmetic is a few
// operations per element, far below the card's f64 rate.  At the L-BFGS
// objective's shape (one theta row, n = 200, d = 10, f64) that is 38.7 MB,
// 11.6 us at 3.35 TB/s.  One launch therefore has to spread over all 132
// SMs (a grid of one block per 32 x 32 point tile gives 49 blocks), and
// each SM has to keep tens of KB of requests in flight.
//
// Tiles: 16 x 32 points.  Thread tid owns one 16-byte vector, the V =
// 16 / sizeof(T) neighbouring columns jl .. jl + V - 1 of tile row il:
// V point pairs, 256 threads a block in f64, 128 in f32.  Each block loads
// its x1/x2 tiles and theta into shared memory (transposed, zero past the
// ragged edge) and computes W and phi's derivatives for its pairs once.
// Ragged n is masked, with no padding sentinels.  Where n2 is not a
// multiple of V, or the cotangent / output is not 16-byte aligned, the
// kernels read and write element by element under the edge mask.
//
// K1 (assembly).  Grid (tiles, 1+d, B): one block per point tile,
// derivative row a and batch row; 1001 blocks at n = 200, d = 10, B = 1,
// about two resident waves in f64.  The 1+d blocks of a tile each recompute phi:
// (1+d) n1 n2 transcendentals against (1+d)^2 n1 n2 stored elements.  A
// block walks the 1+d column blocks b of its row a and stores each value
// vector with one 16-byte store (st.global.v2.f64 / .v4.f32), so a warp
// writes whole 128-byte lines.
//
// K2 (theta-cotangent) contracts theta_bar_c = sum_{a,b,i,j} Gbar[a,b]_ij
// dK_ab,ij/dtheta_c without building dK/dtheta.  Grid (tiles, groups, B):
// a block walks a group of `rows` consecutive derivative rows a of its
// tile and reads Gbar[a, b] for every b, each element once.  The launcher
// takes the fewest groups that still give one resident wave of blocks
// (1024 threads on every SM): at B = 1 (n = 200, d = 10, f64) 6 groups of
// 2 rows, 546 blocks; at B = 41 one group of all 11 rows, 3731 blocks.
// Larger groups spread the per-block work (tiles, phi, the W chain and
// the reductions) over more bytes; with one row per block that work took
// longer than the stream.  Each thread reads its cotangent vectors with
// kLoads independent 16-byte read-only loads in flight (ld.global.nc):
// 16 KB a block, 64 KB an SM.  A shared-memory ring filled by cp.async,
// with a barrier per stage, streamed the same bytes much slower than these
// direct loads on an H100 (PERF.md, section 6), so K2 has no ring.
// The contraction is regrouped so that every accumulator a thread touches
// is fixed: with u = theta o R and g_ab = Gbar[a, b]_ij, per point pair
//   theta_bar_c += R_c^2 m_W                                  (W chain)
//                + R_c s_a g_ac        s_0 = -2 p1,  s_a = -4 p2 u_a
//                + [c = a] (R_a (2 p1 g_a0 - 4 p2 dot_a) - 2 p1 g_aa)
//   m_W = sum_a m_a,  m_0 = p1 g_00 - 2 p2 dot_0,
//   m_a = 2 p2 u_a g_a0 - 4 p3 u_a dot_a - 2 p2 theta_a g_aa,
//   dot_a = sum_{b >= 1} u_b g_ab.
// A thread keeps p1, p2, p3, m_W and, for the current row, s, dot, g_a0
// and g_aa in registers, per pair.  Each column block c of row a gives the
// term R_c s_a g_ac, summed over the thread's pairs in registers, over the
// warp by shuffles, and added by lane 0 to the warp's slot wacc[c][warp]
// in shared memory: one add per warp and column block, none per element.
// The diagonal term follows per row, the W chain once per block.  A second
// kernel adds the blocks' partials in a fixed order (no atomics: the MLL
// gradient is bitwise the same from run to run).  The TPU kernel's
// quadratic-form identity for the W chain, which fed its matrix unit, is
// not used: R_c^2 m_W is summed per pair, which avoids the identity's
// cancellation when |x| >> |R|.  The same regrouping in plain torch:
// cuda_assembly.kern_grad_vjp_theta_regrouped.
//
// Resources per block: nvcc -Xptxas -v (chip_smoke.py prints it at build);
// at most 64 registers a thread (launch bounds: 1024 threads an SM).
// Shared memory is dynamic: K1 d (16 + 32 + 1) elements, K2 d (16 + 32 + 1
// + warps) elements; kern_max_dim reckons the d range from the larger.
//
// alpha (RatQu's exponent) may be null for the other families.  Every entry
// point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kLoads = 4;             // K2's cotangent loads in flight
constexpr int kReduceThreads = 256;
constexpr int kThreadsPerSM = 1024;   // resident threads both kernels aim at

// A 16 x 32 point tile; thread tid owns the V pairs (row(tid), col(tid) + k).
template <typename T>
struct Tile {
  static constexpr int kTI = 16, kTJ = 32;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int kThreads = kTI * kTJ / V;
  static constexpr int kWarps = kThreads / 32;
  __device__ static int row(int tid) { return tid / (kTJ / V); }
  __device__ static int col(int tid) { return V * (tid % (kTJ / V)); }
};

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
  using M = Tile<T>;
  for (int t = tid; t < d * M::kTI; t += M::kThreads) {
    const int c = t / M::kTI, r = t % M::kTI, i = i0 + r;
    sx1[t] = i < n1 ? x1[(size_t)i * d + c] : T(0);
  }
  for (int t = tid; t < d * M::kTJ; t += M::kThreads) {
    const int c = t / M::kTJ, s = t % M::kTJ, j = j0 + s;
    sx2[t] = j < n2 ? x2[(size_t)j * d + c] : T(0);
  }
  for (int t = tid; t < d; t += M::kThreads) sth[t] = theta[(size_t)bt * d + t];
}

// R_c of the pair (tile row il, tile column jl).
template <typename T>
__device__ __forceinline__ T pair_R(const T* sx1, const T* sx2, int c, int il,
                                    int jl) {
  return sx1[c * Tile<T>::kTI + il] - sx2[c * Tile<T>::kTJ + jl];
}

// W of the pair (tile row il, tile column jl).
template <typename T>
__device__ __forceinline__ T pair_W(const T* sx1, const T* sx2, const T* sth,
                                    int d, int il, int jl) {
  T W = T(0);
  for (int c = 0; c < d; ++c) {
    const T rc = pair_R(sx1, sx2, c, il, jl);
    W += sth[c] * rc * rc;
  }
  return W;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T* v) {
  if constexpr (sizeof(T) == 8)
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A thread's V cotangent values at p, columns j .. j + V - 1 of one row:
// one 16-byte read-only load (ld.global.nc.v2.f64 / .v4.f32) where vec,
// else element by element under the edge mask; zero past the edge.
template <typename T>
__device__ __forceinline__ void load_row_vec(const T* __restrict__ p,
                                             bool row_ok, int j, int n2,
                                             bool vec, T* v) {
  constexpr int V = 16 / sizeof(T);
  if (vec && row_ok && j < n2) {
    if constexpr (sizeof(T) == 8) {
      const double2 q = __ldg(reinterpret_cast<const double2*>(p));
      v[0] = q.x;
      v[1] = q.y;
    } else {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    v[k] = !vec && row_ok && j + k < n2 ? __ldg(p + k) : T(0);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the sum, taken in a fixed order
}

// K1: out[bt] = gradient-enhanced K(x1, x2; theta[bt], alpha[bt]),
// out shape (B, (1+d) n1, (1+d) n2), row-major.  Block (tile, a, bt)
// writes the rows a*n1 + i of its tile, all column blocks.
template <typename T, int F>
__global__ void __launch_bounds__(Tile<T>::kThreads,
                                  kThreadsPerSM / Tile<T>::kThreads)
    kern_grad_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ theta, const T* __restrict__ alpha,
                     T* __restrict__ out, int n1, int n2, int d, int ntj,
                     int vec) {
  using M = Tile<T>;
  constexpr int V = M::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx1 = reinterpret_cast<T*>(smem_raw);
  T* sx2 = sx1 + d * M::kTI;
  T* sth = sx2 + d * M::kTJ;

  const int bt = blockIdx.z, a = blockIdx.y;
  const int i0 = (blockIdx.x / ntj) * M::kTI;
  const int j0 = (blockIdx.x % ntj) * M::kTJ;
  const int tid = threadIdx.x, il = M::row(tid), jl = M::col(tid);
  load_tiles(x1, x2, theta, sx1, sx2, sth, n1, n2, d, i0, j0, bt, tid);
  __syncthreads();
  const int i = i0 + il, j = j0 + jl;
  if (i >= n1) return;

  const T al = alpha ? alpha[bt] : T(0);
  const T tha = a > 0 ? sth[a - 1] : T(0);
  T p0[V], p1[V], p2[V], ua[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    T p3;
    phi_derivs<T, F>(pair_W(sx1, sx2, sth, d, il, jl + k), al, p0[k], p1[k],
                     p2[k], p3);
    ua[k] = a > 0 ? tha * pair_R(sx1, sx2, a - 1, il, jl + k) : T(0);
  }

  const int A = d + 1;
  const size_t ld = (size_t)A * n2;
  T* orow = out + (((size_t)bt * A + a) * n1 + i) * ld + j;
  for (int b = 0; b < A; ++b) {
    const T thb = b > 0 ? sth[b - 1] : T(0);
    T v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T ub = b > 0 ? thb * pair_R(sx1, sx2, b - 1, il, jl + k) : T(0);
      if (a == 0)
        v[k] = b == 0 ? p0[k] : T(-2) * ub * p1[k];
      else if (b == 0)
        v[k] = T(2) * ua[k] * p1[k];
      else
        v[k] = T(-4) * ua[k] * ub * p2[k] +
               (a == b ? T(-2) * tha * p1[k] : T(0));
    }
    T* p = orow + (size_t)b * n2;
    if (vec) {
      if (j < n2) store_vec(p, v);  // n2 % V == 0: all of the vector or none
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (j + k < n2) p[k] = v[k];
    }
  }
}

// K2, first pass: partial[bt, c, blk] = block blk's share of theta_bar_c,
// blk = group * tiles + tile; the block walks derivative rows
// a0 = group * rows .. a0 + rows - 1.  The regrouped contraction of the
// head note.
template <typename T, int F>
__global__ void __launch_bounds__(Tile<T>::kThreads,
                                  kThreadsPerSM / Tile<T>::kThreads)
    kern_vjp_theta_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                          const T* __restrict__ theta,
                          const T* __restrict__ alpha,
                          const T* __restrict__ gbar, T* __restrict__ partial,
                          int n1, int n2, int d, int ntj, int rows, int vec) {
  using M = Tile<T>;
  constexpr int V = M::V, W = M::kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx1 = reinterpret_cast<T*>(smem_raw);
  T* sx2 = sx1 + d * M::kTI;
  T* sth = sx2 + d * M::kTJ;
  T* wacc = sth + d;  // [d][W]: each warp's sum for theta_c

  const int bt = blockIdx.z, tile = blockIdx.x;
  const int i0 = (tile / ntj) * M::kTI, j0 = (tile % ntj) * M::kTJ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int il = M::row(tid), jl = M::col(tid);
  const int A = d + 1;
  const int a0 = blockIdx.y * rows, na = min(rows, A - a0);
  const size_t ld = (size_t)A * n2;
  const bool row_ok = i0 + il < n1;
  const int j = j0 + jl;
  // this thread's cotangent row in derivative row a0, column block 0
  const T* g_a0 = gbar + (((size_t)bt * A + a0) * n1 + i0 + il) * ld + j;

  load_tiles(x1, x2, theta, sx1, sx2, sth, n1, n2, d, i0, j0, bt, tid);
  for (int t = tid; t < d * W; t += M::kThreads) wacc[t] = T(0);
  __syncthreads();

  // phi's derivatives, zero for pairs past the ragged edge, which zeroes
  // every term of those pairs (their cotangent values read as zero)
  const T al = alpha ? alpha[bt] : T(0);
  T p1[V], p2[V], p3[V], mw[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    T p0;
    phi_derivs<T, F>(pair_W(sx1, sx2, sth, d, il, jl + k), al, p0, p1[k],
                     p2[k], p3[k]);
    if (!row_ok || j + k >= n2) p1[k] = p2[k] = p3[k] = T(0);
    mw[k] = T(0);
  }

  for (int a = a0; a < a0 + na; ++a) {
    const T* grow = g_a0 + (size_t)(a - a0) * n1 * ld;
    const T tha = a > 0 ? sth[a - 1] : T(0);
    T s[V], dot[V], g0[V], gaa[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = a == 0 ? T(-2) * p1[k]
                    : T(-4) * p2[k] * tha * pair_R(sx1, sx2, a - 1, il, jl + k);
      dot[k] = g0[k] = gaa[k] = T(0);
    }
    for (int bs = 0; bs < A; bs += kLoads) {
      // kLoads independent 16-byte loads in flight before any is used
      T g[kLoads][V];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        load_row_vec(grow + (size_t)(bs + u) * n2, row_ok && bs + u < A, j, n2,
                     vec, g[u]);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int b = bs + u;
        if (b >= A) break;
        if (b == 0) {
#pragma unroll
          for (int k = 0; k < V; ++k) g0[k] = g[u][k];
          continue;
        }
        const int c = b - 1;
        const T thb = sth[c];
        T part = T(0);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const T rg = pair_R(sx1, sx2, c, il, jl + k) * g[u][k];
          part += rg * s[k];
          dot[k] += thb * rg;
        }
        if (b == a) {
#pragma unroll
          for (int k = 0; k < V; ++k) gaa[k] = g[u][k];
        }
        part = warp_sum(part);
        if (lane == 0) wacc[c * W + warp] += part;
      }
    }
    // the row's share of m_W and, for a > 0, its diagonal term
    T e = T(0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (a == 0) {
        mw[k] += p1[k] * g0[k] - T(2) * p2[k] * dot[k];
      } else {
        const T Ra = pair_R(sx1, sx2, a - 1, il, jl + k), ua = tha * Ra;
        mw[k] += T(2) * p2[k] * ua * g0[k] - T(4) * p3[k] * ua * dot[k] -
                 T(2) * p2[k] * tha * gaa[k];
        e += Ra * (T(2) * p1[k] * g0[k] - T(4) * p2[k] * dot[k]) -
             T(2) * p1[k] * gaa[k];
      }
    }
    if (a > 0) {
      e = warp_sum(e);
      if (lane == 0) wacc[(a - 1) * W + warp] += e;
    }
  }

  // the W chain, once per block
  for (int c = 0; c < d; ++c) {
    T v = T(0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T rc = pair_R(sx1, sx2, c, il, jl + k);
      v += rc * rc * mw[k];
    }
    v = warp_sum(v);
    if (lane == 0) wacc[c * W + warp] += v;
  }
  __syncthreads();
  const size_t nblk = (size_t)gridDim.x * gridDim.y;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + tile;
  for (int c = tid; c < d; c += M::kThreads) {
    T sum = T(0);
#pragma unroll
    for (int w = 0; w < W; ++w) sum += wacc[c * W + w];
    partial[((size_t)bt * d + c) * nblk + blk] = sum;
  }
}

// K2, second pass: out[bt, c] = sum over blocks of partial[bt, c, :]; one
// block per (c, bt), a strided sum per thread and a tree over the threads,
// all in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    kern_vjp_theta_reduce(const T* __restrict__ partial, T* __restrict__ out,
                          int nblk, int d) {
  __shared__ T sum[kReduceThreads];
  const int c = blockIdx.x, bt = blockIdx.y, tid = threadIdx.x;
  const T* p = partial + ((size_t)bt * d + c) * nblk;
  T v = T(0);
  for (int k = tid; k < nblk; k += kReduceThreads) v += p[k];
  sum[tid] = v;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (tid < h) sum[tid] += sum[tid + h];
    __syncthreads();
  }
  if (tid == 0) out[(size_t)bt * d + c] = sum[0];
}

template <typename T>
size_t k1_smem_bytes(int d) {
  return (size_t)d * (Tile<T>::kTI + Tile<T>::kTJ + 1) * sizeof(T);
}

template <typename T>
size_t k2_smem_bytes(int d) {
  return k1_smem_bytes<T>(d) + (size_t)d * Tile<T>::kWarps * sizeof(T);
}

template <typename T>
int tiles_j(int n2) {
  return (n2 + Tile<T>::kTJ - 1) / Tile<T>::kTJ;
}

template <typename T>
int n_tiles(int n1, int n2) {
  return ((n1 + Tile<T>::kTI - 1) / Tile<T>::kTI) * tiles_j<T>(n2);
}

// K2's launch shape: the fewest groups of derivative rows per tile that
// still give one resident wave of blocks (kThreadsPerSM threads on every
// SM of the current device).  The scratch size and the launch both come
// from here.
struct K2Shape {
  dim3 grid;
  int rows;
};

template <typename T>
K2Shape k2_shape(int n1, int n2, int d, int B) {
  int dev = 0, nsm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    nsm = 132;
  const long long A = d + 1, tiles = (long long)n_tiles<T>(n1, n2) * B;
  const long long wave = (long long)nsm * (kThreadsPerSM / Tile<T>::kThreads);
  const long long groups = std::min(A, (wave + tiles - 1) / tiles);
  const int rows = (int)((A + groups - 1) / groups);
  return {dim3(n_tiles<T>(n1, n2), (int)((A + rows - 1) / rows), B), rows};
}

// 16-byte vectors need n2 % V == 0 (every row segment then starts on a
// vector) and a 16-byte aligned base.
template <typename T>
int vec_ok(const void* base, int n2) {
  return n2 % Tile<T>::V == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
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
  const size_t smem = k1_smem_bytes<T>(d);
  cudaError_t err = allow_smem(kern_grad_kernel<T, F>, smem);
  if (err != cudaSuccess) return err;
  kern_grad_kernel<T, F><<<dim3(n_tiles<T>(n1, n2), d + 1, B),
                           Tile<T>::kThreads, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const T*>(theta), static_cast<const T*>(alpha),
      static_cast<T*>(out), n1, n2, d, tiles_j<T>(n2), vec_ok<T>(out, n2));
  return cudaGetLastError();
}

template <typename T, int F>
cudaError_t launch_k2(const void* x1, const void* x2, const void* theta,
                      const void* alpha, const void* gbar, void* partial,
                      void* out, int B, int n1, int n2, int d,
                      cudaStream_t stream) {
  const size_t smem = k2_smem_bytes<T>(d);
  cudaError_t err = allow_smem(kern_vjp_theta_kernel<T, F>, smem);
  if (err != cudaSuccess) return err;
  const K2Shape sh = k2_shape<T>(n1, n2, d, B);
  kern_vjp_theta_kernel<T, F><<<sh.grid, Tile<T>::kThreads, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const T*>(theta), static_cast<const T*>(alpha),
      static_cast<const T*>(gbar), static_cast<T*>(partial), n1, n2, d,
      tiles_j<T>(n2), sh.rows, vec_ok<T>(gbar, n2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kern_vjp_theta_reduce<T><<<dim3(d, B), kReduceThreads, 0, stream>>>(
      static_cast<const T*>(partial), static_cast<T*>(out),
      (int)(sh.grid.x * sh.grid.y), d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the K2 scratch buffer (per call) for these sizes.
// dtype: 0 = float32, 1 = float64.
long long kern_vjp_theta_scratch(int dtype, int B, int n1, int n2, int d) {
  const K2Shape sh = dtype == 1 ? k2_shape<double>(n1, n2, d, B)
                                : k2_shape<float>(n1, n2, d, B);
  return (long long)B * d * sh.grid.x * sh.grid.y;
}

// Largest d the kernels take with the given element size (K2's shared
// memory is the larger).
int kern_max_dim(int elem_bytes) {
  size_t (*k2)(int) =
      elem_bytes == 8 ? &k2_smem_bytes<double> : &k2_smem_bytes<float>;
  int d = 1;
  while (k2(d + 1) <= 227 * 1024) ++d;
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
