// Device helpers shared by the kernels of this directory: the per-edge d1
// pair prox with relaxation, the vertex prox, deterministic block
// reductions, the stencil index arithmetic, and the cooperative launch of
// the kernels that synchronise their whole grid.  Formulas follow
// PFDR_graph_quadratic_d1_l1.cpp:463-529 and the JAX package's kernels
// (ops/stencil_fused.py:_kernel, ops/solve_small.py:_kernel).
#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace cp_pfdr {

// shift families of a stencil graph: family f links cell (i, j) to
// ((i + dy[f]) mod H, (j + dx[f]) mod W)
constexpr int kMaxFamilies = 16;

struct Shifts {
  int n;
  int dy[kMaxFamilies];
  int dx[kMaxFamilies];
};

inline int make_shifts(int f, const int *flat, Shifts &sh) {
  if (f < 1 || f > kMaxFamilies) return -1;
  sh.n = f;
  for (int k = 0; k < f; ++k) {
    sh.dy[k] = flat[2 * k];
    sh.dx[k] = flat[2 * k + 1];
  }
  return 0;
}

__device__ __forceinline__ int wrap_index(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// cell reached from (i, j) by the shift (dy, dx), circular on both axes
__device__ __forceinline__ int shifted_cell(int i, int j, int dy, int dx,
                                            int h, int w) {
  return wrap_index(i + dy, h) * w + wrap_index(j + dx, w);
}

// Rows of an incidence list (a vertex's endpoint slots) longer than this
// are summed by a block each: a hub vertex walked by one thread would
// serialize the whole launch.  The container's padding edges, weight-0
// copies of its last edge, make such hubs on any graph.
constexpr int kLongRow = 64;

// the contiguous run [lo, hi) of a long row's slots [beg, end) that this
// thread of the block sums, in slot order (empty when lo >= end)
__device__ __forceinline__ void long_row_run(int beg, int end, int &lo,
                                             int &hi) {
  const int run = (end - beg + blockDim.x - 1) / blockDim.x;
  lo = beg + threadIdx.x * run;
  hi = min(lo + run, end);
}

enum VertexKind { kVertexNone = 0, kVertexL1 = 1, kVertexBounds = 2 };

// forward step P = 2 X - Gamma grad (:463-464).  Every evaluation of a
// vertex's forward value goes through this one function, so two threads
// that both need it get the same bits.
template <typename T>
__device__ __forceinline__ T forward_value(T x, T ga, T grad) {
  return T(2) * x - ga * grad;
}

// d1 pair prox on the auxiliary pair (zu, zv) of one edge, then relaxation
// by rho (:466-489).  pu/pv: forward values of the endpoints, xu/xv: current
// iterates of the endpoints.
template <typename T>
__device__ __forceinline__ void pair_prox_relax(
    T pu, T pv, T zu, T zv, T xu, T xv, T wdu, T wdv, T th, T rho,
    T &zu_new, T &zv_new) {
  const T au = pu - zu;
  const T av = pv - zv;
  const T avg = wdu * au + wdv * av;
  const T diff = au - av;
  T mag = fabs(diff) - th;
  mag = mag > T(0) ? mag : T(0);
  const T shrunk = diff > T(0) ? mag : (diff < T(0) ? -mag : T(0));
  zu_new = zu + rho * ((avg + wdv * shrunk) - xu);
  zv_new = zv + rho * ((avg - wdu * shrunk) - xv);
}

// vertex prox (:499-512): l1 soft threshold (+ positivity), box clamp, or
// none (+ positivity)
template <typename T>
__device__ __forceinline__ T vertex_prox(T a, T th_l1, int kind,
                                         int positivity, T lo, T hi) {
  if (kind == kVertexL1) {
    T pos = a - th_l1;
    pos = pos > T(0) ? pos : T(0);
    if (!positivity) {
      T neg = a + th_l1;
      pos += neg < T(0) ? neg : T(0);
    }
    return pos;
  }
  if (kind == kVertexBounds) {
    T c = a > lo ? a : lo;
    return c < hi ? c : hi;
  }
  if (positivity) return a > T(0) ? a : T(0);
  return a;
}

// end of a quadratic stage at one vertex: the vertex prox of the average
// acc, the new iterate written to *xo, and the two evolution terms
// (x_new - x)^2 and x_new^2
template <typename T>
__device__ __forceinline__ void stage_vertex_tail(T acc, T th_l1, T xc,
                                                  int kind, int positivity,
                                                  T lo, T hi, T *xo, T &num,
                                                  T &den) {
  const T xn = vertex_prox(acc, th_l1, kind, positivity, lo, hi);
  *xo = xn;
  const T d = xn - xc;
  num = d * d;
  den = xn * xn;
}

enum LossKind { kLossLinear = 0, kLossQuadratic = 1, kLossKL = 2 };

// loss of the multi-label (simplex) PFDR, keyed on al as in
// PFDR_graph_loss_d1_simplex.cpp:144-156
template <typename T>
struct SimplexLoss {
  int kind;
  int has_laf;
  T al_k;  // al / K
  T al_1;  // 1 - al
};

template <typename T>
inline SimplexLoss<T> make_simplex_loss(double al, int k, int has_laf) {
  SimplexLoss<T> ls;
  ls.kind = al == 0.0 ? kLossLinear : (al == 1.0 ? kLossQuadratic : kLossKL);
  ls.has_laf = has_laf;
  ls.al_k = T(al / k);
  ls.al_1 = T(1.0 - al);
  return ls;
}

// forward value 2 p - Gamma g of one label at one vertex, with the loss
// gradient written as ops/stencil_fused_simplex.py writes it.  Every
// evaluation goes through this one function, so two threads that need the
// same vertex's value get the same bits.
template <typename T>
__device__ __forceinline__ T simplex_forward(T p, T q, T laf, T ga,
                                             const SimplexLoss<T> &ls) {
  T g;
  if (ls.kind == kLossLinear) {
    g = -q;
  } else {
    if (ls.kind == kLossQuadratic)
      g = p - q;
    else
      g = -ls.al_1 * (ls.al_k + ls.al_1 * q) / (ls.al_k + ls.al_1 * p);
    if (ls.has_laf) g = g * laf;
  }
  return T(2) * p - ga * g;
}

// Michelot projection onto the simplex {p >= 0, sum p = 1} in the metric
// diag(m) (proj_simplex_metric.cpp:19-83): K passes over the active set,
// in registers for a compile-time K (KA == K) or local memory otherwise.
// Returns the multiplier la; the projection is p_k = max(acc_k - la m_k, 0).
template <typename T, int KA>
__device__ __forceinline__ T michelot_multiplier(const T (&acc)[KA],
                                                 const T (&m)[KA], int K) {
  bool act[KA];
#pragma unroll
  for (int k = 0; k < K; ++k) act[k] = true;
  T la = T(0);
  for (int pass = 0; pass < K; ++pass) {
    T sx = act[0] ? acc[0] : T(0);
    T sm = act[0] ? m[0] : T(0);
#pragma unroll
    for (int k = 1; k < K; ++k) {
      sx = sx + (act[k] ? acc[k] : T(0));
      sm = sm + (act[k] ? m[k] : T(0));
    }
    la = (sx - T(1)) / (sm > T(0) ? sm : T(1));
#pragma unroll
    for (int k = 0; k < K; ++k) act[k] = act[k] && (acc[k] - la * m[k] > T(0));
  }
  return la;
}

// Sums (a, b) over the block in a fixed order: shuffle tree inside each
// warp, then warp 0 over the per-warp sums.  The result is valid in thread
// 0.  scratch holds 2 * 32 values.  Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void block_sum2(T &a, T &b, T *scratch) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(full, a, off);
    b += __shfl_down_sync(full, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < nwarps ? scratch[lane] : T(0);
    b = lane < nwarps ? scratch[32 + lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(full, a, off);
      b += __shfl_down_sync(full, b, off);
    }
  }
  __syncthreads();
}

// Sums K values per thread over the block in a fixed order (shuffle tree
// inside each warp, then thread k < K adds the per-warp sums in warp
// order).  The K sums are valid in threads 0..K-1 (thread k holds sum k).
// scratch holds 32 * K values.  Every thread of the block must call it.
template <typename T, int K>
__device__ __forceinline__ void block_sum_k(T (&v)[K], T *scratch, T &out) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(full, v[k], off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[k * 32 + warp] = v[k];
  }
  __syncthreads();
  out = T(0);
  if (threadIdx.x < K)
    for (int q = 0; q < nwarps; ++q) out += scratch[threadIdx.x * 32 + q];
  __syncthreads();
}

// Ends a launch's N sums (N = 1 or 2) in the launch itself.  Call with
// every thread of the block, after a block reduction that left the block's
// sums v[0..N-1] in thread 0.  Thread 0 writes them to
// partials[N blockIdx.x ...], then takes an integer ticket with one
// acquire-release atomic (it publishes the partials; the barrier after it
// passes what the last block's thread 0 acquired on to its other threads,
// as a semaphore does): the last block to finish adds every block's
// partials in a fixed order (thread i loads the blocks i, i + blockDim.x,
// ..., i + (W - 1) blockDim.x at once, adds them pairwise, then moves on
// by W blockDim.x; then block_sum2), writes sums[0..N-1] and resets the
// ticket to 0 for the next launch.  No float atomics: the sums are the
// same in every run.  One ticket serves one launch at a time.  W (1, 2 or
// 4) is the caller's, measured on the H100 (PERF.md, section 6):
// stencil_fused was 0.3 us faster at W = 1, banded_fused and
// stencil_fused_simplex 0.1-0.3 us faster at W = 4, circulant_fused the
// same at both.
template <int W, int N, typename T>
__device__ __forceinline__ void last_block_sums_n(const T (&v)[N],
                                                  T *partials, int *ticket,
                                                  T *sums, T *scratch) {
  static_assert(N == 1 || N == 2, "one or two sums");
  static_assert(W == 1 || W == 2 || W == 4, "1, 2 or 4 partials a round");
  __shared__ int is_last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) partials[N * blockIdx.x + n] = v[n];
    cuda::atomic_ref<int, cuda::thread_scope_device> t(*ticket);
    is_last = t.fetch_add(1, cuda::memory_order_acq_rel) ==
              static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!is_last) return;
  const int g = gridDim.x, nt = blockDim.x;
  T s[2] = {T(0), T(0)};
  for (int k0 = threadIdx.x; k0 < g; k0 += W * nt) {
    T x[W][N];
#pragma unroll
    for (int r = 0; r < W; ++r)
#pragma unroll
      for (int n = 0; n < N; ++n)
        x[r][n] = k0 + r * nt < g ? __ldcg(&partials[N * (k0 + r * nt) + n])
                                  : T(0);
#pragma unroll
    for (int step = 1; step < W; step *= 2)
#pragma unroll
      for (int r = 0; r + step < W; r += 2 * step)
#pragma unroll
        for (int n = 0; n < N; ++n) x[r][n] = x[r][n] + x[r + step][n];
#pragma unroll
    for (int n = 0; n < N; ++n) s[n] = s[n] + x[0][n];
  }
  block_sum2(s[0], s[1], scratch);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) sums[n] = s[n];
    *ticket = 0;
  }
}

// last_block_sums_n of two sums (a, b): partials [2 blocks], sums[0..1]
template <int W = 1, typename T>
__device__ __forceinline__ void last_block_sums(T a, T b, T *partials,
                                                int *ticket, T *sums,
                                                T *scratch) {
  const T v[2] = {a, b};
  last_block_sums_n<W>(v, partials, ticket, sums, scratch);
}

// last_block_sums_n of one sum a: partials [blocks], sums[0]
template <int W = 1, typename T>
__device__ __forceinline__ void last_block_sum(T a, T *partials, int *ticket,
                                               T *sums, T *scratch) {
  const T v[1] = {a};
  last_block_sums_n<W>(v, partials, ticket, sums, scratch);
}

// (a) mod n for -n <= a < 2 n: a neighbour's coordinate on a circular
// axis of n cells, at a shift reduced to |d| < n
__device__ __forceinline__ int wrap_near(int a, int n) {
  return a < 0 ? a + n : (a >= n ? a - n : a);
}

// runs launch() with `device` current, restoring the caller's device
template <typename Launch>
inline int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// Launches a kernel that synchronises its whole grid (cooperative launch):
// as many blocks of `threads` as can be resident at once on the device,
// at most `max_blocks`.  Returns a CUDA error code (0 on success); a
// refused launch is reported, never retried with another shape.
template <typename Kernel>
inline int cooperative_launch(Kernel kernel, int threads, int max_blocks,
                              void **args, cudaStream_t stream,
                              int *grid_out) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void *>(kernel), threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  int grid = per_sm * sms;
  if (grid > max_blocks) grid = max_blocks;
  if (grid < 1) grid = 1;
  if (grid_out) *grid_out = grid;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void *>(kernel),
                                    dim3(grid), dim3(threads), args, 0,
                                    stream);
  return static_cast<int>(err);
}

}  // namespace cp_pfdr
