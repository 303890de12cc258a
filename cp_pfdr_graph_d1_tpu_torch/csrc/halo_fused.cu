// One quadratic PFDR edge + vertex stage on the local [H, W] row block of a
// vertex-sharded stencil field, split at its two ring exchanges, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/halo_fused.py
// (halo_fused_iteration, _kernel).  That kernel runs the whole stage in one
// pallas_call and moves the hd = max |dy| boundary rows to its ring
// neighbours with in-kernel remote copies (make_async_remote_copy): x and
// p = 2x - Gamma grad out, then the boundary-crossing edges' contributions
// back.  A CUDA kernel cannot copy to another process's card without
// NVSHMEM, so the stage is cut at the two exchange points into launches on
// the caller's stream, and the exchanges run between them on a side stream
// (ops/halo_fused.py):
//
//   (a) halo_strips_kernel writes the x and p strips to send, then
//       halo_interior_kernel runs the pair prox of every edge whose two ends
//       lie in the block and the per-vertex sums of their contributions,
//       while the strips travel;
//   (b) halo_crossing_kernel runs the edges whose head lies in a
//       neighbour's block (their tails here), from the received strips, and
//       writes those edges' head-side contributions into two strips to send
//       back;
//   (c) halo_finish_kernel adds the received contribution strips, applies
//       the vertex prox, and reduces each thread block's sum (x_new - x)^2
//       and sum x_new^2; halo_sum_partials_kernel adds the thread blocks'
//       partials in a fixed order (the caller all-gathers the two sums and
//       adds them in rank order).
//
// Five launches per iteration in all.
//
// Design, as stencil_fused.cu: one thread per vertex; the TPU kernel's rolls
// are index arithmetic, circular along W, and along H read from the
// received strips.  A thread that is an edge's head recomputes the edge's
// pair prox from the same inputs instead of reading it back (the same
// device function on the same values, so the stored zv and the one summed
// agree bit for bit); in (b) the threads of the strip cells do the same for
// the crossing edges whose tails the boundary threads own.  No float
// atomics, and the two sums are reduced in a fixed order.
//
// Bound.  A row block of V_loc cells and F families moves at least
// (5 + 9F) V_loc words (x, grad, Gamma, th_l1 and 7F edge fields read, x and
// 2F edge fields written): at P = 4 on a 2048 x 2048 float32 field
// (V_loc = 1M) 96.5 MB for F = 2, 28.8 us at 3.35 TB/s.  The accumulator
// between (a), (b) and (c) adds 2 V_loc words.  The strips are hd W words
// each (8 KB), so the exchanges are bound by latency, not bytes.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kHaloBlock = 256;

// field value at local row r of the block extended by hd rows each side
// (-hd <= r < h + hd), column j: the block's own rows, the strip received
// from the previous shard above it, or the one from the next shard below
template <typename T>
__device__ __forceinline__ T halo_at(const T *__restrict__ own,
                                     const T *__restrict__ above,
                                     const T *__restrict__ below, int r,
                                     int j, int h, int w, int hd) {
  if (r < 0) return above[(r + hd) * w + j];
  if (r >= h) return below[(r - h) * w + j];
  return own[r * w + j];
}

// (a), first launch: send strips [4, hd, w]: x and p of rows [h - hd, h)
// (to the next shard), then x and p of rows [0, hd) (to the previous one)
template <typename T>
__global__ void __launch_bounds__(kHaloBlock)
halo_strips_kernel(const T *__restrict__ x, const T *__restrict__ grad,
                   const T *__restrict__ ga, T *__restrict__ send, int h,
                   int w, int hd) {
  const int n = hd * w;
  const int t = blockIdx.x * kHaloBlock + threadIdx.x;
  if (t >= 2 * n) return;
  const int half = t / n;
  const int k = t - half * n;
  const int c = half == 0 ? (h - hd) * w + k : k;
  const T xc = x[c];
  send[2 * half * n + k] = xc;
  send[(2 * half + 1) * n + k] = forward_value(xc, ga[c], grad[c]);
}

// (a): the edges with both ends in the block
template <typename T>
__global__ void __launch_bounds__(kHaloBlock)
halo_interior_kernel(const T *__restrict__ x, const T *__restrict__ grad,
                     const T *__restrict__ ga, const T *__restrict__ zu,
                     const T *__restrict__ zv, const T *__restrict__ wu,
                     const T *__restrict__ wv, const T *__restrict__ w_d1u,
                     const T *__restrict__ w_d1v,
                     const T *__restrict__ th_d1, T *__restrict__ zuo,
                     T *__restrict__ zvo, T *__restrict__ acc, int h, int w,
                     Shifts sh, T rho) {
  const int hw = h * w;
  const int c = blockIdx.x * kHaloBlock + threadIdx.x;
  if (c >= hw) return;
  const int i = c / w;
  const int j = c - i * w;
  const T xc = x[c];
  const T pc = forward_value(xc, ga[c], grad[c]);
  T a = T(0);
  for (int f = 0; f < sh.n; ++f) {
    const int dy = sh.dy[f], dx = sh.dx[f];
    const int iv = i + dy;
    if (iv >= 0 && iv < h) {  // edge owned by this cell, head in the block
      const int v = iv * w + wrap_index(j + dx, w);
      const int64_t e = (int64_t)f * hw + c;
      const T xv = x[v];
      const T pv = forward_value(xv, ga[v], grad[v]);
      T zun, zvn;
      pair_prox_relax(pc, pv, zu[e], zv[e], xc, xv, w_d1u[e], w_d1v[e],
                      th_d1[e], rho, zun, zvn);
      zuo[e] = zun;
      zvo[e] = zvn;
      a = a + wu[e] * zun;
    }
    const int iu = i - dy;
    if (iu >= 0 && iu < h) {  // edge whose head is this cell, tail in block
      const int u = iu * w + wrap_index(j - dx, w);
      const int64_t e2 = (int64_t)f * hw + u;
      const T xu = x[u];
      const T pu = forward_value(xu, ga[u], grad[u]);
      T zun2, zvn2;
      pair_prox_relax(pu, pc, zu[e2], zv[e2], xu, xc, w_d1u[e2], w_d1v[e2],
                      th_d1[e2], rho, zun2, zvn2);
      a = a + wv[e2] * zvn2;
    }
  }
  acc[c] = a;
}

// (b): the edges whose head lies in a neighbour's block.  Threads
// [0, tail_rows * w) are the cells of the block's boundary rows (rows
// [0, hd) and [h - hd, h), or every row when 2 hd >= h): each runs the
// crossing edges it owns and adds their tail-side terms to acc.  The next
// 2 hd w threads are the cells of the two contribution strips (the next
// shard's rows [0, hd), then the previous shard's rows [h - hd, h)): each
// recomputes the crossing edges whose head it is and sums their head-side
// terms.  from_prev / from_next are [2, hd, w]: x, then p.
template <typename T>
__global__ void __launch_bounds__(kHaloBlock)
halo_crossing_kernel(const T *__restrict__ x, const T *__restrict__ grad,
                     const T *__restrict__ ga, const T *__restrict__ zu,
                     const T *__restrict__ zv, const T *__restrict__ wu,
                     const T *__restrict__ wv, const T *__restrict__ w_d1u,
                     const T *__restrict__ w_d1v,
                     const T *__restrict__ th_d1,
                     const T *__restrict__ from_prev,
                     const T *__restrict__ from_next, T *__restrict__ zuo,
                     T *__restrict__ zvo, T *__restrict__ acc,
                     T *__restrict__ ctr, int h, int w, int hd,
                     int tail_rows, Shifts sh, T rho) {
  const int hw = h * w;
  const int n = hd * w;
  const T *xa = from_prev, *pa = from_prev + n;
  const T *xb = from_next, *pb = from_next + n;
  int t = blockIdx.x * kHaloBlock + threadIdx.x;
  if (t < tail_rows * w) {
    const int r = t / w;
    const int j = t - r * w;
    const int i = (tail_rows == h || r < hd) ? r : h - 2 * hd + r;
    const int c = i * w + j;
    const T xc = x[c];
    const T pc = forward_value(xc, ga[c], grad[c]);
    T a = acc[c];
    for (int f = 0; f < sh.n; ++f) {
      const int iv = i + sh.dy[f];
      if (iv >= 0 && iv < h) continue;
      const int jv = wrap_index(j + sh.dx[f], w);
      const int64_t e = (int64_t)f * hw + c;
      const T xv = halo_at(x, xa, xb, iv, jv, h, w, hd);
      const T pv = halo_at((const T *)nullptr, pa, pb, iv, jv, h, w, hd);
      T zun, zvn;
      pair_prox_relax(pc, pv, zu[e], zv[e], xc, xv, w_d1u[e], w_d1v[e],
                      th_d1[e], rho, zun, zvn);
      zuo[e] = zun;
      zvo[e] = zvn;
      a = a + wu[e] * zun;
    }
    acc[c] = a;
    return;
  }
  t -= tail_rows * w;
  if (t >= 2 * n) return;
  const int side = t / n;  // 0: strip to the next shard, 1: to the previous
  const int k = t - side * n;
  const int s = k / w;
  const int j = k - s * w;
  const int rv = side == 0 ? h + s : s - hd;  // head row, outside the block
  const T xv = halo_at(x, xa, xb, rv, j, h, w, hd);
  const T pv = halo_at((const T *)nullptr, pa, pb, rv, j, h, w, hd);
  T a = T(0);
  for (int f = 0; f < sh.n; ++f) {
    const int iu = rv - sh.dy[f];
    if (iu < 0 || iu >= h) continue;  // the tail is not in this block
    const int u = iu * w + wrap_index(j - sh.dx[f], w);
    const int64_t e = (int64_t)f * hw + u;
    const T xu = x[u];
    const T pu = forward_value(xu, ga[u], grad[u]);
    T zun, zvn;
    pair_prox_relax(pu, pv, zu[e], zv[e], xu, xv, w_d1u[e], w_d1v[e],
                    th_d1[e], rho, zun, zvn);
    a = a + wv[e] * zvn;
  }
  ctr[side * n + k] = a;
}

// (c): received contributions, vertex prox, per-block partial sums.
// ctr_a is added to rows [0, hd), ctr_b to rows [h - hd, h), in that order.
template <typename T>
__global__ void __launch_bounds__(kHaloBlock)
halo_finish_kernel(const T *__restrict__ acc, const T *__restrict__ ctr_a,
                   const T *__restrict__ ctr_b, const T *__restrict__ x,
                   const T *__restrict__ th_l1, T *__restrict__ xo,
                   T *__restrict__ partials, int h, int w, int hd, int vkind,
                   int positivity, T lo, T hi) {
  __shared__ T scratch[64];
  const int hw = h * w;
  const int c = blockIdx.x * kHaloBlock + threadIdx.x;
  T num = T(0), den = T(0);
  if (c < hw) {
    const int i = c / w;
    T a = acc[c];
    if (i < hd) a = a + ctr_a[c];
    if (i >= h - hd) a = a + ctr_b[c - (h - hd) * w];
    stage_vertex_tail(a, th_l1[c], x[c], vkind, positivity, lo, hi, xo + c,
                      num, den);
  }
  block_sum2(num, den, scratch);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = num;
    partials[2 * blockIdx.x + 1] = den;
  }
}

// one block sums the per-block partials in a fixed order
template <typename T>
__global__ void __launch_bounds__(kHaloBlock)
halo_sum_partials_kernel(const T *__restrict__ partials, int nblocks,
                         T *__restrict__ sums) {
  __shared__ T scratch[64];
  T a = T(0), b = T(0);
  for (int k = threadIdx.x; k < nblocks; k += kHaloBlock) {
    a += partials[2 * k];
    b += partials[2 * k + 1];
  }
  block_sum2(a, b, scratch);
  if (threadIdx.x == 0) {
    sums[0] = a;
    sums[1] = b;
  }
}

inline int grid_for(int64_t threads) {
  return static_cast<int>((threads + kHaloBlock - 1) / kHaloBlock);
}

inline bool halo_ok(int h, int w, int hd) {
  return h >= 1 && w >= 1 && hd >= 1 && hd <= h;
}

template <typename T>
int halo_strips(const T *x, const T *grad, const T *ga, T *send, int h,
                int w, int hd, void *stream) {
  if (!halo_ok(h, w, hd)) return -1;
  halo_strips_kernel<T><<<grid_for(2 * hd * w), kHaloBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, grad, ga, send, h, w, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int halo_interior(const T *x, const T *grad, const T *ga, const T *zu,
                  const T *zv, const T *wu, const T *wv, const T *w_d1u,
                  const T *w_d1v, const T *th_d1, T *zuo, T *zvo, T *acc,
                  int h, int w, int f, const int *shifts, double rho,
                  void *stream) {
  Shifts sh;
  if (make_shifts(f, shifts, sh) != 0 || h < 1 || w < 1) return -1;
  halo_interior_kernel<T><<<grid_for((int64_t)h * w), kHaloBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, grad, ga, zu, zv, wu, wv, w_d1u, w_d1v, th_d1, zuo, zvo, acc, h, w,
      sh, T(rho));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int halo_crossing(const T *x, const T *grad, const T *ga, const T *zu,
                  const T *zv, const T *wu, const T *wv, const T *w_d1u,
                  const T *w_d1v, const T *th_d1, const T *from_prev,
                  const T *from_next, T *zuo, T *zvo, T *acc, T *ctr, int h,
                  int w, int hd, int f, const int *shifts, double rho,
                  void *stream) {
  Shifts sh;
  if (make_shifts(f, shifts, sh) != 0 || !halo_ok(h, w, hd)) return -1;
  const int tail_rows = 2 * hd >= h ? h : 2 * hd;
  halo_crossing_kernel<T><<<grid_for((int64_t)(tail_rows + 2 * hd) * w),
                            kHaloBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, grad, ga, zu, zv, wu, wv, w_d1u, w_d1v, th_d1, from_prev, from_next,
      zuo, zvo, acc, ctr, h, w, hd, tail_rows, sh, T(rho));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int halo_finish(const T *acc, const T *ctr_a, const T *ctr_b, const T *x,
                const T *th_l1, T *xo, T *partials, T *sums, int h, int w,
                int hd, int vkind, int positivity, double lo, double hi,
                void *stream) {
  if (!halo_ok(h, w, hd)) return -1;
  const int nblocks = grid_for((int64_t)h * w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  halo_finish_kernel<T><<<nblocks, kHaloBlock, 0, s>>>(
      acc, ctr_a, ctr_b, x, th_l1, xo, partials, h, w, hd, vkind, positivity,
      T(lo), T(hi));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  halo_sum_partials_kernel<T><<<1, kHaloBlock, 0, s>>>(partials, nblocks,
                                                      sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

int cp_halo_partials_len(int h, int w) {
  return 2 * cp_pfdr::grid_for((int64_t)h * w);
}

#define CP_HALO_ENTRIES(SUFFIX, T)                                           \
  int cp_halo_strips_##SUFFIX(const T *x, const T *grad, const T *ga,        \
                              T *send, int h, int w, int hd, void *stream) { \
    return cp_pfdr::halo_strips<T>(x, grad, ga, send, h, w, hd, stream);     \
  }                                                                          \
  int cp_halo_interior_##SUFFIX(                                             \
      const T *x, const T *grad, const T *ga, const T *zu, const T *zv,      \
      const T *wu, const T *wv, const T *w_d1u, const T *w_d1v,              \
      const T *th_d1, T *zuo, T *zvo, T *acc, int h, int w, int f,           \
      const int *shifts, double rho, void *stream) {                         \
    return cp_pfdr::halo_interior<T>(x, grad, ga, zu, zv, wu, wv, w_d1u,     \
                                     w_d1v, th_d1, zuo, zvo, acc, h, w, f,   \
                                     shifts, rho, stream);                   \
  }                                                                          \
  int cp_halo_crossing_##SUFFIX(                                             \
      const T *x, const T *grad, const T *ga, const T *zu, const T *zv,      \
      const T *wu, const T *wv, const T *w_d1u, const T *w_d1v,              \
      const T *th_d1, const T *from_prev, const T *from_next, T *zuo,        \
      T *zvo, T *acc, T *ctr, int h, int w, int hd, int f,                   \
      const int *shifts, double rho, void *stream) {                         \
    return cp_pfdr::halo_crossing<T>(x, grad, ga, zu, zv, wu, wv, w_d1u,     \
                                     w_d1v, th_d1, from_prev, from_next,     \
                                     zuo, zvo, acc, ctr, h, w, hd, f,        \
                                     shifts, rho, stream);                   \
  }                                                                          \
  int cp_halo_finish_##SUFFIX(const T *acc, const T *ctr_a,                  \
                              const T *ctr_b, const T *x, const T *th_l1,    \
                              T *xo, T *partials, T *sums, int h, int w,     \
                              int hd, int vkind, int positivity, double lo,  \
                              double hi, void *stream) {                     \
    return cp_pfdr::halo_finish<T>(acc, ctr_a, ctr_b, x, th_l1, xo,          \
                                   partials, sums, h, w, hd, vkind,          \
                                   positivity, lo, hi, stream);              \
  }

CP_HALO_ENTRIES(f32, float)
CP_HALO_ENTRIES(f64, double)

#undef CP_HALO_ENTRIES
}
