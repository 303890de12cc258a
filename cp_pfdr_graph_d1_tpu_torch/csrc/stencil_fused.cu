// One quadratic PFDR edge + vertex stage on an [H, W] stencil field, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/stencil_fused.py
// (fused_stencil_iteration, _kernel).  Per cell it computes the forward
// step p = 2x - Gamma grad, for each of the F shift families the d1 pair
// prox with relaxation on (zu, zv), the weighted average back to the
// vertices (wu zu plus the rolled wv zv), the vertex prox, and the sums
// sum (x_new - x)^2 and sum x_new^2.
//
// Design.  One thread per vertex.  The TPU kernel's rolls become index
// arithmetic, circular on both axes as in StencilGraphD1 (a non-wrapping
// axis carries zero-weight edges, so it needs no case of its own).  A vertex
// receives wv zv from the edge whose head it is; that edge belongs to
// another thread, so the thread recomputes the edge's pair prox itself from
// the same inputs (both threads call the same device function on the same
// values, so the stored zv and the one summed agree bit for bit).  That
// doubles the pair-prox arithmetic but needs no second pass and no grid
// synchronisation.  The two sums are reduced deterministically: a fixed
// shuffle tree per block into per-block partials, then a second one-block
// launch sums the partials in a fixed order.  No float atomics, so the
// iteration count of a solve does not change between runs.
//
// Bound.  At the EEG scale (140 x 140, F = 2: 19.6k vertices, 78 KB per f32
// field) a launch reads and writes about 1.8 MB, all of it resident in the
// 50 MB L2: the stage is bound by launch latency, not by bytes or
// arithmetic, and fusing it into one kernel is what pays.  PERF.md holds
// its measured time beside the plain version's.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kStencilBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kStencilBlock)
stencil_stage_kernel(const T *__restrict__ x, const T *__restrict__ grad,
                     const T *__restrict__ ga, const T *__restrict__ th_l1,
                     const T *__restrict__ zu, const T *__restrict__ zv,
                     const T *__restrict__ wu, const T *__restrict__ wv,
                     const T *__restrict__ w_d1u, const T *__restrict__ w_d1v,
                     const T *__restrict__ th_d1, T *__restrict__ xo,
                     T *__restrict__ zuo, T *__restrict__ zvo,
                     T *__restrict__ partials, int h, int w, Shifts sh,
                     T rho, int vkind, int positivity, T lo, T hi) {
  __shared__ T scratch[64];
  const int hw = h * w;
  const int c = blockIdx.x * kStencilBlock + threadIdx.x;
  T num = T(0), den = T(0);
  if (c < hw) {
    const int i = c / w;
    const int j = c - i * w;
    const T xc = x[c];
    const T pc = forward_value(xc, ga[c], grad[c]);
    T acc = T(0);
    for (int f = 0; f < sh.n; ++f) {
      const int dy = sh.dy[f], dx = sh.dx[f];
      // edge owned by this cell: c -> (i + dy, j + dx)
      const int v = wrap_index(i + dy, h) * w + wrap_index(j + dx, w);
      const int64_t e = (int64_t)f * hw + c;
      const T xv = x[v];
      const T pv = forward_value(xv, ga[v], grad[v]);
      T zun, zvn;
      pair_prox_relax(pc, pv, zu[e], zv[e], xc, xv, w_d1u[e], w_d1v[e],
                      th_d1[e], rho, zun, zvn);
      zuo[e] = zun;
      zvo[e] = zvn;
      acc = acc + wu[e] * zun;
      // edge whose head is this cell: (i - dy, j - dx) -> c
      const int u = wrap_index(i - dy, h) * w + wrap_index(j - dx, w);
      const int64_t e2 = (int64_t)f * hw + u;
      const T xu = x[u];
      const T pu = forward_value(xu, ga[u], grad[u]);
      T zun2, zvn2;
      pair_prox_relax(pu, pc, zu[e2], zv[e2], xu, xc, w_d1u[e2], w_d1v[e2],
                      th_d1[e2], rho, zun2, zvn2);
      acc = acc + wv[e2] * zvn2;
    }
    const T xn = vertex_prox(acc, th_l1[c], vkind, positivity, lo, hi);
    xo[c] = xn;
    const T d = xn - xc;
    num = d * d;
    den = xn * xn;
  }
  block_sum2(num, den, scratch);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = num;
    partials[2 * blockIdx.x + 1] = den;
  }
}

// second pass: one block sums the per-block partials in a fixed order
template <typename T>
__global__ void __launch_bounds__(kStencilBlock)
sum_partials_kernel(const T *__restrict__ partials, int nblocks,
                    T *__restrict__ sums) {
  __shared__ T scratch[64];
  T a = T(0), b = T(0);
  for (int k = threadIdx.x; k < nblocks; k += kStencilBlock) {
    a += partials[2 * k];
    b += partials[2 * k + 1];
  }
  block_sum2(a, b, scratch);
  if (threadIdx.x == 0) {
    sums[0] = a;
    sums[1] = b;
  }
}

template <typename T>
int stencil_stage(const T *x, const T *grad, const T *ga, const T *th_l1,
                  const T *zu, const T *zv, const T *wu, const T *wv,
                  const T *w_d1u, const T *w_d1v, const T *th_d1, T *xo,
                  T *zuo, T *zvo, T *partials, T *sums, int h, int w, int f,
                  const int *shifts, double rho, int vkind, int positivity,
                  double lo, double hi, void *stream) {
  Shifts sh;
  if (make_shifts(f, shifts, sh) != 0 || h < 1 || w < 1) return -1;
  const int hw = h * w;
  const int nblocks = (hw + kStencilBlock - 1) / kStencilBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stencil_stage_kernel<T><<<nblocks, kStencilBlock, 0, s>>>(
      x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v, th_d1, xo, zuo, zvo,
      partials, h, w, sh, T(rho), vkind, positivity, T(lo), T(hi));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<T><<<1, kStencilBlock, 0, s>>>(partials, nblocks, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

int cp_stencil_partials_len(int h, int w) {
  return 2 * ((h * w + cp_pfdr::kStencilBlock - 1) / cp_pfdr::kStencilBlock);
}

int cp_stencil_max_families() { return cp_pfdr::kMaxFamilies; }

#define CP_STENCIL_ENTRY(NAME, T)                                            \
  int NAME(const T *x, const T *grad, const T *ga, const T *th_l1,           \
           const T *zu, const T *zv, const T *wu, const T *wv,               \
           const T *w_d1u, const T *w_d1v, const T *th_d1, T *xo, T *zuo,    \
           T *zvo, T *partials, T *sums, int h, int w, int f,                \
           const int *shifts, double rho, int vkind, int positivity,         \
           double lo, double hi, void *stream) {                             \
    return cp_pfdr::stencil_stage<T>(x, grad, ga, th_l1, zu, zv, wu, wv,     \
                                     w_d1u, w_d1v, th_d1, xo, zuo, zvo,      \
                                     partials, sums, h, w, f, shifts, rho,   \
                                     vkind, positivity, lo, hi, stream);     \
  }

CP_STENCIL_ENTRY(cp_stencil_fused_f32, float)
CP_STENCIL_ENTRY(cp_stencil_fused_f64, double)

#undef CP_STENCIL_ENTRY
}
