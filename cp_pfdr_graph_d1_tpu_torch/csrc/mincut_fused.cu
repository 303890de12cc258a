// A whole certified PDHG min-cut on an [H, W] stencil field, in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/mincut_fused.py
// (fused_pdhg_min_cut, _kernel).  It solves the relaxation
//   min_{x in [0,1]^V} <c, x> + sum_e w_e |x_u - x_v|
// by diagonally preconditioned primal-dual steps (Pock & Chambolle 2011):
//   z_e <- clip(z_e + sigma_e w_e (xb_u - xb_v), -1, 1)
//   x_v <- clip(x_v - tau_v ((K^t z)_v + c_v), 0, 1),  xb <- 2 x_new - x,
// in chunks of `check_every` steps.  After each chunk it evaluates the 15
// super-level-set cuts {x > t} (t = ts[0..14]) and the dual bound
// sum_v min(0, c_v + (K^t z)_v); it stops when the best cut is within `tol`
// of the bound (the duality-gap certificate) or after `it_max` steps.  It
// starts from (x0, z0), returns x, z, the gap, the best threshold and the
// step count, with the iteration semantics of the TPU kernel and of
// maxflow/device.py:_pdhg_min_cut.
//
// Design.  One cooperative launch runs the whole cut: as many blocks as can
// be resident at once, grid-stride loops over the cells, and a grid-wide
// barrier between the dual half-step and the primal half-step (the primal
// step of a cell reads the duals of the edges whose head it is, which
// other threads update) and after each primal half-step.  The adjoint
// K^t z at a cell is sum_f w z[f, c] - w z[f, c - shift_f], read from the
// stored duals.  The certificate's 16 sums (15 cut values and the dual
// bound) are reduced per block by a fixed shuffle tree into per-block
// partials; after a grid barrier every block adds the partials in block
// order, so every block takes the same stopping decision and the result
// does not change between runs (no float atomics).
//
// Bound.  Each PDHG step streams the primal fields (x, xb, c, tau) and the
// dual fields (w, sigma, z) once: about (4 + 4F) values per cell, 21 MB per
// step at 724 x 724 with F = 2 in float32, which the 50 MB L2 holds.  The
// arithmetic is a few operations per value, so a step is bound by memory
// traffic (L2 at this size) and by the two grid barriers per step, not by
// the floating-point rate.  A barrier costs a few microseconds, which is
// what a 140 x 140 field (78 KB per field) pays per step.  PERF.md holds
// the measured times.
#include <cooperative_groups.h>

#include <cstdint>

#include "pfdr_common.cuh"

namespace cg = cooperative_groups;

namespace cp_pfdr {

constexpr int kCutThreads = 256;
constexpr int kThresholds = 15;
constexpr int kCutSums = kThresholds + 1;  // 15 cut values, the dual bound

template <typename T>
struct CutArgs {
  const T *w, *c, *tau, *sigma, *x0, *z0, *ts, *tol;
  T *x, *xb, *z, *partials, *gap_out, *tbest_out;
  int *it_out;
  int h, w_, it_max, check_every;
  Shifts sh;
};

// (K^t z)_c = sum_f w z[f, c] - w z[f, c - shift_f]
template <typename T>
__device__ __forceinline__ T adjoint_at(const CutArgs<T> &a, const T *z,
                                        int c, int i, int j, int hw) {
  T acc = T(0);
  for (int f = 0; f < a.sh.n; ++f) {
    const int64_t e = (int64_t)f * hw + c;
    const int u = shifted_cell(i, j, -a.sh.dy[f], -a.sh.dx[f], a.h, a.w_);
    const int64_t e2 = (int64_t)f * hw + u;
    acc = acc + a.w[e] * z[e] - a.w[e2] * z[e2];
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kCutThreads) mincut_kernel(CutArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T scratch[32 * kCutSums];
  __shared__ T s_tot[kCutSums];
  const int hw = a.h * a.w_;
  const int nf = a.sh.n;
  const int stride = gridDim.x * blockDim.x;
  const int tid0 = blockIdx.x * blockDim.x + threadIdx.x;
  T *x = a.x, *xb = a.xb, *z = a.z;

  for (int c = tid0; c < hw; c += stride) {
    x[c] = a.x0[c];
    xb[c] = a.x0[c];
  }
  for (int64_t e = tid0; e < (int64_t)nf * hw; e += stride) z[e] = a.z0[e];
  grid.sync();

  const T tol = *a.tol;
  int it = 0;
  T gap = T(__int_as_float(0x7f800000));  // +inf
  T t_best = a.ts[0];
  while (it < a.it_max && gap > tol) {
    for (int k = 0; k < a.check_every; ++k) {
      // dual half-step on the edges each cell owns
      for (int c = tid0; c < hw; c += stride) {
        const int i = c / a.w_, j = c - i * a.w_;
        const T xbc = xb[c];
        for (int f = 0; f < nf; ++f) {
          const int v = shifted_cell(i, j, a.sh.dy[f], a.sh.dx[f], a.h, a.w_);
          const int64_t e = (int64_t)f * hw + c;
          T zn = z[e] + (a.sigma[e] * a.w[e]) * (xbc - xb[v]);
          zn = zn < T(-1) ? T(-1) : zn;
          z[e] = zn > T(1) ? T(1) : zn;
        }
      }
      grid.sync();
      // primal half-step and extrapolation
      for (int c = tid0; c < hw; c += stride) {
        const int i = c / a.w_, j = c - i * a.w_;
        const T xc = x[c];
        T xn = xc - a.tau[c] * (adjoint_at(a, z, c, i, j, hw) + a.c[c]);
        xn = xn < T(0) ? T(0) : xn;
        xn = xn > T(1) ? T(1) : xn;
        xb[c] = T(2) * xn - xc;
        x[c] = xn;
      }
      grid.sync();
    }
    // certificate: the 15 threshold cuts and the dual bound
    T v[kCutSums];
#pragma unroll
    for (int t = 0; t < kCutSums; ++t) v[t] = T(0);
    for (int c = tid0; c < hw; c += stride) {
      const int i = c / a.w_, j = c - i * a.w_;
      const T xc = x[c];
      const T cc = a.c[c];
      const T g = cc + adjoint_at(a, z, c, i, j, hw);
      v[kThresholds] += g < T(0) ? g : T(0);
#pragma unroll
      for (int t = 0; t < kThresholds; ++t)
        if (xc > a.ts[t]) v[t] += cc;
      for (int f = 0; f < nf; ++f) {
        const T xv =
            x[shifted_cell(i, j, a.sh.dy[f], a.sh.dx[f], a.h, a.w_)];
        const T we = a.w[(int64_t)f * hw + c];
#pragma unroll
        for (int t = 0; t < kThresholds; ++t)
          if ((xc > a.ts[t]) != (xv > a.ts[t])) v[t] += we;
      }
    }
    T tot;
    block_sum_k<T, kCutSums>(v, scratch, tot);
    if (threadIdx.x < kCutSums)
      a.partials[blockIdx.x * kCutSums + threadIdx.x] = tot;
    grid.sync();
    if (threadIdx.x < kCutSums) {
      T s = T(0);
      for (int b = 0; b < (int)gridDim.x; ++b)
        s += a.partials[b * kCutSums + threadIdx.x];
      s_tot[threadIdx.x] = s;
    }
    __syncthreads();
    T best = s_tot[0];
    int bi = 0;
    for (int t = 1; t < kThresholds; ++t)
      if (s_tot[t] < best) {
        best = s_tot[t];
        bi = t;
      }
    gap = best - s_tot[kThresholds];
    t_best = a.ts[bi];
    it += a.check_every;
    __syncthreads();
  }
  if (tid0 == 0) {
    *a.gap_out = gap;
    *a.tbest_out = t_best;
    *a.it_out = it;
  }
}

template <typename T>
int mincut(const T *w, const T *c, const T *tau, const T *sigma, const T *x0,
           const T *z0, const T *ts, const T *tol, T *x, T *xb, T *z,
           T *partials, int max_blocks, T *gap_out, T *tbest_out, int *it_out,
           int h, int w_, int f, const int *shifts, int it_max,
           int check_every, void *stream) {
  CutArgs<T> a;
  if (make_shifts(f, shifts, a.sh) != 0 || h < 1 || w_ < 1 ||
      check_every < 1 || max_blocks < 1)
    return -1;
  a.w = w;
  a.c = c;
  a.tau = tau;
  a.sigma = sigma;
  a.x0 = x0;
  a.z0 = z0;
  a.ts = ts;
  a.tol = tol;
  a.x = x;
  a.xb = xb;
  a.z = z;
  a.partials = partials;
  a.gap_out = gap_out;
  a.tbest_out = tbest_out;
  a.it_out = it_out;
  a.h = h;
  a.w_ = w_;
  a.it_max = it_max;
  a.check_every = check_every;
  void *args[] = {&a};
  const int need = (h * w_ + kCutThreads - 1) / kCutThreads;
  return cooperative_launch(mincut_kernel<T>, kCutThreads,
                            need < max_blocks ? need : max_blocks, args,
                            static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace cp_pfdr

extern "C" {

int cp_mincut_sums() { return cp_pfdr::kCutSums; }

#define CP_MINCUT_ENTRY(NAME, T)                                              \
  int NAME(const T *w, const T *c, const T *tau, const T *sigma, const T *x0, \
           const T *z0, const T *ts, const T *tol, T *x, T *xb, T *z,         \
           T *partials, int max_blocks, T *gap_out, T *tbest_out,             \
           int *it_out, int h, int w_, int f, const int *shifts, int it_max,  \
           int check_every, void *stream) {                                   \
    return cp_pfdr::mincut<T>(w, c, tau, sigma, x0, z0, ts, tol, x, xb, z,    \
                              partials, max_blocks, gap_out, tbest_out,       \
                              it_out, h, w_, f, shifts, it_max, check_every,  \
                              stream);                                        \
  }

CP_MINCUT_ENTRY(cp_mincut_fused_f32, float)
CP_MINCUT_ENTRY(cp_mincut_fused_f64, double)

#undef CP_MINCUT_ENTRY
}
