// One multi-label (simplex) PFDR iteration on a stencil field of K label
// planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/stencil_fused_simplex.py
// (fused_stencil_simplex_iteration, _kernel).  Per cell and label it
// computes the loss gradient (linear, quadratic or smoothed KL, optionally
// weighted by la_f), the forward step fp = 2p - Gamma g, for each of the F
// shift families the d1 pair prox with relaxation on (zu, zv), the weighted
// average back to the vertex (wu zu plus the rolled wv zv), then per cell
// the Michelot projection onto the simplex in the metric ga_proj, and the
// stopping sum: sum_k |p_new - prev| (evolution) or the number of changed
// maximum-likelihood labels (label mode).
//
// Layout.  Vertex fields are [K, H, W] label planes, edge fields
// [F, K, H, W], la_f [1, H, W], prev [K, H, W] or [1, H, W] (label mode):
// thread c reads plane k at k H W + c, so a warp's loads are coalesced.
//
// Design.  One thread per vertex, as stencil_fused.cu: the TPU kernel's
// rolls become index arithmetic, circular on both axes.  The incoming edge
// of family f belongs to the thread of its tail, so this thread recomputes
// that edge's forward values and pair prox itself (the same device
// functions on the same inputs: the zv the tail stores and the one summed
// here agree bit for bit); one launch per iteration, no grid barrier.  The
// projection runs K Michelot passes in registers; the label argmax keeps
// the first maximum on ties, as the TPU kernel.  K is a template parameter
// for 2..8 (arrays in registers) and a runtime value up to kMaxLabels
// otherwise (arrays in local memory).  The stopping sum is reduced
// deterministically: a fixed shuffle tree per block into per-block
// partials, then a one-block launch sums them in a fixed order.  No float
// atomics, so a solve's iteration count does not change between runs.
//
// Bound.  At 140 x 140, F = 2, K = 4 in float32 a launch must move
// 4 V (7K + 1 + 9FK) bytes = 7.9 MB (each input read once, each output
// written once); at 3.35 TB/s that is 2.4 us, against about 0.1 us of
// float32 arithmetic: the stage is bound by bytes, and at this size by
// launch latency in practice.  PERF.md holds its measured time.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kSimplexBlock = 256;
constexpr int kMaxLabels = 32;

template <typename T, int KT>
__global__ void __launch_bounds__(kSimplexBlock)
simplex_stage_kernel(const T *__restrict__ p, const T *__restrict__ q,
                     const T *__restrict__ la_f, const T *__restrict__ ga,
                     const T *__restrict__ ga_proj,
                     const T *__restrict__ prev, const T *__restrict__ zu,
                     const T *__restrict__ zv, const T *__restrict__ wu,
                     const T *__restrict__ wv, const T *__restrict__ w_d1u,
                     const T *__restrict__ w_d1v,
                     const T *__restrict__ th_d1, T *__restrict__ po,
                     T *__restrict__ prevo, T *__restrict__ zuo,
                     T *__restrict__ zvo, T *__restrict__ partials, int h,
                     int w, int k_runtime, Shifts sh, T rho,
                     SimplexLoss<T> ls, int label_mode) {
  constexpr int KA = KT > 0 ? KT : kMaxLabels;
  const int K = KT > 0 ? KT : k_runtime;
  __shared__ T scratch[64];
  const int hw = h * w;
  const int c = blockIdx.x * kSimplexBlock + threadIdx.x;
  T dsum = T(0);
  if (c < hw) {
    const int i = c / w;
    const int j = c - i * w;
    const T laf_c = la_f[c];
    T pc[KA], fpc[KA], acc[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t a = (int64_t)k * hw + c;
      pc[k] = p[a];
      fpc[k] = simplex_forward(pc[k], q[a], laf_c, ga[a], ls);
      acc[k] = T(0);
    }
    for (int f = 0; f < sh.n; ++f) {
      const int dy = sh.dy[f], dx = sh.dx[f];
      // edge owned by this cell: c -> v; edge whose head is this cell: u -> c
      const int v = shifted_cell(i, j, dy, dx, h, w);
      const int u = shifted_cell(i, j, -dy, -dx, h, w);
      const T laf_v = la_f[v], laf_u = la_f[u];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t plane = (int64_t)k * hw;
        const int64_t base = ((int64_t)f * K + k) * hw;
        const int64_t e = base + c;
        const T pv = p[plane + v];
        const T fpv = simplex_forward(pv, q[plane + v], laf_v,
                                      ga[plane + v], ls);
        T zun, zvn;
        pair_prox_relax(fpc[k], fpv, zu[e], zv[e], pc[k], pv, w_d1u[e],
                        w_d1v[e], th_d1[e], rho, zun, zvn);
        zuo[e] = zun;
        zvo[e] = zvn;
        acc[k] = acc[k] + wu[e] * zun;
        const int64_t e2 = base + u;
        const T pu = p[plane + u];
        const T fpu = simplex_forward(pu, q[plane + u], laf_u,
                                      ga[plane + u], ls);
        T zun2, zvn2;
        pair_prox_relax(fpu, fpc[k], zu[e2], zv[e2], pu, pc[k], w_d1u[e2],
                        w_d1v[e2], th_d1[e2], rho, zun2, zvn2);
        acc[k] = acc[k] + wv[e2] * zvn2;
      }
    }
    // Michelot projection onto the simplex in the metric ga_proj
    T m[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) m[k] = ga_proj[(int64_t)k * hw + c];
    const T la = michelot_multiplier<T, KA>(acc, m, K);
    T best = T(0);
    int lab = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T pn = acc[k] - la * m[k];
      pn = pn > T(0) ? pn : T(0);
      const int64_t a = (int64_t)k * hw + c;
      po[a] = pn;
      if (label_mode) {
        if (k == 0 || pn > best) {
          best = pn;
          lab = k;
        }
      } else {
        const T d = fabs(pn - prev[a]);
        dsum = k == 0 ? d : dsum + d;
        prevo[a] = pn;
      }
    }
    if (label_mode) {
      const T lab_t = T(lab);
      dsum = lab_t != prev[c] ? T(1) : T(0);
      prevo[c] = lab_t;
    }
  }
  T unused = T(0);
  block_sum2(dsum, unused, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = dsum;
}

// second pass: one block sums the per-block partials in a fixed order
template <typename T>
__global__ void __launch_bounds__(kSimplexBlock)
simplex_sum_kernel(const T *__restrict__ partials, int nblocks,
                   T *__restrict__ sums) {
  __shared__ T scratch[64];
  T a = T(0), b = T(0);
  for (int k = threadIdx.x; k < nblocks; k += kSimplexBlock) a += partials[k];
  block_sum2(a, b, scratch);
  if (threadIdx.x == 0) sums[0] = a;
}

template <typename T, int KT>
int launch_simplex(dim3 grid, cudaStream_t s, const T *const *in, T *const *out,
                   T *partials, int h, int w, int k, const Shifts &sh, T rho,
                   const SimplexLoss<T> &ls, int label_mode) {
  simplex_stage_kernel<T, KT><<<grid, kSimplexBlock, 0, s>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], in[12], out[0], out[1], out[2], out[3], partials, h, w,
      k, sh, rho, ls, label_mode);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int simplex_stage(const T *const *in, T *const *out, T *partials, T *sums,
                  int h, int w, int k, int f, const int *shifts, double rho,
                  double al, int has_laf, int label_mode, void *stream) {
  Shifts sh;
  if (make_shifts(f, shifts, sh) != 0 || h < 1 || w < 1 || k < 1 ||
      k > kMaxLabels)
    return -1;
  const SimplexLoss<T> ls = make_simplex_loss<T>(al, k, has_laf);
  const int hw = h * w;
  const dim3 grid((hw + kSimplexBlock - 1) / kSimplexBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T r = T(rho);
  int err;
  switch (k) {
    case 2: err = launch_simplex<T, 2>(grid, s, in, out, partials, h, w, k, sh, r, ls, label_mode); break;
    case 3: err = launch_simplex<T, 3>(grid, s, in, out, partials, h, w, k, sh, r, ls, label_mode); break;
    case 4: err = launch_simplex<T, 4>(grid, s, in, out, partials, h, w, k, sh, r, ls, label_mode); break;
    case 5: err = launch_simplex<T, 5>(grid, s, in, out, partials, h, w, k, sh, r, ls, label_mode); break;
    case 6: err = launch_simplex<T, 6>(grid, s, in, out, partials, h, w, k, sh, r, ls, label_mode); break;
    case 7: err = launch_simplex<T, 7>(grid, s, in, out, partials, h, w, k, sh, r, ls, label_mode); break;
    case 8: err = launch_simplex<T, 8>(grid, s, in, out, partials, h, w, k, sh, r, ls, label_mode); break;
    default: err = launch_simplex<T, 0>(grid, s, in, out, partials, h, w, k, sh, r, ls, label_mode); break;
  }
  if (err != 0) return err;
  simplex_sum_kernel<T><<<1, kSimplexBlock, 0, s>>>(partials, grid.x, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

int cp_stencil_simplex_partials_len(int h, int w) {
  return (h * w + cp_pfdr::kSimplexBlock - 1) / cp_pfdr::kSimplexBlock;
}

int cp_stencil_simplex_max_labels() { return cp_pfdr::kMaxLabels; }

#define CP_SIMPLEX_ENTRY(NAME, T)                                            \
  int NAME(const T *p, const T *q, const T *la_f, const T *ga,               \
           const T *ga_proj, const T *prev, const T *zu, const T *zv,        \
           const T *wu, const T *wv, const T *w_d1u, const T *w_d1v,         \
           const T *th_d1, T *po, T *prevo, T *zuo, T *zvo, T *partials,     \
           T *sums, int h, int w, int k, int f, const int *shifts,           \
           double rho, double al, int has_laf, int label_mode,               \
           void *stream) {                                                   \
    const T *in[13] = {p,  q,  la_f, ga,    ga_proj, prev, zu,               \
                       zv, wu, wv,   w_d1u, w_d1v,   th_d1};                 \
    T *out[4] = {po, prevo, zuo, zvo};                                       \
    return cp_pfdr::simplex_stage<T>(in, out, partials, sums, h, w, k, f,    \
                                     shifts, rho, al, has_laf, label_mode,   \
                                     stream);                                \
  }

CP_SIMPLEX_ENTRY(cp_stencil_simplex_f32, float)
CP_SIMPLEX_ENTRY(cp_stencil_simplex_f64, double)

#undef CP_SIMPLEX_ENTRY
}
