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
// Design.  One thread per vertex, in blocks of kVertexBlock threads (154
// blocks on the 140 x 140 field: more than the H100's 132 SMs).  The TPU
// kernel's rolls become index arithmetic, circular on both axes as in
// StencilGraphD1 (a non-wrapping axis carries zero-weight edges, so it
// needs no case of its own).  A vertex receives wv zv from the edge whose
// head it is; that edge belongs to another thread, so the thread recomputes
// the edge's pair prox itself from the same inputs (both threads call the
// same device function on the same values, so the stored zv and the one
// summed agree bit for bit).  That doubles the pair-prox arithmetic but
// needs no second pass and no synchronisation; with the family count known
// at compile time (2 and 4) every load of a thread issues at once.  The two
// sums end in the launch itself: per-block partials, then the last block to
// finish adds them in block order (pfdr_common.cuh:last_block_sums, an int
// ticket; no float atomics, so a solve's iteration count does not change
// between runs).  One launch a stage.  Tiles of 16 x 8 cells staging x and
// p with a halo in shared memory (each pair prox once) were measured
// slower: the stage is latency-bound, and their barriers add latency.
//
// Bound.  At the EEG scale (140 x 140, F = 2: 19.6k vertices, 78 KB per f32
// field) a launch reads and writes about 1.8 MB, all of it resident in the
// 50 MB L2: the stage is bound by the launch, one round of dependent L2
// loads and the last block's sums, not by bytes or arithmetic.  PERF.md
// holds its measured time and its split.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kVertexBlock = 128;

// launch plan of a stencil stage (mirrored by ops/stencil_fused._Plan)
struct StencilPlan {
  void *partials;
  int *ticket;
  int h, w, nf, device;
  int dy[kMaxFamilies], dx[kMaxFamilies];
  double rho, lo, hi;
  int vkind, positivity;
};

template <typename T>
struct StencilStage {
  const T *__restrict__ x, *__restrict__ grad, *__restrict__ ga,
      *__restrict__ th_l1, *__restrict__ zu, *__restrict__ zv,
      *__restrict__ wu, *__restrict__ wv, *__restrict__ w_d1u,
      *__restrict__ w_d1v, *__restrict__ th_d1;
  T *__restrict__ xo, *__restrict__ zuo, *__restrict__ zvo;
  int h, w, nf;
  Shifts sh;
  T rho, lo, hi;
  int vkind, positivity;
};

template <typename T>
__device__ __forceinline__ T forward_at(const StencilStage<T> &a, int c) {
  return forward_value(__ldg(&a.x[c]), __ldg(&a.ga[c]), __ldg(&a.grad[c]));
}

// one edge's stage inputs
template <typename T>
struct EdgeIn {
  T zu, zv, wdu, wdv, th, wu, wv;
};

template <typename T>
__device__ __forceinline__ EdgeIn<T> load_edge(const StencilStage<T> &a,
                                               int64_t e) {
  return {__ldg(&a.zu[e]),    __ldg(&a.zv[e]),    __ldg(&a.w_d1u[e]),
          __ldg(&a.w_d1v[e]), __ldg(&a.th_d1[e]), __ldg(&a.wu[e]),
          __ldg(&a.wv[e])};
}

// a thread a vertex; the pair prox of the edge whose head the vertex is
// recomputed from the same inputs as its owner's.  NF > 0: the family
// count known at compile time (the loop unrolled); NF = 0: a.nf.
template <typename T, int NF>
__global__ void __launch_bounds__(kVertexBlock)
stencil_vertex_kernel(StencilStage<T> a, T *__restrict__ partials,
                      int *__restrict__ ticket, T *__restrict__ sums) {
  __shared__ T scratch[64];
  const int h = a.h, w = a.w, hw = h * w;
  const int c = blockIdx.x * kVertexBlock + threadIdx.x;
  T num = T(0), den = T(0);
  if (c < hw) {
    const int i = c / w;
    const int j = c - i * w;
    const T xc = __ldg(&a.x[c]);
    const T pc = forward_at(a, c);
    T acc = T(0);
#pragma unroll
    for (int f = 0; f < (NF > 0 ? NF : a.nf); ++f) {
      const int dy = a.sh.dy[f], dx = a.sh.dx[f];
      const int v = shifted_cell(i, j, dy, dx, h, w);
      const int64_t e = (int64_t)f * hw + c;
      const EdgeIn<T> in = load_edge(a, e);
      T zun, zvn;
      pair_prox_relax(pc, forward_at(a, v), in.zu, in.zv, xc, __ldg(&a.x[v]),
                      in.wdu, in.wdv, in.th, a.rho, zun, zvn);
      a.zuo[e] = zun;
      a.zvo[e] = zvn;
      acc = acc + in.wu * zun;
      const int u = shifted_cell(i, j, -dy, -dx, h, w);
      const EdgeIn<T> in2 = load_edge(a, (int64_t)f * hw + u);
      pair_prox_relax(forward_at(a, u), pc, in2.zu, in2.zv, __ldg(&a.x[u]),
                      xc, in2.wdu, in2.wdv, in2.th, a.rho, zun, zvn);
      acc = acc + in2.wv * zvn;
    }
    stage_vertex_tail(acc, __ldg(&a.th_l1[c]), xc, a.vkind, a.positivity,
                      a.lo, a.hi, a.xo + c, num, den);
  }
  block_sum2(num, den, scratch);
  last_block_sums(num, den, partials, ticket, sums, scratch);
}

template <typename T, int NF>
cudaError_t launch_stage(const StencilPlan *p, const StencilStage<T> &a,
                         T *partials, T *sums, cudaStream_t s) {
  const int nb = (p->h * p->w + kVertexBlock - 1) / kVertexBlock;
  stencil_vertex_kernel<T, NF>
      <<<nb, kVertexBlock, 0, s>>>(a, partials, p->ticket, sums);
  return cudaGetLastError();
}

template <typename T>
int stencil_stage(const StencilPlan *p, const T *x, const T *grad,
                  const T *ga, const T *th_l1, const T *zu, const T *zv,
                  const T *wu, const T *wv, const T *w_d1u, const T *w_d1v,
                  const T *th_d1, T *xo, T *zo, T *sums, void *stream) {
  if (p->nf < 1 || p->nf > kMaxFamilies || p->h < 1 || p->w < 1) return -1;
  const int64_t ne = (int64_t)p->nf * p->h * p->w;
  StencilStage<T> a = {x,  grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v,
                       th_d1, xo, zo, zo + ne, p->h, p->w, p->nf, {},
                       T(p->rho), T(p->lo), T(p->hi), p->vkind,
                       p->positivity};
  a.sh.n = p->nf;
  for (int k = 0; k < p->nf; ++k) {
    a.sh.dy[k] = p->dy[k];
    a.sh.dx[k] = p->dx[k];
  }
  T *partials = static_cast<T *>(p->partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(p->device, [&] {
    switch (p->nf) {
      case 2:
        return launch_stage<T, 2>(p, a, partials, sums, s);
      case 4:
        return launch_stage<T, 4>(p, a, partials, sums, s);
      default:
        return launch_stage<T, 0>(p, a, partials, sums, s);
    }
  });
}

}  // namespace cp_pfdr

extern "C" {

int cp_stencil_plan_size() { return (int)sizeof(cp_pfdr::StencilPlan); }

// (most families, threads of a block)
void cp_stencil_shape(int *out) {
  out[0] = cp_pfdr::kMaxFamilies;
  out[1] = cp_pfdr::kVertexBlock;
}

#define CP_STENCIL_ENTRY(SUFFIX, T)                                          \
  int cp_stencil_fused_##SUFFIX(                                             \
      const cp_pfdr::StencilPlan *plan, const T *x, const T *grad,           \
      const T *ga, const T *th_l1, const T *zu, const T *zv, const T *wu,    \
      const T *wv, const T *w_d1u, const T *w_d1v, const T *th_d1, T *xo,    \
      T *zo, T *sums, void *stream) {                                        \
    return cp_pfdr::stencil_stage<T>(plan, x, grad, ga, th_l1, zu, zv, wu,   \
                                     wv, w_d1u, w_d1v, th_d1, xo, zo, sums,  \
                                     stream);                                \
  }

CP_STENCIL_ENTRY(f32, float)
CP_STENCIL_ENTRY(f64, double)

#undef CP_STENCIL_ENTRY
}
