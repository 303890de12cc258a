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
// [F, K, H, W], la_f [1, H, W], prev [K, H, W] or [1, H, W] (label mode).
//
// Design.  A thread per (cell, label): a block holds `cells` = 32 m
// consecutive cells times the K labels (m = max(1, 8 / K): 64 cells x 4
// labels = 256 threads at K = 4, 307 blocks on the 140 x 140 field; 32 x 32
// = 1024 threads at K = 32), and thread t takes label t / cells of cell
// t mod cells, so a warp reads 32 consecutive cells of one plane.  Each
// thread does its label's F pair proxes: the edge it owns, and the
// incoming edge of the family, whose prox it recomputes from the same
// inputs as the edge's owner (the same device functions on the same values:
// the zv the owner stores and the one summed here agree bit for bit).  The
// K averages of a cell and its K metric values then meet in shared memory
// ([K][cells] each, one barrier), and every thread of the cell computes the
// Michelot multiplier from them in the same order, so all K threads hold
// the same bits; each writes its own label's p_new.  The active set is a
// bit mask, so no K-long array lives in a thread at any K; the passes stop
// once the set repeats (every later pass would repeat the multiplier).
// In label mode the cell's label-0 thread takes the argmax (the first
// maximum on ties) from shared memory the same way.  The stopping sum ends
// in the launch: per-block sums in a fixed shuffle order, then the last
// block to finish adds them in block order (pfdr_common.cuh:last_block_sum;
// no float atomics, so a solve's iteration count does not change between
// runs).
// One launch an iteration.  K is compiled for 2, 3, 4 and 8 and read at
// run time otherwise; F is compiled for 2.  Measured on the H100 and
// dropped (PERF.md, section 6): 32 or 128 cells a block, passing wv zv of the
// horizontal edges to their heads through shared memory instead of the
// recompute, and pfdr_common.cuh's earlier two-sum tail (one partial a
// thread a round).
//
// Bound.  At 140 x 140, F = 2, K = 4 in float32 a launch must move
// 4 V (7K + 1 + 9FK) bytes = 7.9 MB (each input read once, each output
// written once); at 3.35 TB/s that is 2.4 us, against about 0.1 us of
// float32 arithmetic: the stage is bound by bytes, and at this size by
// latency in practice (one wave of blocks, one round of loads, the last
// block's sum).  PERF.md holds its measured time and its split.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kMaxLabels = 32;
constexpr int kMaxSimplexThreads = 1024;

// cells of a block at K labels: 32 m, m = max(1, 8 / K) warps a label
inline int simplex_cells(int k) {
  const int m = 8 / k;
  return 32 * (m > 0 ? m : 1);
}

// launch plan of a multi-label stage (mirrored by
// ops/stencil_fused_simplex._Plan)
struct SimplexPlan {
  void *partials;
  int *ticket;
  int h, w, k, nf, device, has_laf, label_mode;
  int dy[kMaxFamilies], dx[kMaxFamilies];
  double rho, al;
};

template <typename T>
struct SimplexStage {
  const T *__restrict__ p, *__restrict__ q, *__restrict__ la_f,
      *__restrict__ ga, *__restrict__ ga_proj, *__restrict__ prev,
      *__restrict__ zu, *__restrict__ zv, *__restrict__ wu,
      *__restrict__ wv, *__restrict__ w_d1u, *__restrict__ w_d1v,
      *__restrict__ th_d1;
  T *__restrict__ po, *__restrict__ prevo, *__restrict__ zuo,
      *__restrict__ zvo;
  int h, w, k, cells, label_mode;
  Shifts sh;
  T rho;
  SimplexLoss<T> ls;
};

template <typename T>
__device__ __forceinline__ T forward_at(const SimplexStage<T> &a,
                                        int64_t at, int cell) {
  const T laf = a.ls.has_laf ? __ldg(&a.la_f[cell]) : T(0);
  return simplex_forward(__ldg(&a.p[at]), __ldg(&a.q[at]), laf,
                         __ldg(&a.ga[at]), a.ls);
}

// the residual acc - la m of one label, the one expression both the
// projection and the active-set test use
template <typename T>
__device__ __forceinline__ T residual(T acc, T la, T m) {
  return acc - la * m;
}

// Michelot multiplier of one cell from its K averages ac[j cells] and
// metric values mc[j cells] in shared memory: the passes of
// pfdr_common.cuh:michelot_multiplier, the active set a bit mask
template <typename T, int KT>
__device__ __forceinline__ T cell_multiplier(const T *ac, const T *mc,
                                             int K, int cells) {
  unsigned act = K == 32 ? 0xffffffffu : (1u << K) - 1u;
  T la = T(0);
  for (int pass = 0; pass < K; ++pass) {
    T sx = (act & 1u) ? ac[0] : T(0);
    T sm = (act & 1u) ? mc[0] : T(0);
#pragma unroll
    for (int j = 1; j < (KT > 0 ? KT : K); ++j) {
      const bool on = (act >> j) & 1u;
      sx = sx + (on ? ac[j * cells] : T(0));
      sm = sm + (on ? mc[j * cells] : T(0));
    }
    la = (sx - T(1)) / (sm > T(0) ? sm : T(1));
    unsigned next = 0u;
#pragma unroll
    for (int j = 0; j < (KT > 0 ? KT : K); ++j)
      if (((act >> j) & 1u) && residual(ac[j * cells], la, mc[j * cells]) >
                                   T(0))
        next |= 1u << j;
    if (next == act) break;
    act = next;
  }
  return la;
}

// a thread per (cell, label); KT > 0 / NF > 0: K / F known at compile time
// (a compiled K takes at most 256 threads a block)
template <typename T, int KT, int NF>
__global__ void __launch_bounds__(KT > 0 ? 256 : kMaxSimplexThreads)
simplex_stage_kernel(SimplexStage<T> a, T *__restrict__ partials,
                     int *__restrict__ ticket, T *__restrict__ sums) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T scratch[64];
  const int K = KT > 0 ? KT : a.k;
  const int cells = a.cells;
  T *s_acc = reinterpret_cast<T *>(smem_raw);  // [K][cells]
  T *s_m = s_acc + K * cells;                  // [K][cells]
  const int hw = a.h * a.w;
  const int lab = threadIdx.x / cells;
  const int l = threadIdx.x - lab * cells;
  const int c = blockIdx.x * cells + l;
  const bool live = c < hw;
  const int64_t plane = (int64_t)lab * hw;
  T acc = T(0), m = T(0), prev = T(0);
  if (live) {
    const int i = c / a.w;
    const int j = c - i * a.w;
    const T pc = __ldg(&a.p[plane + c]);
    const T fpc = forward_at(a, plane + c, c);
    m = __ldg(&a.ga_proj[plane + c]);
    if (!a.label_mode)
      prev = __ldg(&a.prev[plane + c]);
    else if (lab == 0)
      prev = __ldg(&a.prev[c]);
#pragma unroll
    for (int f = 0; f < (NF > 0 ? NF : a.sh.n); ++f) {
      const int dy = a.sh.dy[f], dx = a.sh.dx[f];
      // edge owned by this cell: c -> v; edge whose head is this cell: u -> c
      const int v = wrap_near(i + dy, a.h) * a.w + wrap_near(j + dx, a.w);
      const int u = wrap_near(i - dy, a.h) * a.w + wrap_near(j - dx, a.w);
      const int64_t base = ((int64_t)f * K + lab) * hw;
      const int64_t e = base + c;
      const T pv = __ldg(&a.p[plane + v]);
      T zun, zvn;
      pair_prox_relax(fpc, forward_at(a, plane + v, v), __ldg(&a.zu[e]),
                      __ldg(&a.zv[e]), pc, pv, __ldg(&a.w_d1u[e]),
                      __ldg(&a.w_d1v[e]), __ldg(&a.th_d1[e]), a.rho, zun,
                      zvn);
      a.zuo[e] = zun;
      a.zvo[e] = zvn;
      acc = acc + __ldg(&a.wu[e]) * zun;
      const int64_t e2 = base + u;
      pair_prox_relax(forward_at(a, plane + u, u), fpc, __ldg(&a.zu[e2]),
                      __ldg(&a.zv[e2]), __ldg(&a.p[plane + u]), pc,
                      __ldg(&a.w_d1u[e2]), __ldg(&a.w_d1v[e2]),
                      __ldg(&a.th_d1[e2]), a.rho, zun, zvn);
      acc = acc + __ldg(&a.wv[e2]) * zvn;
    }
    s_acc[lab * cells + l] = acc;
    s_m[lab * cells + l] = m;
  }
  __syncthreads();
  T d = T(0);
  if (live) {
    const T la = cell_multiplier<T, KT>(s_acc + l, s_m + l, K, cells);
    T pn = residual(acc, la, m);
    pn = pn > T(0) ? pn : T(0);
    a.po[plane + c] = pn;
    if (!a.label_mode) {
      d = fabs(pn - prev);
      a.prevo[plane + c] = pn;
    } else if (lab == 0) {
      T best = T(0);
      int arg = 0;
      for (int k = 0; k < K; ++k) {
        T pk = residual(s_acc[k * cells + l], la, s_m[k * cells + l]);
        pk = pk > T(0) ? pk : T(0);
        if (k == 0 || pk > best) {
          best = pk;
          arg = k;
        }
      }
      const T arg_t = T(arg);
      d = arg_t != prev ? T(1) : T(0);
      a.prevo[c] = arg_t;
    }
  }
  T unused = T(0);
  block_sum2(d, unused, scratch);
  last_block_sum<4>(d, partials, ticket, sums, scratch);
}

template <typename T, int KT, int NF>
cudaError_t launch_simplex(const SimplexStage<T> &a, int blocks,
                           T *partials, int *ticket, T *sums,
                           cudaStream_t s) {
  const int threads = a.k * a.cells;
  const size_t smem = 2 * sizeof(T) * threads;
  simplex_stage_kernel<T, KT, NF>
      <<<blocks, threads, smem, s>>>(a, partials, ticket, sums);
  return cudaGetLastError();
}

template <typename T, int NF>
cudaError_t launch_k(const SimplexStage<T> &a, int blocks, T *partials,
                     int *ticket, T *sums, cudaStream_t s) {
  switch (a.k) {
    case 2: return launch_simplex<T, 2, NF>(a, blocks, partials, ticket, sums, s);
    case 3: return launch_simplex<T, 3, NF>(a, blocks, partials, ticket, sums, s);
    case 4: return launch_simplex<T, 4, NF>(a, blocks, partials, ticket, sums, s);
    case 8: return launch_simplex<T, 8, NF>(a, blocks, partials, ticket, sums, s);
    default: return launch_simplex<T, 0, NF>(a, blocks, partials, ticket, sums, s);
  }
}

template <typename T>
int simplex_stage(const SimplexPlan *p, const T *const *in, T *po, T *prevo,
                  T *zo, T *sums, void *stream) {
  if (p->nf < 1 || p->nf > kMaxFamilies || p->h < 1 || p->w < 1 ||
      p->k < 1 || p->k > kMaxLabels)
    return -1;
  const int hw = p->h * p->w;
  SimplexStage<T> a;
  a.p = in[0];
  a.q = in[1];
  a.la_f = in[2];
  a.ga = in[3];
  a.ga_proj = in[4];
  a.prev = in[5];
  a.zu = in[6];
  a.zv = in[7];
  a.wu = in[8];
  a.wv = in[9];
  a.w_d1u = in[10];
  a.w_d1v = in[11];
  a.th_d1 = in[12];
  a.po = po;
  a.prevo = prevo;
  a.zuo = zo;
  a.zvo = zo + (int64_t)p->nf * p->k * hw;
  a.h = p->h;
  a.w = p->w;
  a.k = p->k;
  a.cells = simplex_cells(p->k);
  a.label_mode = p->label_mode;
  a.sh.n = p->nf;
  for (int f = 0; f < p->nf; ++f) {
    // |dy| < h and |dx| < w (the wrapper reduces the shifts), so one add
    // or subtract wraps a neighbour's coordinate
    if (abs(p->dy[f]) >= p->h || abs(p->dx[f]) >= p->w) return -1;
    a.sh.dy[f] = p->dy[f];
    a.sh.dx[f] = p->dx[f];
  }
  a.rho = T(p->rho);
  a.ls = make_simplex_loss<T>(p->al, p->k, p->has_laf);
  const int blocks = (hw + a.cells - 1) / a.cells;
  T *partials = static_cast<T *>(p->partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(p->device, [&] {
    return p->nf == 2 ? launch_k<T, 2>(a, blocks, partials, p->ticket, sums, s)
                      : launch_k<T, 0>(a, blocks, partials, p->ticket, sums, s);
  });
}

}  // namespace cp_pfdr

extern "C" {

int cp_stencil_simplex_plan_size() {
  return (int)sizeof(cp_pfdr::SimplexPlan);
}

// (most labels, most families, cells of a block, threads of a block,
// blocks) of a launch on an h x w field of k labels
void cp_stencil_simplex_shape(int h, int w, int k, int *out) {
  const int cells = cp_pfdr::simplex_cells(k);
  out[0] = cp_pfdr::kMaxLabels;
  out[1] = cp_pfdr::kMaxFamilies;
  out[2] = cells;
  out[3] = k * cells;
  out[4] = (h * w + cells - 1) / cells;
}

#define CP_SIMPLEX_ENTRY(SUFFIX, T)                                          \
  int cp_stencil_simplex_##SUFFIX(                                           \
      const cp_pfdr::SimplexPlan *plan, const T *p, const T *q,              \
      const T *la_f, const T *ga, const T *ga_proj, const T *prev,           \
      const T *zu, const T *zv, const T *wu, const T *wv, const T *w_d1u,    \
      const T *w_d1v, const T *th_d1, T *po, T *prevo, T *zo, T *sums,       \
      void *stream) {                                                        \
    const T *in[13] = {p,  q,  la_f, ga,    ga_proj, prev, zu,               \
                       zv, wu, wv,   w_d1u, w_d1v,   th_d1};                 \
    return cp_pfdr::simplex_stage<T>(plan, in, po, prevo, zo, sums, stream); \
  }

CP_SIMPLEX_ENTRY(f32, float)
CP_SIMPLEX_ENTRY(f64, double)

#undef CP_SIMPLEX_ENTRY
}
