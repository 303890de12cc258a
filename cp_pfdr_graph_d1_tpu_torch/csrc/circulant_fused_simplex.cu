// One multi-label (simplex) PFDR iteration on a graph decomposed into offset
// families plus a remainder (CirculantGraphD1), over K label planes, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// cp_pfdr_graph_d1_tpu/ops/circulant_fused_simplex.py
// (fused_circulant_simplex_iteration, _kernel).  Per vertex and label it
// computes the loss gradient (linear, quadratic or smoothed KL, optionally
// weighted by la_f), the forward step fp = 2p - Gamma g, the d1 pair prox
// with relaxation of every incident (slot, label), the weighted average
// back to the vertex, then per vertex the Michelot projection onto the
// simplex in the metric ga_proj and the stopping sum: sum_k |p_new - prev|
// (evolution) or the number of changed maximum-likelihood labels (label
// mode).
//
// Layout.  Vertex fields are [K, V] label planes (la_f [V], prev [K, V] or
// [1, V] in label mode); edge fields are [K, E] planes over the container's
// edge order (family slot (f, u) at e = f VV + u, then the remainder), so
// thread u reads plane k of a family at k E + f VV + u and a warp's loads
// are coalesced.
//
// Design.  Kernel 9's scheme (circulant_fused.cu) over K planes: one thread
// owns padded vertex u, meets slot (f, u) as its tail and slot
// (f, (u - d_f) mod VV) as its head for every family, then its remainder
// edges through the remainder's incidence list, and sums in that fixed
// order.  The TPU kernel computes the forward field once into scratch;
// here each thread recomputes the forward values it needs (its own and its
// neighbours') with the same device function on the same inputs, so the
// tail's stored z and the head's summed z agree bit for bit and one launch
// per iteration needs no grid barrier.  As in kernel 9, a vertex whose
// remainder row holds more than kLongRow slots (the endpoints of the
// remainder's padding edges) leaves its K family sums in a scratch plane
// and a second launch gives it a block: contiguous runs of the row, a
// fixed shuffle tree per label, then the projection.  Reads at a padded
// position u >= V give 0, the zero padding of the TPU layout; padded
// threads write their family slots and nothing else.  wv and w_d1v are
// read from the preconditioner (the TPU kernel derives them from wu, w_d1u
// and the Gamma ratio, with safe ratios where Gamma is 0); so no ratio is
// taken here.  K is a template parameter for 2..8 (arrays in registers)
// and a runtime value up to kMaxSimplexLabels otherwise (local memory).
// The argmax keeps the first maximum, as the TPU kernel.  The stopping sum
// goes through per-block partials and a fixed-order last launch: no float
// atomics, so a solve's iteration count does not change between runs.
//
// Bound.  Bytes: the function needs 7 family planes of K F VV slots (zu,
// zv, wu, w_d1u, th_d1 read, zu, zv written; wv and w_d1v follow from them
// and Gamma), the remainder's, and 7 K + 1 vertex planes.  At the mesh
// scale (F = 64, VV = 20,480, K = 4, float32) that is about 148 MB, or
// 44 us at 3.35 TB/s, against about 2.5 us of float32 arithmetic: the
// stage is bound by bytes.  This kernel moves 9 planes (about 191 MB,
// 57 us): reading wv and w_d1v costs 2/9 of its bytes.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kCircSimplexBlock = 256;
constexpr int kMaxSimplexLabels = 32;

template <typename T>
struct SimplexStage {
  const T *p, *q, *la_f, *ga, *ga_proj, *prev;
  const T *zu, *zv, *wu, *wv, *w_d1u, *w_d1v, *th_d1;
  const int *offs;                        // family offsets d_f
  const int *reu, *rev, *roff, *rslots;   // remainder edges and their CSR
  T *po, *prevo, *zuo, *zvo;
  T *acc_part;  // [K, V] family sums of the vertices of long remainder rows
  int nv, vv, nf, ner;
  int64_t ne;   // edges in all: F VV + ner
  T rho;
  int label_mode;
  SimplexLoss<T> ls;
};

// label value and forward value of vertex i in plane k (0 beyond V)
template <typename T>
__device__ __forceinline__ void plane_values(const SimplexStage<T> &a, int k,
                                             int i, T &pv, T &fpv) {
  if (i < a.nv) {
    const int64_t c = (int64_t)k * a.nv + i;
    pv = a.p[c];
    fpv = simplex_forward(pv, a.q[c], a.la_f[i], a.ga[c], a.ls);
  } else {
    pv = T(0);
    fpv = T(0);
  }
}

// contribution of remainder edge r (u -> w) to label k's average at one of
// its endpoints (the tail when `tail`); the tail's thread writes zu and zv
template <typename T>
__device__ __forceinline__ T remainder_term(const SimplexStage<T> &a, int r,
                                            bool tail, int u, int w, int k) {
  const int64_t e = (int64_t)k * a.ne + (int64_t)a.nf * a.vv + r;
  T pu, fpu, pw, fpw;
  plane_values(a, k, u, pu, fpu);
  plane_values(a, k, w, pw, fpw);
  T zun, zvn;
  pair_prox_relax(fpu, fpw, a.zu[e], a.zv[e], pu, pw, a.w_d1u[e], a.w_d1v[e],
                  a.th_d1[e], a.rho, zun, zvn);
  if (tail) {
    a.zuo[e] = zun;
    a.zvo[e] = zvn;
    return a.wu[e] * zun;
  }
  return a.wv[e] * zvn;
}

// adds remainder slot `slot`'s terms of every label to acc
template <typename T, int KA>
__device__ __forceinline__ void add_remainder_slot(const SimplexStage<T> &a,
                                                   int slot, T (&acc)[KA],
                                                   int K) {
  const bool tail = slot < a.ner;
  const int r = tail ? slot : slot - a.ner;
  const int u = a.reu[r], w = a.rev[r];
#pragma unroll
  for (int k = 0; k < K; ++k)
    acc[k] = acc[k] + remainder_term(a, r, tail, u, w, k);
}

// end of the iteration at real vertex u from its averages acc: the Michelot
// projection in the metric ga_proj, p_new and prev_new written; returns the
// vertex's stopping term
template <typename T, int KA>
__device__ __forceinline__ T vertex_tail(const SimplexStage<T> &a, int u,
                                         const T (&acc)[KA], int K) {
  T m[KA];
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = a.ga_proj[(int64_t)k * a.nv + u];
  const T la = michelot_multiplier<T, KA>(acc, m, K);
  T best = T(0), dsum = T(0);
  int lab = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T pn = acc[k] - la * m[k];
    pn = pn > T(0) ? pn : T(0);
    const int64_t c = (int64_t)k * a.nv + u;
    a.po[c] = pn;
    if (a.label_mode) {
      if (k == 0 || pn > best) {
        best = pn;
        lab = k;
      }
    } else {
      const T dd = fabs(pn - a.prev[c]);
      dsum = k == 0 ? dd : dsum + dd;
      a.prevo[c] = pn;
    }
  }
  if (a.label_mode) {
    const T lab_t = T(lab);
    dsum = lab_t != a.prev[u] ? T(1) : T(0);
    a.prevo[u] = lab_t;
  }
  return dsum;
}

// one thread per padded vertex: families, then the remainder rows of at
// most kLongRow slots
template <typename T, int KT>
__global__ void __launch_bounds__(kCircSimplexBlock)
circulant_simplex_kernel(SimplexStage<T> a, T *__restrict__ partials,
                         int k_runtime) {
  constexpr int KA = KT > 0 ? KT : kMaxSimplexLabels;
  const int K = KT > 0 ? KT : k_runtime;
  __shared__ T scratch[64];
  const int u = blockIdx.x * kCircSimplexBlock + threadIdx.x;
  const bool real = u < a.nv;
  T dsum = T(0);
  if (u < a.vv) {
    T pc[KA], fpc[KA], acc[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      plane_values(a, k, u, pc[k], fpc[k]);
      acc[k] = T(0);
    }
    for (int f = 0; f < a.nf; ++f) {
      const int d = a.offs[f];
      int w = u + d;
      if (w >= a.vv) w -= a.vv;
      int t = u - d;
      if (t < 0) t += a.vv;
      const int64_t base = (int64_t)f * a.vv;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t e = (int64_t)k * a.ne + base + u;
        T pw, fpw;
        plane_values(a, k, w, pw, fpw);
        T zun, zvn;
        pair_prox_relax(fpc[k], fpw, a.zu[e], a.zv[e], pc[k], pw, a.w_d1u[e],
                        a.w_d1v[e], a.th_d1[e], a.rho, zun, zvn);
        a.zuo[e] = zun;
        a.zvo[e] = zvn;
        if (real) {
          acc[k] = acc[k] + a.wu[e] * zun;
          const int64_t e2 = (int64_t)k * a.ne + base + t;
          T pt, fpt;
          plane_values(a, k, t, pt, fpt);
          T zun2, zvn2;
          pair_prox_relax(fpt, fpc[k], a.zu[e2], a.zv[e2], pt, pc[k],
                          a.w_d1u[e2], a.w_d1v[e2], a.th_d1[e2], a.rho, zun2,
                          zvn2);
          acc[k] = acc[k] + a.wv[e2] * zvn2;
        }
      }
    }
    if (real) {
      const int beg = a.ner > 0 ? a.roff[u] : 0;
      const int end = a.ner > 0 ? a.roff[u + 1] : 0;
      if (end - beg > kLongRow) {
        // the long-row launch ends this vertex
#pragma unroll
        for (int k = 0; k < K; ++k) a.acc_part[(int64_t)k * a.nv + u] = acc[k];
      } else {
        for (int s = beg; s < end; ++s)
          add_remainder_slot<T, KA>(a, a.rslots[s], acc, K);
        dsum = vertex_tail<T, KA>(a, u, acc, K);
      }
    }
  }
  T unused = T(0);
  block_sum2(dsum, unused, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = dsum;
}

// one block per vertex whose remainder row holds more than kLongRow slots:
// contiguous runs, a fixed shuffle tree per pair of labels, then the
// projection; its stopping term goes to partials[first + i]
template <typename T, int KT>
__global__ void __launch_bounds__(kCircSimplexBlock)
circulant_simplex_long_kernel(SimplexStage<T> a,
                              const int *__restrict__ long_rows,
                              T *__restrict__ partials, int first,
                              int k_runtime) {
  constexpr int KA = KT > 0 ? KT : kMaxSimplexLabels;
  const int K = KT > 0 ? KT : k_runtime;
  __shared__ T scratch[64];
  const int u = long_rows[blockIdx.x];
  T acc[KA];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  int lo, hi;
  long_row_run(a.roff[u], a.roff[u + 1], lo, hi);
  for (int s = lo; s < hi; ++s)
    add_remainder_slot<T, KA>(a, a.rslots[s], acc, K);
  for (int k = 0; k < K; k += 2) {
    T b = k + 1 < K ? acc[k + 1] : T(0);
    block_sum2(acc[k], b, scratch);
    if (k + 1 < K) acc[k + 1] = b;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      acc[k] = a.acc_part[(int64_t)k * a.nv + u] + acc[k];
    partials[first + blockIdx.x] = vertex_tail<T, KA>(a, u, acc, K);
  }
}

// last pass: one block adds the partials in a fixed order
template <typename T>
__global__ void __launch_bounds__(kCircSimplexBlock)
circulant_simplex_sum_kernel(const T *__restrict__ partials, int nparts,
                             T *__restrict__ sums) {
  __shared__ T scratch[64];
  T a = T(0), b = T(0);
  for (int k = threadIdx.x; k < nparts; k += kCircSimplexBlock)
    a += partials[k];
  block_sum2(a, b, scratch);
  if (threadIdx.x == 0) sums[0] = a;
}

template <typename T, int KT>
int launch_circ_simplex(const SimplexStage<T> &a, const int *long_rows,
                        int n_long, T *partials, int nblocks, int k,
                        cudaStream_t s) {
  circulant_simplex_kernel<T, KT><<<nblocks, kCircSimplexBlock, 0, s>>>(
      a, partials, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_long == 0) return static_cast<int>(err);
  circulant_simplex_long_kernel<T, KT><<<n_long, kCircSimplexBlock, 0, s>>>(
      a, long_rows, partials, nblocks, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int circulant_simplex(const SimplexStage<T> &a, const int *long_rows,
                      int n_long, int k, T *partials, T *sums, void *stream) {
  if (a.nv < 1 || a.vv < a.nv || a.nf < 1 || a.ner < 0 || n_long < 0 ||
      k < 1 || k > kMaxSimplexLabels)
    return -1;
  const int nblocks = (a.vv + kCircSimplexBlock - 1) / kCircSimplexBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (k) {
    case 2: err = launch_circ_simplex<T, 2>(a, long_rows, n_long, partials, nblocks, k, s); break;
    case 3: err = launch_circ_simplex<T, 3>(a, long_rows, n_long, partials, nblocks, k, s); break;
    case 4: err = launch_circ_simplex<T, 4>(a, long_rows, n_long, partials, nblocks, k, s); break;
    case 5: err = launch_circ_simplex<T, 5>(a, long_rows, n_long, partials, nblocks, k, s); break;
    case 6: err = launch_circ_simplex<T, 6>(a, long_rows, n_long, partials, nblocks, k, s); break;
    case 7: err = launch_circ_simplex<T, 7>(a, long_rows, n_long, partials, nblocks, k, s); break;
    case 8: err = launch_circ_simplex<T, 8>(a, long_rows, n_long, partials, nblocks, k, s); break;
    default: err = launch_circ_simplex<T, 0>(a, long_rows, n_long, partials, nblocks, k, s); break;
  }
  if (err != 0) return err;
  circulant_simplex_sum_kernel<T><<<1, kCircSimplexBlock, 0, s>>>(
      partials, nblocks + n_long, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

int cp_circulant_simplex_partials_len(int vv, int n_long) {
  return (vv + cp_pfdr::kCircSimplexBlock - 1) / cp_pfdr::kCircSimplexBlock +
         n_long;
}

int cp_circulant_simplex_max_labels() { return cp_pfdr::kMaxSimplexLabels; }

#define CP_CIRC_SIMPLEX_ENTRY(NAME, T)                                       \
  int NAME(const T *p, const T *q, const T *la_f, const T *ga,               \
           const T *ga_proj, const T *prev, const T *zu, const T *zv,        \
           const T *wu, const T *wv, const T *w_d1u, const T *w_d1v,         \
           const T *th_d1, const int *offs, const int *reu, const int *rev,  \
           const int *roff, const int *rslots, const int *long_rows,         \
           int n_long, T *po, T *prevo, T *zuo, T *zvo, T *acc_part,         \
           T *partials, T *sums, int nv, int vv, int nf, int ner, int k,     \
           double rho, double al, int has_laf, int label_mode,               \
           void *stream) {                                                   \
    cp_pfdr::SimplexStage<T> a = {                                           \
        p,     q,     la_f,  ga,    ga_proj, prev,  zu,       zv,            \
        wu,    wv,    w_d1u, w_d1v, th_d1,   offs,  reu,      rev,           \
        roff,  rslots, po,   prevo, zuo,     zvo,   acc_part, nv,            \
        vv,    nf,    ner,   (int64_t)nf * vv + ner, T(rho), label_mode,     \
        cp_pfdr::make_simplex_loss<T>(al, k, has_laf)};                      \
    return cp_pfdr::circulant_simplex<T>(a, long_rows, n_long, k, partials,  \
                                         sums, stream);                      \
  }

CP_CIRC_SIMPLEX_ENTRY(cp_circulant_simplex_f32, float)
CP_CIRC_SIMPLEX_ENTRY(cp_circulant_simplex_f64, double)

#undef CP_CIRC_SIMPLEX_ENTRY
}
