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
// Design.  A first short launch writes the forward field fp [K, VV] (0 at
// the padded positions u >= V), as the TPU kernel computes it once into
// scratch.  The main launch gives each padded vertex G threads (G = 8 at
// 64 families), each a contiguous group of its families: a block holds
// 256 / G vertices times G groups, and a warp 32 consecutive vertices of
// one group, so every slot load is coalesced and the mesh gives 640
// blocks, about five a SM (registers capped at 48 a thread, so all are
// resident at once).  A thread meets slot (f, u) as its tail and slot
// (f, (u - d_f) mod VV) as its head for each family of its group; the
// head's thread recomputes the slot's pair prox with the same device
// function on the same inputs as the tail's, which alone writes zu and zv,
// so one launch needs no grid barrier.  The group sums go through shared
// memory label by label and are added in group order (family order within
// a group; tail, then head), then the group-0 thread adds its remainder
// edges through the remainder's incidence list and ends the vertex: the
// Michelot projection and the stopping term see all K labels together.
// wv and w_d1v are derived from wu, w_d1u and the endpoints' Gamma exactly
// as the TPU kernel derives them (w_d1v = 1 - w_d1u, wv = wu (w_d1v /
// safe_u) (Gamma_v / safe_Gamma_u), 0 where Gamma_u = 0): the
// preconditioner makes the same weights up to rounding, so the launch moves
// 7 edge planes, not 9.  A vertex whose remainder row holds more than
// kLongRow slots (the endpoints of the remainder's padding edges) gets a
// block of the first launch, which sums its row's K terms in contiguous
// runs and a fixed shuffle tree per label into a scratch plane, where its
// group-0 thread finds them.  Reads at a padded position give 0, the zero
// padding of the TPU layout; padded threads write their family slots and
// nothing else (the z values of virtual slots stay finite and are never
// consumed).  K is
// a template parameter for 2..8 (arrays in registers) and a runtime value
// up to kMaxSimplexLabels otherwise (local memory).  The argmax keeps the
// first maximum, as the TPU kernel.  The stopping sum goes through
// per-block partials and a fixed-order last launch: no float atomics, so a
// solve's iteration count does not change between runs.
//
// Two other schedules measured slower on the mesh (PERF.md): the forward
// values recomputed by every thread that needs them, with no first launch
// for them; and each family slot's prox computed once, by its tail's
// thread, with the heads' sums in a second launch that reads the new zu,
// zv back.
//
// Bound.  Bytes: the function needs 7 family planes of K F VV slots (zu,
// zv, wu, w_d1u, th_d1 read, zu, zv written), the remainder's, and 7 K + 1
// vertex planes.  At the mesh scale (F = 64, VV = 20,480, K = 4, float32)
// that is about 148 MB, or 44 us at 3.35 TB/s, against about 2.5 us of
// float32 arithmetic: the stage is bound by bytes.  The head's five loads
// of a slot repeat the tail's, made by another block of the same wave at
// about the same time: they come from L2.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kCircSimplexBlock = 256;
// threads of the first launch's blocks: a hub row of the remainder's
// padding edges (618 slots at the mesh scale) takes one slot a thread
constexpr int kCircSimplexLongBlock = 1024;
constexpr int kMaxSimplexLabels = 32;
constexpr int kMaxFamilyGroups = 8;
// blocks of the main launch resident on one SM (caps its registers at 48
// a thread: 640 blocks at the mesh scale fit in one wave)
constexpr int kCircSimplexMinBlocks = 5;

template <typename T>
struct SimplexStage {
  const T *p, *q, *la_f, *ga, *ga_proj, *prev;
  const T *zu, *zv, *wu, *w_d1u, *th_d1;
  const int *offs;                        // family offsets d_f
  const int *reu, *rev, *roff, *rslots;   // remainder edges and their CSR
  T *po, *prevo, *zuo, *zvo;
  T *acc_part;  // [K, V] family sums of the vertices of long remainder rows
  T *fp;        // [K, VV] forward values, 0 at padded positions
  int nv, vv, nf, ner, groups;
  int64_t ne;   // edges in all: F VV + ner
  T rho;
  int label_mode;
  SimplexLoss<T> ls;
};

// family groups of a vertex: the largest power of two at most
// min(F, kMaxFamilyGroups)
inline int family_groups(int nf) {
  int g = 1;
  while (2 * g <= nf && 2 * g <= kMaxFamilyGroups) g *= 2;
  return g;
}

inline int simplex_blocks(int vv, int groups) {
  const int tv = kCircSimplexBlock / groups;
  return (vv + tv - 1) / tv;
}

template <typename T>
__device__ __forceinline__ T padded_at(const T *plane, int nv, int i) {
  return i < nv ? __ldg(plane + i) : T(0);
}

// label value and forward value of vertex i in plane k (0 beyond V): the
// forward value computed here (RECOMPUTE, the first launch) or read from
// the first launch's scratch
template <typename T, bool RECOMPUTE>
__device__ __forceinline__ void plane_values(const SimplexStage<T> &a, int k,
                                             int i, T &pv, T &fpv) {
  if (RECOMPUTE) {
    if (i < a.nv) {
      const int64_t c = (int64_t)k * a.nv + i;
      pv = __ldg(&a.p[c]);
      fpv = simplex_forward(pv, __ldg(&a.q[c]), __ldg(&a.la_f[i]),
                            __ldg(&a.ga[c]), a.ls);
    } else {
      pv = T(0);
      fpv = T(0);
    }
  } else {
    pv = padded_at(a.p + (int64_t)k * a.nv, a.nv, i);
    fpv = __ldg(&a.fp[(int64_t)k * a.vv + i]);
  }
}

// wv of a slot from its wu and w_d1u and its endpoints' Gamma, as the TPU
// kernel derives it (ops/circulant_fused_simplex.py:113-119)
template <typename T>
__device__ __forceinline__ T derived_wv(T wu, T wdu, T gau, T gav) {
  const T wdv = T(1) - wdu;
  const T safe_u = wdu > T(0) ? wdu : T(1);
  const T safe_g = gau > T(0) ? gau : T(1);
  return wu * (wdv / safe_u) * (gau > T(0) ? gav / safe_g : T(0));
}

// pair prox with relaxation of the slot at e between the tail's (pu, fpu)
// and the head's (pw, fpw) values
template <typename T>
__device__ __forceinline__ void slot_prox(const SimplexStage<T> &a,
                                          int64_t e, T fpu, T fpw, T pu,
                                          T pw, T wdu, T &zun, T &zvn) {
  pair_prox_relax(fpu, fpw, __ldg(&a.zu[e]), __ldg(&a.zv[e]), pu, pw, wdu,
                  T(1) - wdu, __ldg(&a.th_d1[e]), a.rho, zun, zvn);
}

// contribution of remainder edge r (u -> w) to label k's average at one of
// its endpoints (the tail when `tail`); the tail's thread writes zu and zv
template <typename T, bool RECOMPUTE>
__device__ __forceinline__ T remainder_term(const SimplexStage<T> &a, int r,
                                            bool tail, int u, int w, int k) {
  const int64_t e = (int64_t)k * a.ne + (int64_t)a.nf * a.vv + r;
  T pu, fpu, pw, fpw;
  plane_values<T, RECOMPUTE>(a, k, u, pu, fpu);
  plane_values<T, RECOMPUTE>(a, k, w, pw, fpw);
  const T wdu = __ldg(&a.w_d1u[e]);
  T zun, zvn;
  slot_prox(a, e, fpu, fpw, pu, pw, wdu, zun, zvn);
  if (tail) {
    a.zuo[e] = zun;
    a.zvo[e] = zvn;
    return __ldg(&a.wu[e]) * zun;
  }
  const int64_t pk = (int64_t)k * a.nv;
  return derived_wv(__ldg(&a.wu[e]), wdu, __ldg(&a.ga[pk + u]),
                    __ldg(&a.ga[pk + w])) * zvn;
}

// adds remainder slot `slot`'s terms of every label to acc
template <typename T, int KA, bool RECOMPUTE>
__device__ __forceinline__ void add_remainder_slot(const SimplexStage<T> &a,
                                                   int slot, T (&acc)[KA],
                                                   int K) {
  const bool tail = slot < a.ner;
  const int r = tail ? slot : slot - a.ner;
  const int u = __ldg(&a.reu[r]), w = __ldg(&a.rev[r]);
#pragma unroll
  for (int k = 0; k < K; ++k)
    acc[k] = acc[k] + remainder_term<T, RECOMPUTE>(a, r, tail, u, w, k);
}

// end of the iteration at real vertex u from its averages acc: the Michelot
// projection in the metric ga_proj, p_new and prev_new written; returns the
// vertex's stopping term
template <typename T, int KA>
__device__ __forceinline__ T vertex_tail(const SimplexStage<T> &a, int u,
                                         const T (&acc)[KA], int K) {
  T m[KA];
#pragma unroll
  for (int k = 0; k < K; ++k)
    m[k] = __ldg(&a.ga_proj[(int64_t)k * a.nv + u]);
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
      const T dd = fabs(pn - __ldg(&a.prev[c]));
      dsum = k == 0 ? dd : dsum + dd;
      a.prevo[c] = pn;
    }
  }
  if (a.label_mode) {
    const T lab_t = T(lab);
    dsum = lab_t != __ldg(&a.prev[u]) ? T(1) : T(0);
    a.prevo[u] = lab_t;
  }
  return dsum;
}

// first launch.  Blocks [0, fblocks): fp = 2 p - Gamma g on every (label,
// padded vertex), one a thread.  Then one block per
// vertex whose remainder row holds more than kLongRow slots: its row's
// terms of every label (the forward values recomputed with the same device
// function, so with the same bits), in contiguous runs and a fixed shuffle
// tree per pair of labels, into acc_part; the main launch adds them to the
// vertex's family sums
template <typename T, int KT>
__global__ void __launch_bounds__(kCircSimplexLongBlock)
circulant_simplex_forward_kernel(SimplexStage<T> a,
                                 const int *__restrict__ long_rows,
                                 int fblocks, int k_runtime) {
  constexpr int KA = KT > 0 ? KT : kMaxSimplexLabels;
  const int K = KT > 0 ? KT : k_runtime;
  if (static_cast<int>(blockIdx.x) < fblocks) {
    const int64_t i = (int64_t)blockIdx.x * kCircSimplexLongBlock + threadIdx.x;
    if (i < (int64_t)K * a.vv) {
      const int k = static_cast<int>(i / a.vv);
      const int u = static_cast<int>(i - (int64_t)k * a.vv);
      T pv, fpv;
      plane_values<T, true>(a, k, u, pv, fpv);
      a.fp[i] = fpv;
    }
    return;
  }
  __shared__ T scratch[64];
  const int u = long_rows[blockIdx.x - fblocks];
  T acc[KA];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  int lo, hi;
  long_row_run(__ldg(&a.roff[u]), __ldg(&a.roff[u + 1]), lo, hi);
  for (int s = lo; s < hi; ++s)
    add_remainder_slot<T, KA, true>(a, __ldg(&a.rslots[s]), acc, K);
  for (int k = 0; k < K; k += 2) {
    T b = k + 1 < K ? acc[k + 1] : T(0);
    block_sum2(acc[k], b, scratch);
    if (k + 1 < K) acc[k + 1] = b;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) a.acc_part[(int64_t)k * a.nv + u] = acc[k];
  }
}

// G threads per padded vertex, one group of families each (module
// comment); the group-0 thread ends the vertex
template <typename T, int KT>
__global__ void __launch_bounds__(kCircSimplexBlock, kCircSimplexMinBlocks)
circulant_simplex_kernel(SimplexStage<T> a, T *__restrict__ partials,
                         int k_runtime) {
  constexpr int KA = KT > 0 ? KT : kMaxSimplexLabels;
  const int K = KT > 0 ? KT : k_runtime;
  __shared__ T group_sums[kCircSimplexBlock];
  __shared__ T scratch[64];
  const int tv = kCircSimplexBlock / a.groups;
  const int g = threadIdx.x / tv;
  const int lane = threadIdx.x - g * tv;
  const int u = blockIdx.x * tv + lane;
  const bool real = u < a.nv;
  T acc[KA];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  if (u < a.vv) {
    T pc[KA], fpc[KA], gc[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      plane_values<T, false>(a, k, u, pc[k], fpc[k]);
      gc[k] = padded_at(a.ga + (int64_t)k * a.nv, a.nv, u);
    }
    const int f_end = (g + 1) * a.nf / a.groups;
    for (int f = g * a.nf / a.groups; f < f_end; ++f) {
      const int d = __ldg(&a.offs[f]);
      int w = u + d;
      if (w >= a.vv) w -= a.vv;
      int t = u - d;
      if (t < 0) t += a.vv;
      const int64_t base = (int64_t)f * a.vv;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // slot (f, u): u -> w
        const int64_t e = (int64_t)k * a.ne + base + u;
        T pw, fpw, zun, zvn;
        plane_values<T, false>(a, k, w, pw, fpw);
        slot_prox(a, e, fpc[k], fpw, pc[k], pw, __ldg(&a.w_d1u[e]), zun,
                  zvn);
        a.zuo[e] = zun;
        a.zvo[e] = zvn;
        if (real) {
          acc[k] = acc[k] + __ldg(&a.wu[e]) * zun;
          // slot (f, t): t -> u
          const int64_t e2 = (int64_t)k * a.ne + base + t;
          const T wdu2 = __ldg(&a.w_d1u[e2]);
          T pt, fpt, zun2, zvn2;
          plane_values<T, false>(a, k, t, pt, fpt);
          slot_prox(a, e2, fpt, fpc[k], pt, pc[k], wdu2, zun2, zvn2);
          const T gat = padded_at(a.ga + (int64_t)k * a.nv, a.nv, t);
          acc[k] = acc[k] +
                   derived_wv(__ldg(&a.wu[e2]), wdu2, gat, gc[k]) * zvn2;
        }
      }
    }
  }
  // the group sums, label by label, added in group order
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (g > 0) group_sums[threadIdx.x] = acc[k];
    __syncthreads();
    if (g == 0)
      for (int h = 1; h < a.groups; ++h)
        acc[k] = acc[k] + group_sums[h * tv + lane];
    __syncthreads();
  }
  T dsum = T(0);
  if (g == 0 && real) {
    const int beg = a.ner > 0 ? __ldg(&a.roff[u]) : 0;
    const int end = a.ner > 0 ? __ldg(&a.roff[u + 1]) : 0;
    if (end - beg > kLongRow) {
      // the first launch summed this vertex's remainder row
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k] = acc[k] + a.acc_part[(int64_t)k * a.nv + u];
    } else {
      for (int s = beg; s < end; ++s)
        add_remainder_slot<T, KA, false>(a, __ldg(&a.rslots[s]), acc, K);
    }
    dsum = vertex_tail<T, KA>(a, u, acc, K);
  }
  T unused = T(0);
  block_sum2(dsum, unused, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = dsum;
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
  // the forward field and the long rows
  const int fblocks = static_cast<int>(
      ((int64_t)k * a.vv + kCircSimplexLongBlock - 1) / kCircSimplexLongBlock);
  circulant_simplex_forward_kernel<T, KT>
      <<<fblocks + n_long, kCircSimplexLongBlock, 0, s>>>(a, long_rows,
                                                          fblocks, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  circulant_simplex_kernel<T, KT>
      <<<nblocks, kCircSimplexBlock, 0, s>>>(a, partials, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int circulant_simplex(const SimplexStage<T> &a, const int *long_rows,
                      int n_long, int k, T *partials, T *sums,
                      void *stream) {
  if (a.nv < 1 || a.vv < a.nv || a.nf < 1 || a.ner < 0 || n_long < 0 ||
      k < 1 || k > kMaxSimplexLabels)
    return -1;
  const int nblocks = simplex_blocks(a.vv, a.groups);
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
      partials, nblocks, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

int cp_circulant_simplex_partials_len(int vv, int nf) {
  return cp_pfdr::simplex_blocks(vv, cp_pfdr::family_groups(nf));
}

int cp_circulant_simplex_max_labels() { return cp_pfdr::kMaxSimplexLabels; }

#define CP_CIRC_SIMPLEX_ENTRY(NAME, T)                                       \
  int NAME(const T *p, const T *q, const T *la_f, const T *ga,               \
           const T *ga_proj, const T *prev, const T *zu, const T *zv,        \
           const T *wu, const T *w_d1u, const T *th_d1, const int *offs,     \
           const int *reu, const int *rev, const int *roff,                  \
           const int *rslots, const int *long_rows, int n_long, T *po,       \
           T *prevo, T *zuo, T *zvo, T *acc_part, T *fp, T *partials,        \
           T *sums, int nv, int vv, int nf, int ner, int k, double rho,      \
           double al, int has_laf, int label_mode, void *stream) {           \
    cp_pfdr::SimplexStage<T> a = {                                           \
        p,     q,     la_f,  ga,    ga_proj,  prev,  zu,     zv,             \
        wu,    w_d1u, th_d1, offs,  reu,      rev,   roff,   rslots,         \
        po,    prevo, zuo,   zvo,   acc_part, fp,    nv,     vv,             \
        nf,    ner,   cp_pfdr::family_groups(nf), (int64_t)nf * vv + ner,    \
        T(rho), label_mode, cp_pfdr::make_simplex_loss<T>(al, k, has_laf)};  \
    return cp_pfdr::circulant_simplex<T>(a, long_rows, n_long, k, partials, \
                                         sums, stream);                      \
  }

CP_CIRC_SIMPLEX_ENTRY(cp_circulant_simplex_f32, float)
CP_CIRC_SIMPLEX_ENTRY(cp_circulant_simplex_f64, double)

#undef CP_CIRC_SIMPLEX_ENTRY
}
