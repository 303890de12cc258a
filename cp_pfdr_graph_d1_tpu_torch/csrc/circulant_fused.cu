// One quadratic PFDR edge + vertex stage on a graph decomposed into offset
// families plus a remainder (CirculantGraphD1), for Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/circulant_fused.py
// (fused_circulant_iteration, _kernel).  Family f owns one slot per padded
// vertex u in [0, VV), the potential edge u -> (u + d_f) mod VV; slot
// (f, u) is edge f VV + u of the container.  The remainder edges, whose
// offsets are too rare for a family, follow from edge F VV on.  Per vertex
// the stage computes the forward step p = 2x - Gamma grad, the d1 pair prox
// with relaxation of every incident slot, the weighted average back to the
// vertex, the vertex prox, and the sums sum (x_new - x)^2 and sum x_new^2.
//
// Design: the schedule of circulant_common.cuh, shared with the K-label
// kernel circulant_fused_simplex.cu.  The TPU kernel turns each family's
// endpoint gather into a flat circular shift of the [VV8, 128] field
// (pltpu.roll); here the shift is index arithmetic.  A first launch writes
// the forward field fp [VV] (0 at the padded positions), as the TPU kernel
// computes it once, and gives each vertex whose remainder row holds more
// than kLongRow slots (the endpoints of the remainder's padding edges, 618
// slots each at the mesh scale) a block that sums the row's terms into
// acc_part, in contiguous runs and a fixed shuffle tree.  The main launch
// gives each padded vertex G threads (G = 8 at 64 families, 2 on a grid of
// 2 families), each a contiguous group of its families; a block holds
// 256 / G vertices, so the mesh gives 640 blocks, all resident at once
// (kCircMinBlocks).  A thread meets slot (f, u) as its tail and slot
// (f, (u - d_f) mod VV) as its head; the head's thread recomputes the
// slot's pair prox with the same device function on the same inputs as the
// tail's, which alone writes zu and zv, so no grid barrier is needed.  The
// group sums meet in shared memory and are added in group order (family
// order within a group; tail, then head); the group-0 thread then adds its
// remainder edges (or its long row's sum) and ends the vertex.  Padded
// threads write their family slots and nothing else; the z values of
// virtual slots (no edge: wu = 0, w_d1u = 0.5) stay finite and are never
// consumed.
//
// wv and w_d1v are derived, as the TPU kernel derives them: w_d1v =
// 1 - w_d1u and wv = wu (w_d1v / safe_u) (Gamma_v / safe_Gamma_u), 0 where
// Gamma_u = 0 (a padded position).  The quadratic preconditioner builds wu
// and wv from one raw weight, so the identity holds up to rounding; the
// remainder's slots derive them the same way, so the kernel reads 5 edge
// streams and writes 2.  The two sums end in the main launch: each block
// leaves its partials, and the last block to finish (an integer ticket)
// adds them in block order.  No float atomics: a solve's iteration count
// does not change between runs.
//
// Two other schedules measured slower on the mesh (PERF.md): each family
// slot's prox computed once, by its tail's thread, with the heads' sums in
// a second launch that reads the new zu, zv back; and the sums ended by a
// third, one-block launch.
//
// Bound.  Bytes: 7 streams of F VV family slots (zu, zv, wu, w_d1u, th_d1
// read, zu, zv written), the remainder's 7 streams and its indices, 5
// vertex fields.  At the mesh scale (F = 64, VV = 20,480: 1,310,720 slots,
// plus 2,048 remainder slots, float32) that is about 37 MB, or 11.1 us at
// 3.35 TB/s; the arithmetic, about 30 operations a slot, 0.6 us at 67
// TFLOP/s.  The head's five loads of a slot repeat the tail's, made by
// another block of the same wave at about the same time: they come from L2.
#include <cstdint>

#include "circulant_common.cuh"

namespace cp_pfdr {

// What a launch needs of a graph beside the fields, prepared once per
// (graph, fields' dtype and device, vertex prox) by the wrapper: the index
// arrays, the scratch, the ticket and the stage's constants.
struct CirculantPlan {
  const int *offs;                        // family offsets d_f
  const int *reu, *rev, *roff, *rslots;   // remainder edges and their CSR
  const int *long_rows;
  void *fp;        // [VV] forward values
  void *acc_part;  // [V] long remainder rows' sums (null without long rows)
  void *partials;  // [2 blocks] the main launch's block sums
  int *ticket;     // 0 between launches
  int nv, vv, nf, ner, n_long, device;
  double rho, lo, hi;
  int vkind, positivity;
};

template <typename T>
struct CirculantStage {
  const T *x, *grad, *ga, *th_l1;
  const T *zu, *zv, *wu, *w_d1u, *th_d1;
  const int *offs, *reu, *rev, *roff, *rslots;
  T *xo, *zuo, *zvo;
  T *acc_part, *fp;
  int nv, vv, nf, ner, groups;
  T rho;
  int vkind, positivity;
  T lo, hi;
};

// iterate and forward value at padded position i (0 beyond V): the forward
// value computed here (RECOMPUTE, the first launch) or read from fp
template <typename T, bool RECOMPUTE>
__device__ __forceinline__ void vertex_values(const CirculantStage<T> &a,
                                              int i, T &xi, T &fpi) {
  if (RECOMPUTE) {
    if (i < a.nv) {
      xi = __ldg(&a.x[i]);
      fpi = forward_value(xi, __ldg(&a.ga[i]), __ldg(&a.grad[i]));
    } else {
      xi = T(0);
      fpi = T(0);
    }
  } else {
    xi = padded_at(a.x, a.nv, i);
    fpi = __ldg(&a.fp[i]);
  }
}

// pair prox with relaxation of the slot at e between the tail's (xu, fpu)
// and the head's (xw, fpw) values
template <typename T>
__device__ __forceinline__ void slot_prox(const CirculantStage<T> &a,
                                          int64_t e, T fpu, T fpw, T xu,
                                          T xw, T wdu, T &zun, T &zvn) {
  pair_prox_relax(fpu, fpw, __ldg(&a.zu[e]), __ldg(&a.zv[e]), xu, xw, wdu,
                  T(1) - wdu, __ldg(&a.th_d1[e]), a.rho, zun, zvn);
}

// contribution of remainder slot `slot` to the average of its vertex; the
// tail's thread writes zu and zv
template <typename T, bool RECOMPUTE>
__device__ __forceinline__ T remainder_term(const CirculantStage<T> &a,
                                            int slot) {
  const bool tail = slot < a.ner;
  const int r = tail ? slot : slot - a.ner;
  const int64_t e = (int64_t)a.nf * a.vv + r;
  const int u = __ldg(&a.reu[r]), w = __ldg(&a.rev[r]);
  T xu, fpu, xw, fpw;
  vertex_values<T, RECOMPUTE>(a, u, xu, fpu);
  vertex_values<T, RECOMPUTE>(a, w, xw, fpw);
  const T wdu = __ldg(&a.w_d1u[e]);
  T zun, zvn;
  slot_prox(a, e, fpu, fpw, xu, xw, wdu, zun, zvn);
  if (tail) {
    a.zuo[e] = zun;
    a.zvo[e] = zvn;
    return __ldg(&a.wu[e]) * zun;
  }
  return derived_wv(__ldg(&a.wu[e]), wdu, __ldg(&a.ga[u]), __ldg(&a.ga[w])) *
         zvn;
}

// first launch.  Blocks [0, fblocks): fp on every padded vertex, one a
// thread.  Then one block per vertex whose remainder row holds more than
// kLongRow slots: the row's terms (forward values recomputed with the same
// device function, so with the same bits) into acc_part
template <typename T>
__global__ void __launch_bounds__(kCircFirstBlock)
circulant_forward_kernel(CirculantStage<T> a,
                         const int *__restrict__ long_rows, int fblocks) {
  if (static_cast<int>(blockIdx.x) < fblocks) {
    const int i = blockIdx.x * kCircFirstBlock + threadIdx.x;
    if (i < a.vv) {
      T xi, fpi;
      vertex_values<T, true>(a, i, xi, fpi);
      a.fp[i] = fpi;
    }
    return;
  }
  __shared__ T scratch[64];
  const int u = long_rows[blockIdx.x - fblocks];
  int lo, hi;
  long_row_run(__ldg(&a.roff[u]), __ldg(&a.roff[u + 1]), lo, hi);
  T acc[1] = {T(0)};
  for (int s = lo; s < hi; ++s)
    acc[0] = acc[0] + remainder_term<T, true>(a, __ldg(&a.rslots[s]));
  block_sum_values<T, 1>(acc, 1, scratch);
  if (threadIdx.x == 0) a.acc_part[u] = acc[0];
}

// G threads per padded vertex, one group of families each; the group-0
// thread ends the vertex, the last block to finish the sums
template <typename T>
__global__ void __launch_bounds__(kCircBlock, kCircMinBlocks)
circulant_fused_kernel(CirculantStage<T> a, T *__restrict__ partials,
                       int *__restrict__ ticket, T *__restrict__ sums) {
  __shared__ T group_sums[kCircBlock];
  __shared__ T scratch[64];
  const GroupPosition pos = group_position(a.groups);
  const int u = pos.u;
  const bool real = u < a.nv;
  T acc[1] = {T(0)};
  T xc = T(0);
  if (u < a.vv) {
    T fpc;
    vertex_values<T, false>(a, u, xc, fpc);
    const T gc = padded_at(a.ga, a.nv, u);
    int f0, f1;
    group_families(pos.g, a.nf, a.groups, f0, f1);
    for (int f = f0; f < f1; ++f) {
      const int d = __ldg(&a.offs[f]);
      const int64_t base = (int64_t)f * a.vv;
      // slot (f, u): u -> w
      int w = u + d;
      if (w >= a.vv) w -= a.vv;
      const int64_t e = base + u;
      T xw, fpw, zun, zvn;
      vertex_values<T, false>(a, w, xw, fpw);
      slot_prox(a, e, fpc, fpw, xc, xw, __ldg(&a.w_d1u[e]), zun, zvn);
      a.zuo[e] = zun;
      a.zvo[e] = zvn;
      if (real) {
        acc[0] = acc[0] + __ldg(&a.wu[e]) * zun;
        // slot (f, t): t -> u
        int t = u - d;
        if (t < 0) t += a.vv;
        const int64_t e2 = base + t;
        const T wdu2 = __ldg(&a.w_d1u[e2]);
        T xt, fpt, zun2, zvn2;
        vertex_values<T, false>(a, t, xt, fpt);
        slot_prox(a, e2, fpt, fpc, xt, xc, wdu2, zun2, zvn2);
        acc[0] = acc[0] + derived_wv(__ldg(&a.wu[e2]), wdu2,
                                     padded_at(a.ga, a.nv, t), gc) *
                              zvn2;
      }
    }
  }
  add_group_sums<T, 1>(acc, 1, pos, a.groups, group_sums);
  T num = T(0), den = T(0);
  if (pos.g == 0 && real) {
    const int beg = a.ner > 0 ? __ldg(&a.roff[u]) : 0;
    const int end = a.ner > 0 ? __ldg(&a.roff[u + 1]) : 0;
    if (end - beg > kLongRow) {
      acc[0] = acc[0] + a.acc_part[u];  // the first launch summed the row
    } else {
      for (int s = beg; s < end; ++s)
        acc[0] = acc[0] + remainder_term<T, false>(a, __ldg(&a.rslots[s]));
    }
    stage_vertex_tail(acc[0], __ldg(&a.th_l1[u]), xc, a.vkind, a.positivity,
                      a.lo, a.hi, a.xo + u, num, den);
  }
  block_sum2(num, den, scratch);
  last_block_sums(num, den, partials, ticket, sums, scratch);
}

template <typename T>
int circulant_fused(const CirculantPlan *p, const T *x, const T *grad,
                    const T *ga, const T *th_l1, const T *zu, const T *zv,
                    const T *wu, const T *w_d1u, const T *th_d1, T *xo, T *zo,
                    T *sums, void *stream) {
  if (p->nv < 1 || p->vv < p->nv || p->nf < 1 || p->ner < 0 ||
      p->n_long < 0)
    return -1;
  const int64_t ne = (int64_t)p->nf * p->vv + p->ner;
  const CirculantStage<T> a = {x, grad, ga, th_l1, zu, zv, wu, w_d1u, th_d1,
                               p->offs, p->reu, p->rev, p->roff, p->rslots,
                               xo, zo, zo + ne,
                               static_cast<T *>(p->acc_part),
                               static_cast<T *>(p->fp), p->nv, p->vv, p->nf,
                               p->ner, family_groups(p->nf), T(p->rho),
                               p->vkind, p->positivity, T(p->lo), T(p->hi)};
  return on_device(p->device, [&] {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int fblocks = forward_blocks(a.vv);
    circulant_forward_kernel<T><<<fblocks + p->n_long, kCircFirstBlock, 0,
                                  s>>>(a, p->long_rows, fblocks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    circulant_fused_kernel<T>
        <<<circulant_blocks(a.vv, a.groups), kCircBlock, 0, s>>>(
            a, static_cast<T *>(p->partials), p->ticket, sums);
    return cudaGetLastError();
  });
}

}  // namespace cp_pfdr

extern "C" {

int cp_circulant_plan_size() { return (int)sizeof(cp_pfdr::CirculantPlan); }

// (family groups, main-launch blocks) of a graph of nf families over vv
// padded vertices, as the launch takes them
void cp_circulant_launch_shape(int vv, int nf, int *out) {
  out[0] = cp_pfdr::family_groups(nf);
  out[1] = cp_pfdr::circulant_blocks(vv, out[0]);
}

#define CP_CIRCULANT_ENTRY(SUFFIX, T)                                        \
  int cp_circulant_fused_##SUFFIX(                                           \
      const cp_pfdr::CirculantPlan *plan, const T *x, const T *grad,         \
      const T *ga, const T *th_l1, const T *zu, const T *zv, const T *wu,    \
      const T *w_d1u, const T *th_d1, T *xo, T *zo, T *sums, void *stream) { \
    return cp_pfdr::circulant_fused<T>(plan, x, grad, ga, th_l1, zu, zv, wu, \
                                       w_d1u, th_d1, xo, zo, sums, stream);  \
  }

CP_CIRCULANT_ENTRY(f32, float)
CP_CIRCULANT_ENTRY(f64, double)

#undef CP_CIRCULANT_ENTRY
}
