// Complete PFDR solve of a reduced cut-pursuit problem of any size, in one
// cooperative launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/solve_fused.py
// (fused_pfdr_solve, _kernel).  Each iteration computes the gradient from
// the operator in the kernel's own body (dense: r = A x, then A^t r; Gram:
// one matvec; diagonal: a product), the forward step, the d1 pair prox with
// relaxation on every edge, the edge -> vertex accumulation, the vertex prox
// with the vertices >= rv held at zero, and the relative evolution; the loop
// exits early on the evolution test, as solve_small.cu does.  A solve
// resumes from given auxiliary pairs z0 and iterate x0; the wrapper counts
// the iterations done before (it0).
//
// Design.  The TPU kernel keeps its state in VMEM and reaches edges through
// the banded-tile layout with one-hot selector products, because a TPU has
// no vector gather.  Here the state lives in global memory (L2-resident up
// to several MB) and endpoints are indexed loads.  One cooperative launch
// runs the whole solve: as many blocks as can be resident at once, grid-
// stride loops, and a grid-wide barrier between the phases of an iteration
// (dense first product, gradient + forward step, edge pass, vertex pass).
// The edge -> vertex sum walks the per-vertex incidence list (CSR, built by
// the wrapper) in a fixed order; the evolution sums are reduced per block by
// a fixed shuffle tree into per-block partials that every block then adds
// in block order, so every block takes the same stopping decision and the
// iteration count does not change between runs (no float atomics).  The
// edges come sorted by their smaller endpoint (the order of the TPU
// kernel's banded plan), which keeps the endpoint loads of a warp close.
//
// Bound.  It is reached for reduced problems too big for solve_small's
// shared memory (rv_cap >= 32768 in float32 with the EEG operator).  An
// iteration streams the vertex fields (about 6 values per vertex), the edge
// fields (about 9 values per edge) and the operator once, a few MB at those
// sizes, all in L2; the arithmetic is a few operations per value, so an
// iteration is bound by L2 traffic and by its three or four grid barriers.
// PERF.md holds the measured times.
#include <cooperative_groups.h>

#include <cstdint>

#include "pfdr_common.cuh"

namespace cg = cooperative_groups;

namespace cp_pfdr {

constexpr int kSolveThreads = 256;
enum SolveOpKind { kSolveDense = 0, kSolveGram = 1, kSolveDiag = 2 };

template <typename T>
struct SolveArgs {
  const T *op, *aty, *ga, *th_l1, *x0, *z0, *ec;
  const int *eu, *ev, *inc_off, *inc_slot;
  T *x, *z, *p, *r, *wz, *partials, *dif_out;
  int *it_out;
  int op_kind, n_rows, rv_cap, ne, rv, it_max, vkind, positivity;
  T rho, lo, hi, dif_tol2, eps;
};

template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
solve_fused_kernel(SolveArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T scratch[64];
  __shared__ T s_dif;
  const int stride = gridDim.x * blockDim.x;
  const int tid0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int gwarp = tid0 >> 5;
  const int nwarps = stride >> 5;
  const int rv_cap = a.rv_cap, ne = a.ne;
  const T *wu = a.ec, *wv = a.ec + ne, *wdu = a.ec + 2 * ne;
  const T *wdv = a.ec + 3 * ne, *thd = a.ec + 4 * ne;
  T *x = a.x, *p = a.p, *r = a.r, *wz = a.wz;
  T *zu = a.z, *zv = a.z + ne;

  for (int v = tid0; v < rv_cap; v += stride) x[v] = a.x0[v];
  for (int s = tid0; s < 2 * ne; s += stride) a.z[s] = a.z0[s];
  grid.sync();

  int it = 0;
  T dif = a.dif_tol2 > T(1) ? a.dif_tol2 : T(1);
  while (it < a.it_max && dif >= a.dif_tol2) {
    // gradient of the smooth part (reference :356-445), dense first pass
    if (a.op_kind == kSolveDense) {
      for (int n = gwarp; n < a.n_rows; n += nwarps) {
        const T *row = a.op + (int64_t)n * rv_cap;
        T acc = T(0);
        for (int j = lane; j < rv_cap; j += 32) acc += row[j] * x[j];
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) r[n] = acc;
      }
      grid.sync();
    }
    // second product and forward step P = 2X - Ga grad (:463-464)
    for (int j = tid0; j < rv_cap; j += stride) {
      T g;
      if (a.op_kind == kSolveDense) {
        g = T(0);
        for (int n = 0; n < a.n_rows; ++n)
          g += r[n] * a.op[(int64_t)n * rv_cap + j];
      } else if (a.op_kind == kSolveGram) {
        g = T(0);
        for (int k = 0; k < rv_cap; ++k)
          g += x[k] * a.op[(int64_t)k * rv_cap + j];
      } else {
        g = a.op[j] * x[j];
      }
      p[j] = forward_value(x[j], a.ga[j], g - a.aty[j]);
    }
    grid.sync();
    // per-edge d1 pair prox + relaxation (:466-489)
    for (int s = tid0; s < ne; s += stride) {
      const int u = a.eu[s], v = a.ev[s];
      T zun, zvn;
      pair_prox_relax(p[u], p[v], zu[s], zv[s], x[u], x[v], wdu[s], wdv[s],
                      thd[s], a.rho, zun, zvn);
      zu[s] = zun;
      zv[s] = zvn;
      wz[s] = wu[s] * zun;
      wz[ne + s] = wv[s] * zvn;
    }
    grid.sync();
    // weighted edge -> vertex accumulation (:491-497), vertex prox
    // (:499-512) and evolution terms (:514-529)
    T num = T(0), den = T(0);
    for (int v = tid0; v < rv_cap; v += stride) {
      T acc = T(0);
      for (int k = a.inc_off[v]; k < a.inc_off[v + 1]; ++k)
        acc += wz[a.inc_slot[k]];
      T xn = vertex_prox(acc, a.th_l1[v], a.vkind, a.positivity, a.lo, a.hi);
      if (v >= a.rv) xn = T(0);
      const T d = xn - x[v];
      num += d * d;
      den += xn * xn;
      x[v] = xn;
    }
    block_sum2(num, den, scratch);
    if (threadIdx.x == 0) {
      a.partials[2 * blockIdx.x] = num;
      a.partials[2 * blockIdx.x + 1] = den;
    }
    grid.sync();
    if (threadIdx.x == 0) {
      T sn = T(0), sd = T(0);
      for (int b = 0; b < (int)gridDim.x; ++b) {
        sn += a.partials[2 * b];
        sd += a.partials[2 * b + 1];
      }
      s_dif = sd > a.eps ? sn / sd : sn / a.eps;
    }
    __syncthreads();
    dif = s_dif;
    ++it;
    __syncthreads();
  }
  if (tid0 == 0) {
    *a.it_out = it;
    *a.dif_out = dif;
  }
}

template <typename T>
int solve_fused(int op_kind, const T *op, int n_rows, const T *aty,
                const T *ga, const T *th_l1, const T *x0, const T *z0,
                const T *ec, const int *eu, const int *ev, const int *inc_off,
                const int *inc_slot, int rv_cap, int ne, int rv, int it_max,
                double rho, int vkind, int positivity, double lo, double hi,
                double dif_tol2, double eps, T *x, T *z, T *p, T *r, T *wz,
                T *partials, int max_blocks, int *it_out, T *dif_out,
                void *stream) {
  if (op_kind < kSolveDense || op_kind > kSolveDiag || rv_cap < 1 ||
      ne < 1 || max_blocks < 1)
    return -1;
  SolveArgs<T> a;
  a.op = op;
  a.aty = aty;
  a.ga = ga;
  a.th_l1 = th_l1;
  a.x0 = x0;
  a.z0 = z0;
  a.ec = ec;
  a.eu = eu;
  a.ev = ev;
  a.inc_off = inc_off;
  a.inc_slot = inc_slot;
  a.x = x;
  a.z = z;
  a.p = p;
  a.r = r;
  a.wz = wz;
  a.partials = partials;
  a.dif_out = dif_out;
  a.it_out = it_out;
  a.op_kind = op_kind;
  a.n_rows = op_kind == kSolveDense ? n_rows : 0;
  a.rv_cap = rv_cap;
  a.ne = ne;
  a.rv = rv;
  a.it_max = it_max;
  a.vkind = vkind;
  a.positivity = positivity;
  a.rho = T(rho);
  a.lo = T(lo);
  a.hi = T(hi);
  a.dif_tol2 = T(dif_tol2);
  a.eps = T(eps);
  void *args[] = {&a};
  const int items = rv_cap > ne ? rv_cap : ne;
  const int need = (items + kSolveThreads - 1) / kSolveThreads;
  return cooperative_launch(solve_fused_kernel<T>, kSolveThreads,
                            need < max_blocks ? need : max_blocks, args,
                            static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace cp_pfdr

extern "C" {

#define CP_SOLVE_FUSED_ENTRY(NAME, T)                                          \
  int NAME(int op_kind, const T *op, int n_rows, const T *aty, const T *ga,    \
           const T *th_l1, const T *x0, const T *z0, const T *ec,              \
           const int *eu, const int *ev, const int *inc_off,                   \
           const int *inc_slot, int rv_cap, int ne, int rv, int it_max,        \
           double rho, int vkind, int positivity, double lo, double hi,        \
           double dif_tol2, double eps, T *x, T *z, T *p, T *r, T *wz,         \
           T *partials, int max_blocks, int *it_out, T *dif_out,               \
           void *stream) {                                                     \
    return cp_pfdr::solve_fused<T>(op_kind, op, n_rows, aty, ga, th_l1, x0,    \
                                   z0, ec, eu, ev, inc_off, inc_slot, rv_cap,  \
                                   ne, rv, it_max, rho, vkind, positivity, lo, \
                                   hi, dif_tol2, eps, x, z, p, r, wz,          \
                                   partials, max_blocks, it_out, dif_out,      \
                                   stream);                                    \
  }

CP_SOLVE_FUSED_ENTRY(cp_solve_fused_f32, float)
CP_SOLVE_FUSED_ENTRY(cp_solve_fused_f64, double)

#undef CP_SOLVE_FUSED_ENTRY
}
