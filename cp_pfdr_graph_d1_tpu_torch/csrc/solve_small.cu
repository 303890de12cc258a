// Complete PFDR solve of a small reduced cut-pursuit problem in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/solve_small.py
// (fused_pfdr_solve_small, _kernel).  The iteration loop runs inside the
// kernel and exits early on the evolution test.  Each iteration computes
// the gradient from the operator (dense: r = A x, then A^t r; Gram: one
// matvec; diagonal: a product), the forward step, the endpoint gather, the
// d1 pair prox with relaxation, the edge -> vertex accumulation, the vertex
// prox with the vertices >= rv masked to zero, and the relative evolution.
//
// Design.  One block of 1024 threads runs the whole solve, with
// __syncthreads between the phases of an iteration.  The TPU kernel gathers
// endpoints and scatters edges with a one-hot [rv_cap, 2e] matrix on the
// MXU; here x and the forward values p live in shared memory and the
// endpoints are indexed loads.  The edge -> vertex sum walks a per-vertex
// incidence list (CSR, built once by the wrapper) in a fixed order, and the
// evolution sums use a fixed shuffle tree: no atomics, so the iteration
// count does not change between runs.  The operator, the auxiliary pairs z
// and the five edge constants stay in global memory (L2-resident at the
// sizes of the EEG problem: at most a 4096 x 4096 Gram or a 91 x 4096
// dense matrix).  Both matrix products are written here, one warp per row
// of A for r = A x and one thread per vertex for the second product, each
// reading coalesced rows.
//
// Bound.  One SM does all the work, so a large reduced problem is bound by
// that SM's bandwidth to L2 (the operator is read once or twice per
// iteration) and by the barriers between phases; a small one by the
// barriers alone.  Spreading a large problem over a cluster or a
// cooperative grid is the next step (PERF.md holds the measured times).
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kSmallThreads = 1024;
enum OpKind { kOpDense = 0, kOpGram = 1, kOpDiag = 2 };

template <typename T>
__global__ void __launch_bounds__(kSmallThreads, 1)
solve_small_kernel(int op_kind, const T *__restrict__ op, int n_rows,
                   const T *__restrict__ aty, const T *__restrict__ ga,
                   const T *__restrict__ th_l1, const T *__restrict__ x0,
                   const T *__restrict__ z0, const T *__restrict__ ec,
                   const int *__restrict__ eu, const int *__restrict__ ev,
                   const int *__restrict__ inc_off,
                   const int *__restrict__ inc_slot, int rv_cap, int ne,
                   int rv, int it_max, T rho, int vkind, int positivity,
                   T lo, T hi, T dif_tol2, T eps, T *__restrict__ xo,
                   T *__restrict__ zo, T *__restrict__ wz,
                   int *__restrict__ it_out, T *__restrict__ dif_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *sx = reinterpret_cast<T *>(smem_raw);  // [rv_cap] iterate
  T *sp = sx + rv_cap;                      // [rv_cap] forward values
  T *sr = sp + rv_cap;                      // [n_rows] A x (dense)
  T *scratch = sr + n_rows;                 // [64] reduction scratch
  __shared__ T s_dif;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T *wu = ec;
  const T *wv = ec + ne;
  const T *wdu = ec + 2 * ne;
  const T *wdv = ec + 3 * ne;
  const T *thd = ec + 4 * ne;
  T *zu = zo;
  T *zv = zo + ne;

  for (int v = tid; v < rv_cap; v += kSmallThreads) sx[v] = x0[v];
  for (int s = tid; s < 2 * ne; s += kSmallThreads) zo[s] = z0[s];
  __syncthreads();

  int it = 0;
  T dif = dif_tol2 > T(1) ? dif_tol2 : T(1);
  while (it < it_max && dif >= dif_tol2) {
    // gradient of the smooth part (reference :356-445), dense first pass
    if (op_kind == kOpDense) {
      for (int n = warp; n < n_rows; n += kSmallThreads / 32) {
        const T *row = op + (int64_t)n * rv_cap;
        T acc = T(0);
        for (int j = lane; j < rv_cap; j += 32) acc += row[j] * sx[j];
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) sr[n] = acc;
      }
      __syncthreads();
    }
    // second product and forward step P = 2X - Ga grad (:463-464)
    for (int j = tid; j < rv_cap; j += kSmallThreads) {
      T g;
      if (op_kind == kOpDense) {
        g = T(0);
        for (int n = 0; n < n_rows; ++n) g += sr[n] * op[(int64_t)n * rv_cap + j];
      } else if (op_kind == kOpGram) {
        g = T(0);
        for (int k = 0; k < rv_cap; ++k) g += sx[k] * op[(int64_t)k * rv_cap + j];
      } else {
        g = op[j] * sx[j];
      }
      sp[j] = forward_value(sx[j], ga[j], g - aty[j]);
    }
    __syncthreads();
    // per-edge d1 pair prox + relaxation (:466-489)
    for (int s = tid; s < ne; s += kSmallThreads) {
      const int u = eu[s], v = ev[s];
      T zun, zvn;
      pair_prox_relax(sp[u], sp[v], zu[s], zv[s], sx[u], sx[v], wdu[s],
                      wdv[s], thd[s], rho, zun, zvn);
      zu[s] = zun;
      zv[s] = zvn;
      wz[s] = wu[s] * zun;
      wz[ne + s] = wv[s] * zvn;
    }
    __syncthreads();
    // weighted edge -> vertex accumulation (:491-497), vertex prox
    // (:499-512) and evolution terms (:514-529)
    T num = T(0), den = T(0);
    for (int v = tid; v < rv_cap; v += kSmallThreads) {
      T a = T(0);
      for (int k = inc_off[v]; k < inc_off[v + 1]; ++k) a += wz[inc_slot[k]];
      T xn = vertex_prox(a, th_l1[v], vkind, positivity, lo, hi);
      if (v >= rv) xn = T(0);
      const T d = xn - sx[v];
      num += d * d;
      den += xn * xn;
      sx[v] = xn;
    }
    block_sum2(num, den, scratch);
    if (tid == 0) s_dif = den > eps ? num / den : num / eps;
    __syncthreads();
    dif = s_dif;
    ++it;
  }
  for (int v = tid; v < rv_cap; v += kSmallThreads) xo[v] = sx[v];
  if (tid == 0) {
    *it_out = it;
    *dif_out = dif;
  }
}

template <typename T>
size_t smem_bytes(int rv_cap, int n_rows) {
  return sizeof(T) * (2 * (size_t)rv_cap + (size_t)n_rows + 64);
}

template <typename T>
int solve_small(int op_kind, const T *op, int n_rows, const T *aty,
                const T *ga, const T *th_l1, const T *x0, const T *z0,
                const T *ec, const int *eu, const int *ev, const int *inc_off,
                const int *inc_slot, int rv_cap, int ne, int rv, int it_max,
                double rho, int vkind, int positivity, double lo, double hi,
                double dif_tol2, double eps, T *xo, T *zo, T *wz, int *it_out,
                T *dif_out, void *stream) {
  if (op_kind < kOpDense || op_kind > kOpDiag || rv_cap < 1 || ne < 1)
    return -1;
  if (op_kind != kOpDense) n_rows = 0;
  const size_t smem = smem_bytes<T>(rv_cap, n_rows);
  cudaError_t err = cudaFuncSetAttribute(
      solve_small_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  solve_small_kernel<T><<<1, kSmallThreads, smem, s>>>(
      op_kind, op, n_rows, aty, ga, th_l1, x0, z0, ec, eu, ev, inc_off,
      inc_slot, rv_cap, ne, rv, it_max, T(rho), vkind, positivity, T(lo),
      T(hi), T(dif_tol2), T(eps), xo, zo, wz, it_out, dif_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

#define CP_SMALL_ENTRY(NAME, T)                                               \
  int NAME(int op_kind, const T *op, int n_rows, const T *aty, const T *ga,   \
           const T *th_l1, const T *x0, const T *z0, const T *ec,             \
           const int *eu, const int *ev, const int *inc_off,                  \
           const int *inc_slot, int rv_cap, int ne, int rv, int it_max,       \
           double rho, int vkind, int positivity, double lo, double hi,       \
           double dif_tol2, double eps, T *xo, T *zo, T *wz, int *it_out,     \
           T *dif_out, void *stream) {                                        \
    return cp_pfdr::solve_small<T>(op_kind, op, n_rows, aty, ga, th_l1, x0,   \
                                   z0, ec, eu, ev, inc_off, inc_slot, rv_cap, \
                                   ne, rv, it_max, rho, vkind, positivity,    \
                                   lo, hi, dif_tol2, eps, xo, zo, wz, it_out, \
                                   dif_out, stream);                          \
  }

CP_SMALL_ENTRY(cp_solve_small_f32, float)
CP_SMALL_ENTRY(cp_solve_small_f64, double)

#undef CP_SMALL_ENTRY

// dynamic shared memory one launch needs, in bytes
size_t cp_solve_small_smem_bytes(int itemsize, int rv_cap, int n_rows) {
  return itemsize == 8 ? cp_pfdr::smem_bytes<double>(rv_cap, n_rows)
                       : cp_pfdr::smem_bytes<float>(rv_cap, n_rows);
}
}
