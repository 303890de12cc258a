// One quadratic PFDR edge + vertex stage on an unstructured graph, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/banded_fused.py
// (fused_banded_iteration, _kernel).  Per vertex it computes the forward
// step p = 2x - Gamma grad, for every incident edge the d1 pair prox with
// relaxation on (zu, zv), the weighted average back to the vertex
// (wu zu at the edges it tails, wv zv at those it heads), the vertex prox,
// and the sums sum (x_new - x)^2 and sum x_new^2.
//
// Design.  The TPU kernel walks banded edge tiles and reaches the vertex
// window through one-hot MXU products, because the TPU has no vector
// gather.  Here one thread owns one vertex v and walks its incidence list
// (CSR offsets and endpoint slots, in slot order).  For each incident edge
// it recomputes the forward values of both endpoints and the pair prox with
// the same device functions (pfdr_common.cuh) from the same inputs, so the
// two endpoint threads of an edge get bit-equal zu and zv.  The thread of
// eu[e] writes zu[e] and zv[e]; inputs and outputs are separate buffers, so
// there is no race between an edge's readers and its writer.  No grid
// barrier.  The padding edges of the container are weight-0 copies of its
// last edge: they are visited and written like any edge and add 0 to the
// averages, but they make the last edge's endpoints hubs (about 620 slots
// each on the mesh), and a hub walked by one thread serializes the launch.
// So the rows of more than kLongRow slots, listed once per graph on the
// host, are skipped by the thread-per-vertex launch and summed by a second
// launch, one block per row: each thread takes a contiguous run of the
// row's slots in order, a fixed shuffle tree adds the runs.  The two sums
// are reduced deterministically: a fixed tree per block into per-block
// partials (the long rows' after the others), then a one-block launch adds
// them in a fixed order.  No float atomics, so a solve's iteration count
// does not change between runs.
//
// Bound.  Each input is read once and each output written once: the 7
// per-edge inputs (zu, zv, wu, wv, w_d1u, w_d1v, th_d1), the 2 per-edge
// outputs, the 4 per-vertex inputs (x, grad, Gamma, l1 thresholds) and the
// output x, plus the eu, ev and incidence indices.  At the mesh scale
// (59,392 padded edges, 19,600 vertices, float32) that is about 3.5 MB, or
// 1.05 us at 3.35 TB/s; the arithmetic is about 30 operations per edge.  A
// launch at this size is latency-bound; PERF.md holds its measured time.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kBandedFusedBlock = 256;

template <typename T>
struct BandedStage {
  const T *x, *grad, *ga, *th_l1;
  const T *zu, *zv, *wu, *wv, *w_d1u, *w_d1v, *th_d1;
  const int *eu, *ev, *offsets, *slots;
  T *xo, *zuo, *zvo;
  int nv, ne;
  T rho;
  int vkind, positivity;
  T lo, hi;
};

// contribution of incident slot `slot` to the average of vertex v
// (forward value pc, iterate xc); the tail's thread writes zu and zv
template <typename T>
__device__ __forceinline__ T slot_term(const BandedStage<T> &a, int slot,
                                       T pc, T xc) {
  const bool tail = slot < a.ne;
  const int e = tail ? slot : slot - a.ne;
  const int o = tail ? a.ev[e] : a.eu[e];
  const T xw = a.x[o];
  const T pw = forward_value(xw, a.ga[o], a.grad[o]);
  T zun, zvn;
  if (tail) {
    pair_prox_relax(pc, pw, a.zu[e], a.zv[e], xc, xw, a.w_d1u[e], a.w_d1v[e],
                    a.th_d1[e], a.rho, zun, zvn);
    a.zuo[e] = zun;
    a.zvo[e] = zvn;
    return a.wu[e] * zun;
  }
  pair_prox_relax(pw, pc, a.zu[e], a.zv[e], xw, xc, a.w_d1u[e], a.w_d1v[e],
                  a.th_d1[e], a.rho, zun, zvn);
  return a.wv[e] * zvn;
}

template <typename T>
__device__ __forceinline__ void vertex_tail(const BandedStage<T> &a, int v,
                                            T acc, T xc, T &num, T &den) {
  stage_vertex_tail(acc, a.th_l1[v], xc, a.vkind, a.positivity, a.lo, a.hi,
                    a.xo + v, num, den);
}

// one thread per vertex of at most kLongRow slots
template <typename T>
__global__ void __launch_bounds__(kBandedFusedBlock)
banded_fused_kernel(BandedStage<T> a, T *__restrict__ partials) {
  __shared__ T scratch[64];
  const int v = blockIdx.x * kBandedFusedBlock + threadIdx.x;
  T num = T(0), den = T(0);
  if (v < a.nv) {
    const int beg = a.offsets[v], end = a.offsets[v + 1];
    if (end - beg <= kLongRow) {
      const T xc = a.x[v];
      const T pc = forward_value(xc, a.ga[v], a.grad[v]);
      T acc = T(0);
      for (int s = beg; s < end; ++s)
        acc = acc + slot_term(a, a.slots[s], pc, xc);
      vertex_tail(a, v, acc, xc, num, den);
    }
  }
  block_sum2(num, den, scratch);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = num;
    partials[2 * blockIdx.x + 1] = den;
  }
}

// one block per vertex of more than kLongRow slots; its sums go to
// partials[2 (first + i)], after the thread-per-vertex launch's
template <typename T>
__global__ void __launch_bounds__(kBandedFusedBlock)
banded_fused_long_kernel(BandedStage<T> a, const int *__restrict__ long_rows,
                         T *__restrict__ partials, int first) {
  __shared__ T scratch[64];
  const int v = long_rows[blockIdx.x];
  const T xc = a.x[v];
  const T pc = forward_value(xc, a.ga[v], a.grad[v]);
  int lo, hi;
  long_row_run(a.offsets[v], a.offsets[v + 1], lo, hi);
  T acc = T(0), unused = T(0);
  for (int s = lo; s < hi; ++s) acc = acc + slot_term(a, a.slots[s], pc, xc);
  block_sum2(acc, unused, scratch);
  if (threadIdx.x == 0) {
    T num, den;
    vertex_tail(a, v, acc, xc, num, den);
    partials[2 * (first + blockIdx.x)] = num;
    partials[2 * (first + blockIdx.x) + 1] = den;
  }
}

// last pass: one block adds the partials in a fixed order
template <typename T>
__global__ void __launch_bounds__(kBandedFusedBlock)
banded_fused_sums_kernel(const T *__restrict__ partials, int nparts,
                         T *__restrict__ sums) {
  __shared__ T scratch[64];
  T a = T(0), b = T(0);
  for (int k = threadIdx.x; k < nparts; k += kBandedFusedBlock) {
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
int banded_fused(const BandedStage<T> &a, const int *long_rows, int n_long,
                 T *partials, T *sums, void *stream) {
  if (a.nv < 1 || a.ne < 1 || n_long < 0) return -1;
  const int nblocks = (a.nv + kBandedFusedBlock - 1) / kBandedFusedBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  banded_fused_kernel<T><<<nblocks, kBandedFusedBlock, 0, s>>>(a, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_long > 0) {
    banded_fused_long_kernel<T><<<n_long, kBandedFusedBlock, 0, s>>>(
        a, long_rows, partials, nblocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  banded_fused_sums_kernel<T><<<1, kBandedFusedBlock, 0, s>>>(
      partials, nblocks + n_long, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

int cp_banded_fused_partials_len(int nv, int n_long) {
  return 2 * ((nv + cp_pfdr::kBandedFusedBlock - 1) /
                  cp_pfdr::kBandedFusedBlock +
              n_long);
}

#define CP_BANDED_FUSED_ENTRY(NAME, T)                                       \
  int NAME(const T *x, const T *grad, const T *ga, const T *th_l1,           \
           const T *zu, const T *zv, const T *wu, const T *wv,               \
           const T *w_d1u, const T *w_d1v, const T *th_d1, const int *eu,    \
           const int *ev, const int *offsets, const int *slots,              \
           const int *long_rows, int n_long, T *xo, T *zuo, T *zvo,          \
           T *partials, T *sums, int nv, int ne, double rho, int vkind,      \
           int positivity, double lo, double hi, void *stream) {             \
    cp_pfdr::BandedStage<T> a = {x,     grad,    ga,    th_l1, zu,    zv,    \
                                 wu,    wv,      w_d1u, w_d1v, th_d1, eu,    \
                                 ev,    offsets, slots, xo,    zuo,   zvo,   \
                                 nv,    ne,      T(rho), vkind, positivity,  \
                                 T(lo), T(hi)};                              \
    return cp_pfdr::banded_fused<T>(a, long_rows, n_long, partials, sums,    \
                                    stream);                                 \
  }

CP_BANDED_FUSED_ENTRY(cp_banded_fused_f32, float)
CP_BANDED_FUSED_ENTRY(cp_banded_fused_f64, double)

#undef CP_BANDED_FUSED_ENTRY
}
