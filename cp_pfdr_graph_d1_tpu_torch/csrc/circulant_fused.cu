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
// Design.  The TPU kernel turns each family's endpoint gather into a flat
// circular shift of the [VV8, 128] field (pltpu.roll), its way around the
// missing vector gather.  Here the shift is index arithmetic: one thread
// owns padded vertex u, meets slot (f, u) as its tail and slot
// (f, (u - d_f) mod VV) as its head, for f = 0 .. F - 1 with the offsets
// d_f read from a device array (F is a runtime value), then its remainder
// edges through the remainder's incidence list (CSR, slot order).  It sums
// in that fixed order: family by family (tail, then head), then the
// remainder.  The head's thread recomputes the slot's forward values and
// pair prox with the same device functions from the same inputs as the
// tail's thread, which alone writes zu and zv of the slot: no grid barrier.
// The remainder's padding edges (weight-0 copies of its last edge) make
// that edge's endpoints hubs of the remainder's list; a vertex whose
// remainder row holds more than kLongRow slots leaves its family sum in a
// scratch row, and a second launch gives each such vertex a block that
// sums the row in contiguous runs and a fixed shuffle tree, adds it to the
// family sum and ends the stage.  Vertex fields hold the V real vertices;
// reads at a padded position u >= V give 0, the zero padding of the TPU
// layout, and the padded positions write their family slots but no
// iterate, and count in no sum.  Virtual slots (no edge) carry
// wu = wv = w_d1u = 0: their z values depend on the path and are never
// consumed.  The TPU kernel derives w_d1v = 1 - w_d1u and wv from wu and
// the Gamma ratio to save two streams; this kernel reads wv and w_d1v from
// the preconditioner instead, so it computes exactly what the staged loop
// computes.  The two sums go through per-block partials and a fixed-order
// last launch: no float atomics, so a solve's iteration count does not
// change between runs.
//
// Bound.  Bytes: the function needs 7 streams of F VV family slots (zu, zv,
// wu, w_d1u, th_d1 read, zu, zv written; wv and w_d1v follow from them and
// Gamma), the remainder's 7 streams and its indices, 5 vertex fields.  At
// the mesh scale (F = 64, VV = 20,480: 1,310,720 slots, plus 2,048
// remainder slots, float32) that is about 37 MB, or 11.1 us at 3.35 TB/s.
// This kernel moves 9 streams (about 47.5 MB, 14.2 us): reading wv and
// w_d1v costs 2/9 of its bytes.  The arithmetic, about 30 operations per
// slot, would take 0.6 us at 67 TFLOP/s.  The stage is bound by bytes; the
// family layout moves 22 times as many slots as the mesh has edges.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kCirculantBlock = 256;

template <typename T>
struct CirculantStage {
  const T *x, *grad, *ga, *th_l1;
  const T *zu, *zv, *wu, *wv, *w_d1u, *w_d1v, *th_d1;
  const int *offs;                        // family offsets d_f
  const int *reu, *rev, *roff, *rslots;   // remainder edges and their CSR
  T *xo, *zuo, *zvo;
  T *acc_part;  // [V] family sums of the vertices of long remainder rows
  int nv, vv, nf, ner;
  T rho;
  int vkind, positivity;
  T lo, hi;
};

// iterate and forward value at a padded position: 0 beyond the real
// vertices
template <typename T>
__device__ __forceinline__ void padded_values(const CirculantStage<T> &a,
                                              int i, T &xi, T &pi) {
  if (i < a.nv) {
    xi = a.x[i];
    pi = forward_value(xi, a.ga[i], a.grad[i]);
  } else {
    xi = T(0);
    pi = T(0);
  }
}

// contribution of remainder slot `slot` to the average of its vertex; the
// tail's thread writes zu and zv
template <typename T>
__device__ __forceinline__ T remainder_term(const CirculantStage<T> &a,
                                            int slot) {
  const bool tail = slot < a.ner;
  const int r = tail ? slot : slot - a.ner;
  const int64_t e = (int64_t)a.nf * a.vv + r;
  const int u = a.reu[r], w = a.rev[r];
  const T xu = a.x[u], xw = a.x[w];
  const T pu = forward_value(xu, a.ga[u], a.grad[u]);
  const T pw = forward_value(xw, a.ga[w], a.grad[w]);
  T zun, zvn;
  pair_prox_relax(pu, pw, a.zu[e], a.zv[e], xu, xw, a.w_d1u[e], a.w_d1v[e],
                  a.th_d1[e], a.rho, zun, zvn);
  if (tail) {
    a.zuo[e] = zun;
    a.zvo[e] = zvn;
    return a.wu[e] * zun;
  }
  return a.wv[e] * zvn;
}

// one thread per padded vertex: families, then the remainder rows of at
// most kLongRow slots
template <typename T>
__global__ void __launch_bounds__(kCirculantBlock)
circulant_fused_kernel(CirculantStage<T> a, T *__restrict__ partials) {
  __shared__ T scratch[64];
  const int u = blockIdx.x * kCirculantBlock + threadIdx.x;
  const bool real = u < a.nv;
  T num = T(0), den = T(0);
  if (u < a.vv) {
    T xc, pc;
    padded_values(a, u, xc, pc);
    T acc = T(0);
    for (int f = 0; f < a.nf; ++f) {
      const int d = a.offs[f];
      const int64_t base = (int64_t)f * a.vv;
      // slot (f, u): u -> w
      int w = u + d;
      if (w >= a.vv) w -= a.vv;
      const int64_t e = base + u;
      T xw, pw;
      padded_values(a, w, xw, pw);
      T zun, zvn;
      pair_prox_relax(pc, pw, a.zu[e], a.zv[e], xc, xw, a.w_d1u[e],
                      a.w_d1v[e], a.th_d1[e], a.rho, zun, zvn);
      a.zuo[e] = zun;
      a.zvo[e] = zvn;
      if (real) {
        acc = acc + a.wu[e] * zun;
        // slot (f, t): t -> u
        int t = u - d;
        if (t < 0) t += a.vv;
        const int64_t e2 = base + t;
        T xt, pt;
        padded_values(a, t, xt, pt);
        T zun2, zvn2;
        pair_prox_relax(pt, pc, a.zu[e2], a.zv[e2], xt, xc, a.w_d1u[e2],
                        a.w_d1v[e2], a.th_d1[e2], a.rho, zun2, zvn2);
        acc = acc + a.wv[e2] * zvn2;
      }
    }
    if (real) {
      const int beg = a.ner > 0 ? a.roff[u] : 0;
      const int end = a.ner > 0 ? a.roff[u + 1] : 0;
      if (end - beg > kLongRow) {
        a.acc_part[u] = acc;  // the long-row launch ends this vertex
      } else {
        for (int s = beg; s < end; ++s) acc = acc + remainder_term(a, a.rslots[s]);
        stage_vertex_tail(acc, a.th_l1[u], xc, a.vkind, a.positivity, a.lo,
                          a.hi, a.xo + u, num, den);
      }
    }
  }
  block_sum2(num, den, scratch);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = num;
    partials[2 * blockIdx.x + 1] = den;
  }
}

// one block per vertex whose remainder row holds more than kLongRow slots;
// its sums go to partials[2 (first + i)]
template <typename T>
__global__ void __launch_bounds__(kCirculantBlock)
circulant_fused_long_kernel(CirculantStage<T> a,
                            const int *__restrict__ long_rows,
                            T *__restrict__ partials, int first) {
  __shared__ T scratch[64];
  const int u = long_rows[blockIdx.x];
  int lo, hi;
  long_row_run(a.roff[u], a.roff[u + 1], lo, hi);
  T acc = T(0), unused = T(0);
  for (int s = lo; s < hi; ++s) acc = acc + remainder_term(a, a.rslots[s]);
  block_sum2(acc, unused, scratch);
  if (threadIdx.x == 0) {
    T num, den;
    stage_vertex_tail(a.acc_part[u] + acc, a.th_l1[u], a.x[u], a.vkind,
                      a.positivity, a.lo, a.hi, a.xo + u, num, den);
    partials[2 * (first + blockIdx.x)] = num;
    partials[2 * (first + blockIdx.x) + 1] = den;
  }
}

// last pass: one block adds the partials in a fixed order
template <typename T>
__global__ void __launch_bounds__(kCirculantBlock)
circulant_fused_sums_kernel(const T *__restrict__ partials, int nparts,
                            T *__restrict__ sums) {
  __shared__ T scratch[64];
  T a = T(0), b = T(0);
  for (int k = threadIdx.x; k < nparts; k += kCirculantBlock) {
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
int circulant_fused(const CirculantStage<T> &a, const int *long_rows,
                    int n_long, T *partials, T *sums, void *stream) {
  if (a.nv < 1 || a.vv < a.nv || a.nf < 1 || a.ner < 0 || n_long < 0)
    return -1;
  const int nblocks = (a.vv + kCirculantBlock - 1) / kCirculantBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  circulant_fused_kernel<T><<<nblocks, kCirculantBlock, 0, s>>>(a, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_long > 0) {
    circulant_fused_long_kernel<T><<<n_long, kCirculantBlock, 0, s>>>(
        a, long_rows, partials, nblocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  circulant_fused_sums_kernel<T><<<1, kCirculantBlock, 0, s>>>(
      partials, nblocks + n_long, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

int cp_circulant_partials_len(int vv, int n_long) {
  return 2 * ((vv + cp_pfdr::kCirculantBlock - 1) / cp_pfdr::kCirculantBlock +
              n_long);
}

#define CP_CIRCULANT_ENTRY(NAME, T)                                          \
  int NAME(const T *x, const T *grad, const T *ga, const T *th_l1,           \
           const T *zu, const T *zv, const T *wu, const T *wv,               \
           const T *w_d1u, const T *w_d1v, const T *th_d1, const int *offs,  \
           const int *reu, const int *rev, const int *roff,                  \
           const int *rslots, const int *long_rows, int n_long, T *xo,       \
           T *zuo, T *zvo, T *acc_part, T *partials, T *sums, int nv,        \
           int vv, int nf, int ner, double rho, int vkind, int positivity,   \
           double lo, double hi, void *stream) {                             \
    cp_pfdr::CirculantStage<T> a = {                                         \
        x,   grad, ga,     th_l1, zu,       zv, wu, wv, w_d1u, w_d1v, th_d1, \
        offs, reu, rev,    roff,  rslots,   xo, zuo, zvo, acc_part, nv, vv,  \
        nf,  ner,  T(rho), vkind, positivity, T(lo), T(hi)};                 \
    return cp_pfdr::circulant_fused<T>(a, long_rows, n_long, partials, sums, \
                                       stream);                              \
  }

CP_CIRCULANT_ENTRY(cp_circulant_fused_f32, float)
CP_CIRCULANT_ENTRY(cp_circulant_fused_f64, double)

#undef CP_CIRCULANT_ENTRY
}
