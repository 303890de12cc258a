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
// gather.  Here each vertex v gets L lanes of a warp (L a power of two
// chosen from the graph's mean degree when the plan is built: 8 on the
// mesh's 6), and walks its incidence list (CSR offsets and endpoint slots):
// lane j takes slots beg + j, beg + j + L, ... in slot order, and a fixed
// shuffle tree inside the L lanes adds the lanes' sums, so the dependent
// loads of one row (slot -> edge -> other endpoint's x, Gamma, grad) run
// side by side instead of one after another.  For each incident edge a lane
// recomputes the forward values of both endpoints and the pair prox with
// the same device functions (pfdr_common.cuh) from the same inputs, so the
// two endpoints' lanes of an edge get bit-equal zu and zv; only the tail's
// lane writes them (inputs and outputs are separate buffers: no race, no
// grid barrier).  The padding edges of the container are weight-0 copies of
// its last edge: they add 0 to the averages but make the last edge's
// endpoints hubs (about 620 slots each on the mesh), so rows of more than
// kLongRow slots, listed once per graph on the host, are skipped by the
// vertex tiles and taken by blocks of the same grid past the tiles, one a
// row: each thread a contiguous run of the row's slots in order, a fixed
// shuffle tree over the block.  The two sums end in the same launch: each
// block leaves its partials, and the last block to finish (an integer
// ticket) adds them in block order.  No float atomics, so a solve's
// iteration count does not change between runs.  On the mesh (PERF.md) 8
// lanes beat 1, 2, 4, 16 and 32, and the ticket a one-block sum launch.
//
// Bound.  Each input is read once and each output written once: the 7
// per-edge inputs (zu, zv, wu, wv, w_d1u, w_d1v, th_d1), the 2 per-edge
// outputs, the 4 per-vertex inputs (x, grad, Gamma, l1 thresholds) and the
// output x, plus the eu, ev and incidence indices.  At the mesh scale
// (59,392 padded edges, 19,600 vertices, float32) that is about 3.5 MB, or
// 1.05 us at 3.35 TB/s; the arithmetic is about 30 operations per edge.  A
// launch at this size is bound by latency; PERF.md holds its measured time.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kBandedFusedBlock = 256;
constexpr int kMaxVertexLanes = 32;

// What a launch needs of a graph beside the fields, prepared once per
// (graph, fields' dtype and device, vertex prox) by the wrapper: the index
// arrays, the lanes per vertex, the partials, the ticket and the stage's
// constants.
struct BandedFusedPlan {
  const int *eu, *ev, *offsets, *slots, *long_rows;
  void *partials;  // [2 (tiles + n_long)] block sums
  int *ticket;     // 0 between launches
  int nv, ne, n_long, lanes, device;
  double rho, lo, hi;
  int vkind, positivity;
};

// vertex tiles of a launch: kBandedFusedBlock / lanes vertices each
inline int vertex_tiles(int nv, int lanes) {
  const int per = kBandedFusedBlock / lanes;
  return (nv + per - 1) / per;
}

template <typename T>
struct BandedStage {
  const T *x, *grad, *ga, *th_l1;
  const T *zu, *zv, *wu, *wv, *w_d1u, *w_d1v, *th_d1;
  const int *eu, *ev, *offsets, *slots, *long_rows;
  T *xo, *zuo, *zvo;
  int nv, ne, lanes, tiles;
  T rho;
  int vkind, positivity;
  T lo, hi;
};

// contribution of incident slot `slot` to the average of vertex v
// (forward value pc, iterate xc); the tail's lane writes zu and zv
template <typename T>
__device__ __forceinline__ T slot_term(const BandedStage<T> &a, int slot,
                                       T pc, T xc) {
  const bool tail = slot < a.ne;
  const int e = tail ? slot : slot - a.ne;
  const int o = tail ? __ldg(&a.ev[e]) : __ldg(&a.eu[e]);
  const T xw = __ldg(&a.x[o]);
  const T pw = forward_value(xw, __ldg(&a.ga[o]), __ldg(&a.grad[o]));
  const T zu = __ldg(&a.zu[e]), zv = __ldg(&a.zv[e]);
  const T wdu = __ldg(&a.w_d1u[e]), wdv = __ldg(&a.w_d1v[e]);
  const T th = __ldg(&a.th_d1[e]);
  T zun, zvn;
  if (tail) {
    pair_prox_relax(pc, pw, zu, zv, xc, xw, wdu, wdv, th, a.rho, zun, zvn);
    a.zuo[e] = zun;
    a.zvo[e] = zvn;
    return __ldg(&a.wu[e]) * zun;
  }
  pair_prox_relax(pw, pc, zu, zv, xw, xc, wdu, wdv, th, a.rho, zun, zvn);
  return __ldg(&a.wv[e]) * zvn;
}

// Blocks [0, tiles): L lanes per vertex of at most kLongRow slots.  Blocks
// [tiles, tiles + n_long): one vertex of more than kLongRow slots each.
// The last block to finish ends the sums.
template <typename T>
__global__ void __launch_bounds__(kBandedFusedBlock)
banded_fused_kernel(BandedStage<T> a, T *__restrict__ partials,
                    int *__restrict__ ticket, T *__restrict__ sums) {
  __shared__ T scratch[64];
  T num = T(0), den = T(0);
  if (static_cast<int>(blockIdx.x) < a.tiles) {
    const int lanes = a.lanes;
    const int j = threadIdx.x & (lanes - 1);
    const int v = blockIdx.x * (kBandedFusedBlock / lanes) +
                  static_cast<int>(threadIdx.x) / lanes;
    bool live = false;
    T acc = T(0), xc = T(0);
    if (v < a.nv) {
      const int beg = __ldg(&a.offsets[v]), end = __ldg(&a.offsets[v + 1]);
      live = end - beg <= kLongRow;
      if (live) {
        xc = __ldg(&a.x[v]);
        const T pc = forward_value(xc, __ldg(&a.ga[v]), __ldg(&a.grad[v]));
        for (int s = beg + j; s < end; s += lanes)
          acc = acc + slot_term(a, __ldg(&a.slots[s]), pc, xc);
      }
    }
    // the lanes' sums, in a fixed tree inside each vertex's L lanes
    for (int off = lanes >> 1; off > 0; off >>= 1)
      acc = acc + __shfl_down_sync(0xffffffffu, acc, off, lanes);
    if (live && j == 0)
      stage_vertex_tail(acc, __ldg(&a.th_l1[v]), xc, a.vkind, a.positivity,
                        a.lo, a.hi, a.xo + v, num, den);
    block_sum2(num, den, scratch);
  } else {
    const int v = a.long_rows[blockIdx.x - a.tiles];
    const T xc = __ldg(&a.x[v]);
    const T pc = forward_value(xc, __ldg(&a.ga[v]), __ldg(&a.grad[v]));
    int lo, hi;
    long_row_run(__ldg(&a.offsets[v]), __ldg(&a.offsets[v + 1]), lo, hi);
    T acc = T(0), unused = T(0);
    for (int s = lo; s < hi; ++s)
      acc = acc + slot_term(a, __ldg(&a.slots[s]), pc, xc);
    block_sum2(acc, unused, scratch);
    if (threadIdx.x == 0)
      stage_vertex_tail(acc, __ldg(&a.th_l1[v]), xc, a.vkind, a.positivity,
                        a.lo, a.hi, a.xo + v, num, den);
  }
  last_block_sums(num, den, partials, ticket, sums, scratch);
}

template <typename T>
int banded_fused(const BandedFusedPlan *p, const T *x, const T *grad,
                 const T *ga, const T *th_l1, const T *zu, const T *zv,
                 const T *wu, const T *wv, const T *w_d1u, const T *w_d1v,
                 const T *th_d1, T *xo, T *zo, T *sums, void *stream) {
  if (p->nv < 1 || p->ne < 1 || p->n_long < 0 || p->lanes < 1 ||
      p->lanes > kMaxVertexLanes || (p->lanes & (p->lanes - 1)) != 0)
    return -1;
  const int tiles = vertex_tiles(p->nv, p->lanes);
  const BandedStage<T> a = {x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v,
                            th_d1, p->eu, p->ev, p->offsets, p->slots,
                            p->long_rows, xo, zo, zo + p->ne, p->nv, p->ne,
                            p->lanes, tiles, T(p->rho), p->vkind,
                            p->positivity, T(p->lo), T(p->hi)};
  return on_device(p->device, [&] {
    banded_fused_kernel<T>
        <<<tiles + p->n_long, kBandedFusedBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
            a, static_cast<T *>(p->partials), p->ticket, sums);
    return cudaGetLastError();
  });
}

}  // namespace cp_pfdr

extern "C" {

int cp_banded_fused_plan_size() {
  return (int)sizeof(cp_pfdr::BandedFusedPlan);
}

// (block threads, most lanes a vertex, vertex tiles of nv vertices at
// `lanes` lanes)
void cp_banded_fused_launch_shape(int nv, int lanes, int *out) {
  out[0] = cp_pfdr::kBandedFusedBlock;
  out[1] = cp_pfdr::kMaxVertexLanes;
  out[2] = cp_pfdr::vertex_tiles(nv, lanes);
}

#define CP_BANDED_FUSED_ENTRY(SUFFIX, T)                                     \
  int cp_banded_fused_##SUFFIX(                                              \
      const cp_pfdr::BandedFusedPlan *plan, const T *x, const T *grad,       \
      const T *ga, const T *th_l1, const T *zu, const T *zv, const T *wu,    \
      const T *wv, const T *w_d1u, const T *w_d1v, const T *th_d1, T *xo,    \
      T *zo, T *sums, void *stream) {                                        \
    return cp_pfdr::banded_fused<T>(plan, x, grad, ga, th_l1, zu, zv, wu,    \
                                    wv, w_d1u, w_d1v, th_d1, xo, zo, sums,   \
                                    stream);                                 \
  }

CP_BANDED_FUSED_ENTRY(f32, float)
CP_BANDED_FUSED_ENTRY(f64, double)

#undef CP_BANDED_FUSED_ENTRY
}
