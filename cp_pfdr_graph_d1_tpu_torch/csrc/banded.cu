// Endpoint gather and deterministic edge -> vertex sum on an unstructured
// graph, for Hopper (sm_90a).
//
// Replaces the TPU kernels cp_pfdr_graph_d1_tpu/ops/banded.py
// (_banded_gather, _banded_scatter).  The gather computes, for every edge e
// and column c of a [V] or [V, K] field, out_u[e, c] = x[eu[e], c] and
// out_v[e, c] = x[ev[e], c]; the scatter computes
// out[v, c] = sum_{eu[e] = v} vals_u[e, c] + sum_{ev[e] = v} vals_v[e, c].
//
// Design.  The TPU kernels exist because the TPU has no vector gather: they
// tile the edges sorted by their smaller endpoint, gather a window of
// vertex rows with one-hot MXU products and pack the results into lanes.
// Hopper loads from any address, so the gather is one thread per
// (edge, column) doing two indexed loads.  The scatter must not use float
// atomics: their order changes from run to run, and so would a PFDR solve's
// iteration count.  It walks each vertex's incidence list (CSR offsets and
// endpoint slots, slot s < E the u-end of edge s, E + s its v-end, sorted by
// slot within each vertex) and sums in that fixed order.  A row of high
// degree (a hub component of a contracted cut-pursuit graph adjacent to
// thousands of others) would serialize a thread-per-row launch, so rows of
// more than kLongRow slots, listed once per graph on the host, go to a
// second launch that gives each such row a block: each thread sums a
// contiguous run of slots in order, then a fixed shuffle tree adds the runs.
// The sum is the same in every run.
//
// Bound.  Both functions move bytes and do almost no arithmetic: the gather
// reads E (2 indices) and writes 2 E K values, the scatter reads 2 E K
// values and the 2 E slots plus V + 1 offsets and writes V K values.  At
// the mesh scale (E = 59,392 padded edges, V = 19,600, float32) that is
// about 0.7 MB, a fraction of a microsecond at 3.35 TB/s, so the launches
// are latency-bound; PERF.md holds the measured times beside
// torch.index_select and index_add_.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kBandedBlock = 256;
constexpr int kMaxGridBlocks = 132 * 64;

template <typename T>
__global__ void __launch_bounds__(kBandedBlock)
banded_gather_kernel(const T *__restrict__ x, const int *__restrict__ eu,
                     const int *__restrict__ ev, T *__restrict__ ou,
                     T *__restrict__ ov, int64_t n, int k) {
  for (int64_t t = (int64_t)blockIdx.x * kBandedBlock + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * kBandedBlock) {
    const int64_t e = t / k;
    const int c = (int)(t - e * k);
    ou[t] = x[(int64_t)eu[e] * k + c];
    ov[t] = x[(int64_t)ev[e] * k + c];
  }
}

// value of endpoint slot s (u-end below ne, v-end from ne on) in column c
template <typename T>
__device__ __forceinline__ T slot_value(const T *__restrict__ vu,
                                        const T *__restrict__ vv, int s,
                                        int ne, int k, int c) {
  return s < ne ? vu[(int64_t)s * k + c] : vv[(int64_t)(s - ne) * k + c];
}

// one thread per (vertex, column) of the rows of at most kLongRow slots
template <typename T>
__global__ void __launch_bounds__(kBandedBlock)
banded_scatter_rows_kernel(const T *__restrict__ vu, const T *__restrict__ vv,
                           const int *__restrict__ offsets,
                           const int *__restrict__ slots, T *__restrict__ out,
                           int nv, int ne, int k) {
  const int64_t n = (int64_t)nv * k;
  for (int64_t t = (int64_t)blockIdx.x * kBandedBlock + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * kBandedBlock) {
    const int v = (int)(t / k);
    const int c = (int)(t - (int64_t)v * k);
    const int beg = offsets[v], end = offsets[v + 1];
    if (end - beg > kLongRow) continue;
    T acc = T(0);
    for (int s = beg; s < end; ++s) acc += slot_value(vu, vv, slots[s], ne, k, c);
    out[t] = acc;
  }
}

// one block per (long row, column): contiguous runs per thread, then a
// fixed shuffle tree
template <typename T>
__global__ void __launch_bounds__(kBandedBlock)
banded_scatter_long_kernel(const T *__restrict__ vu, const T *__restrict__ vv,
                           const int *__restrict__ offsets,
                           const int *__restrict__ slots,
                           const int *__restrict__ long_rows,
                           T *__restrict__ out, int ne, int k) {
  __shared__ T scratch[64];
  const int v = long_rows[blockIdx.x];
  const int c = blockIdx.y;
  int lo, hi;
  long_row_run(offsets[v], offsets[v + 1], lo, hi);
  T acc = T(0), unused = T(0);
  for (int s = lo; s < hi; ++s) acc += slot_value(vu, vv, slots[s], ne, k, c);
  block_sum2(acc, unused, scratch);
  if (threadIdx.x == 0) out[(int64_t)v * k + c] = acc;
}

inline int grid_for(int64_t n) {
  int64_t b = (n + kBandedBlock - 1) / kBandedBlock;
  if (b > kMaxGridBlocks) b = kMaxGridBlocks;
  return b < 1 ? 1 : (int)b;
}

// What a launch needs of a graph and a field shape, prepared once per
// (graph, dtype, shape, device) by the wrapper: the device index arrays and
// their sizes.  A launch then marshals four arguments.
struct BandedPlan {
  const int *eu, *ev, *offsets, *slots, *long_rows;
  int ne, nv, n_long, k, device;
};

// out: [2, E, K], the u-ends then the v-ends
template <typename T>
int banded_gather(const BandedPlan *p, const T *x, T *out, void *stream) {
  if (p->ne < 1 || p->k < 1) return -1;
  return on_device(p->device, [&] {
    const int64_t n = (int64_t)p->ne * p->k;
    banded_gather_kernel<T><<<grid_for(n), kBandedBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, p->eu, p->ev, out, out + n, n, p->k);
    return cudaGetLastError();
  });
}

template <typename T>
int banded_scatter(const BandedPlan *p, const T *vu, const T *vv, T *out,
                   void *stream) {
  if (p->nv < 1 || p->ne < 0 || p->k < 1 || p->n_long < 0 || p->k > 65535)
    return -1;
  return on_device(p->device, [&] {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    banded_scatter_rows_kernel<T><<<grid_for((int64_t)p->nv * p->k),
                                    kBandedBlock, 0, s>>>(
        vu, vv, p->offsets, p->slots, out, p->nv, p->ne, p->k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || p->n_long == 0) return err;
    banded_scatter_long_kernel<T><<<dim3(p->n_long, p->k), kBandedBlock, 0,
                                    s>>>(vu, vv, p->offsets, p->slots,
                                         p->long_rows, out, p->ne, p->k);
    return cudaGetLastError();
  });
}

}  // namespace cp_pfdr

extern "C" {

int cp_banded_long_row() { return cp_pfdr::kLongRow; }

int cp_banded_plan_size() { return (int)sizeof(cp_pfdr::BandedPlan); }

#define CP_BANDED_ENTRY(SUFFIX, T)                                         \
  int cp_banded_gather_##SUFFIX(const cp_pfdr::BandedPlan *plan,           \
                                const T *x, T *out, void *stream) {        \
    return cp_pfdr::banded_gather<T>(plan, x, out, stream);                \
  }                                                                        \
  int cp_banded_scatter_##SUFFIX(const cp_pfdr::BandedPlan *plan,          \
                                 const T *vu, const T *vv, T *out,         \
                                 void *stream) {                           \
    return cp_pfdr::banded_scatter<T>(plan, vu, vv, out, stream);          \
  }

CP_BANDED_ENTRY(f32, float)
CP_BANDED_ENTRY(f64, double)

#undef CP_BANDED_ENTRY
}
