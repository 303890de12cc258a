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
// Hopper loads from any address.  The gather gives a thread one edge and
// all K columns of both its endpoints (a vector load and store a column
// chunk where K and the alignment allow), or at K = 1 four consecutive
// edges, their endpoints read with one 16-byte load each of eu and ev (a
// thread of the ragged end reads them one by one).
//
// The scatter must not use float atomics: their order changes from run to
// run, and so would a PFDR solve's iteration count.  It walks each vertex's
// incidence list (CSR offsets and endpoint slots, slot s < E the u-end of
// edge s, E + s its v-end, sorted by slot within each vertex) with
// banded_fused's layout: L lanes a vertex (L a power of two from the mean
// slot count, chosen once per graph on the host: 8 on the mesh), lane j
// summing the slots beg + j, beg + j + L, ... in order (two a round, their
// loads issued together), a fixed shuffle tree adding the lanes, so the
// dependent loads of one row (offset -> slot -> value) run side by side.
// A lane sums every column of its slots in one pass (up to kScatterCols
// columns, then the next chunk), with vector loads where K and the
// alignment allow.  Rows of more than kLongRow slots (a hub component of a
// contracted cut-pursuit graph; the endpoints of the container's last
// edge, which its padding copies) are skipped by the tiles and taken by
// blocks of the same grid past them, one a (segment of at most 1,024 slots
// of a long row, column; the host lists each segment's vertex and slot
// range, so a block reads its range in one load): each thread a
// contiguous run of the segment's slots in order, then a fixed shuffle
// tree over the block.  A row of one segment is written by its block; the
// segments of a longer row leave their sums, and the last of them to
// finish (an integer ticket a row and column, reset by that block) adds
// them in segment order.  One launch on every graph, and the same sum in
// every run.  Measured and dropped (PERF.md): one block a whole long row
// (serial in its latency: 2.4 us more than the tiles on a 4,096-slot hub,
// 17 us on a 16,384-slot one), segments of 256, 512 or 2,048 slots, runs
// strided over the block, 16 lanes a vertex on the mesh (4 lanes: within
// 0.03 us of the shared launch shape's 8).
//
// Bound.  Both functions move bytes and do almost no arithmetic: the gather
// reads E (2 indices) and writes 2 E K values, the scatter reads 2 E K
// values and the 2 E slots plus V + 1 offsets and writes V K values.  At
// the mesh scale (E = 59,392 padded edges, V = 19,600, float32) that is
// about 0.7 MB, a fraction of a microsecond at 3.35 TB/s, so the launches
// are latency-bound; PERF.md holds the measured times beside an empty
// kernel's, torch.index_select's and index_add_'s.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kBandedBlock = 256;  // scatter block: BLOCK in ops/banded.py
constexpr int kMaxScatterLanes = 32;  // MAX_LANES in ops/banded.py
constexpr int kScatterCols = 8;       // columns a lane sums in one pass
constexpr int kGatherBlock = 128;
constexpr int kGatherEdges = 4;       // edges a gather thread takes at K = 1

// What a launch needs of a graph and a field shape, prepared once per
// (graph, dtype, shape, device) by the wrapper: the device index arrays,
// their sizes and, for the scatter, the lanes per vertex, the vertex tiles
// and the long rows' segments (ops/banded.py:launch_shape,
// long_segments) with their partial sums and tickets.  A launch then
// marshals four or five arguments.
struct BandedPlan {
  const int *eu, *ev, *offsets, *slots;
  const int *segs;      // [n_seg, 4]: vertex, first and end slot, long row
  const int *long_seg;  // [n_long + 1] first segment of each long row
  void *partials;       // [n_seg K] segment sums
  int *tickets;         // [n_long K], 0 between launches
  int ne, nv, n_long, n_seg, k, lanes, tiles, device;
};

// V values of T moved by one load or store
template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 1> { using type = float; };
template <>
struct Vec<float, 2> { using type = float2; };
template <>
struct Vec<float, 4> { using type = float4; };
template <>
struct Vec<double, 1> { using type = double; };
template <>
struct Vec<double, 2> { using type = double2; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T *p, T *out) {
  using VT = typename Vec<T, V>::type;
  const VT q = __ldg(reinterpret_cast<const VT *>(p));
  const T *e = reinterpret_cast<const T *>(&q);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = e[i];
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T *p, const T *in) {
  using VT = typename Vec<T, V>::type;
  VT q;
  T *e = reinterpret_cast<T *>(&q);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = in[i];
  *reinterpret_cast<VT *>(p) = q;
}

// K = 1: four consecutive edges a thread; eu and ev are read 16 bytes at a
// time, the outputs written so where VST (both rows 16-byte aligned)
template <typename T, bool VST>
__global__ void __launch_bounds__(kGatherBlock)
banded_gather1_kernel(const T *__restrict__ x, const int *__restrict__ eu,
                      const int *__restrict__ ev, T *__restrict__ ou,
                      T *__restrict__ ov, int ne) {
  const int64_t e0 =
      ((int64_t)blockIdx.x * kGatherBlock + threadIdx.x) * kGatherEdges;
  if (e0 >= ne) return;
  if (e0 + kGatherEdges > ne) {  // the ragged end
    for (int64_t e = e0; e < ne; ++e) {
      ou[e] = __ldg(&x[__ldg(&eu[e])]);
      ov[e] = __ldg(&x[__ldg(&ev[e])]);
    }
    return;
  }
  const int4 a = __ldg(reinterpret_cast<const int4 *>(eu + e0));
  const int4 b = __ldg(reinterpret_cast<const int4 *>(ev + e0));
  const T u[kGatherEdges] = {__ldg(&x[a.x]), __ldg(&x[a.y]), __ldg(&x[a.z]),
                             __ldg(&x[a.w])};
  const T v[kGatherEdges] = {__ldg(&x[b.x]), __ldg(&x[b.y]), __ldg(&x[b.z]),
                             __ldg(&x[b.w])};
  if constexpr (VST) {
    constexpr int kV = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kGatherEdges; i += kV) {
      store_vec<T, kV>(ou + e0 + i, u + i);
      store_vec<T, kV>(ov + e0 + i, v + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kGatherEdges; ++i) {
      ou[e0 + i] = u[i];
      ov[e0 + i] = v[i];
    }
  }
}

// K > 1: one edge a thread, its endpoints' K columns V at a time
template <typename T, int V>
__global__ void __launch_bounds__(kGatherBlock)
banded_gatherk_kernel(const T *__restrict__ x, const int *__restrict__ eu,
                      const int *__restrict__ ev, T *__restrict__ ou,
                      T *__restrict__ ov, int ne, int k) {
  const int e = blockIdx.x * kGatherBlock + threadIdx.x;
  if (e >= ne) return;
  const T *xu = x + (int64_t)__ldg(&eu[e]) * k;
  const T *xv = x + (int64_t)__ldg(&ev[e]) * k;
  T *du = ou + (int64_t)e * k;
  T *dv = ov + (int64_t)e * k;
  for (int c = 0; c < k; c += V) {
    T u[V], v[V];
    load_vec<T, V>(xu + c, u);
    load_vec<T, V>(xv + c, v);
    store_vec<T, V>(du + c, u);
    store_vec<T, V>(dv + c, v);
  }
}

// Blocks [0, tiles): L lanes per vertex of at most kLongRow slots, W
// columns a pass (W = 1 at K = 1), loads of V values.  Blocks
// [tiles, tiles + n_seg K): one (long-row segment, column) each.
template <typename T, int V, int W>
__global__ void __launch_bounds__(kBandedBlock)
banded_scatter_kernel(const T *__restrict__ vu, const T *__restrict__ vv,
                      T *__restrict__ out, const BandedPlan p) {
  __shared__ T scratch[64];
  const int *__restrict__ offsets = p.offsets;
  const int *__restrict__ slots = p.slots;
  const int nv = p.nv, ne = p.ne, k = p.k, lanes = p.lanes;
  if (static_cast<int>(blockIdx.x) < p.tiles) {
    const int shift = __ffs(lanes) - 1;
    const int j = threadIdx.x & (lanes - 1);
    const int v =
        blockIdx.x * (kBandedBlock >> shift) + (threadIdx.x >> shift);
    int beg = 0, end = 0;
    bool live = false;
    if (v < nv) {
      beg = __ldg(&offsets[v]);
      end = __ldg(&offsets[v + 1]);
      live = end - beg <= kLongRow;
      if (!live) end = beg;
    }
    for (int c0 = 0; c0 < k; c0 += W) {
      const int w = min(W, k - c0);
      T acc[W];
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = T(0);
      // two of the lane's slots a round, both loads issued before either
      // add (the second's index clamped into the row), added in order
      for (int s = beg + j; s < end; s += 2 * lanes) {
        const int s2 = s + lanes;
        const int sa = __ldg(&slots[s]);
        const int sb = __ldg(&slots[min(s2, end - 1)]);
        const T *ra = (sa < ne ? vu + (int64_t)sa * k
                               : vv + (int64_t)(sa - ne) * k) + c0;
        const T *rb = (sb < ne ? vu + (int64_t)sb * k
                               : vv + (int64_t)(sb - ne) * k) + c0;
#pragma unroll
        for (int i = 0; i < W; i += V) {
          if (i < w) {
            T qa[V], qb[V];
            load_vec<T, V>(ra + i, qa);
            load_vec<T, V>(rb + i, qb);
#pragma unroll
            for (int m = 0; m < V; ++m) acc[i + m] += qa[m];
            if (s2 < end) {
#pragma unroll
              for (int m = 0; m < V; ++m) acc[i + m] += qb[m];
            }
          }
        }
      }
      // the lanes' sums, in a fixed tree inside each vertex's L lanes
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (i < w) {
          for (int off = lanes >> 1; off > 0; off >>= 1)
            acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off, lanes);
        }
      }
      if (live && j == 0) {
        T *dst = out + (int64_t)v * k + c0;
#pragma unroll
        for (int i = 0; i < W; i += V)
          if (i < w) store_vec<T, V>(dst + i, acc + i);
      }
    }
  } else {
    const int b = blockIdx.x - p.tiles;
    const int sg = b / k;
    const int c = b - sg * k;
    const int4 q = __ldg(reinterpret_cast<const int4 *>(p.segs) + sg);
    const int first = __ldg(&p.long_seg[q.w]);
    const int nseg = __ldg(&p.long_seg[q.w + 1]) - first;
    int lo, hi;
    long_row_run(q.y, q.z, lo, hi);
    T acc = T(0), unused = T(0);
    // four slots of the run a round: every load issued at once (indices
    // clamped into the run), then added in slot order
    constexpr int U = 4;
    for (int s0 = lo; s0 < hi; s0 += U) {
      T val[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int sl = __ldg(&slots[min(s0 + u, hi - 1)]);
        val[u] = sl < ne ? __ldg(&vu[(int64_t)sl * k + c])
                         : __ldg(&vv[(int64_t)(sl - ne) * k + c]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s0 + u < hi) acc += val[u];
    }
    block_sum2(acc, unused, scratch);
    if (threadIdx.x != 0) return;
    T *dst = out + (int64_t)q.x * k + c;
    if (nseg == 1) {
      *dst = acc;
      return;
    }
    // leave the segment's sum; the last segment of the row and column to
    // finish adds them in segment order (the acquire-release ticket makes
    // the others' sums visible to it) and resets the ticket
    T *partials = static_cast<T *>(p.partials);
    partials[(int64_t)sg * k + c] = acc;
    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(
        p.tickets[q.w * k + c]);
    if (ticket.fetch_add(1, cuda::memory_order_acq_rel) != nseg - 1) return;
    T sum = T(0);
    for (int g = first; g < first + nseg; ++g)
      sum += __ldcg(&partials[(int64_t)g * k + c]);
    *dst = sum;
    ticket.store(0, cuda::memory_order_relaxed);
  }
}

// vertex tiles of a scatter: kBandedBlock / lanes vertices each
inline int scatter_tiles(int nv, int lanes) {
  const int per = kBandedBlock / lanes;
  return (nv + per - 1) / per;
}

inline bool aligned(const void *p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// values of T a load takes: the widest of 16, 8 or sizeof(T) bytes that
// divides a row of k values and to which every pointer is aligned
template <typename T>
inline int vector_width(int k, const void *a, const void *b, const void *c) {
  for (int v = 16 / (int)sizeof(T); v > 1; v /= 2) {
    const int bytes = v * (int)sizeof(T);
    if (k % v == 0 && aligned(a, bytes) && aligned(b, bytes) &&
        aligned(c, bytes))
      return v;
  }
  return 1;
}

// out: [2, E, K], the u-ends then the v-ends.  eu and ev must be 16-byte
// aligned (the wrapper's index arrays are allocations of their own).
template <typename T>
int banded_gather(const BandedPlan *p, const T *x, T *out, void *stream) {
  if (p->ne < 1 || p->k < 1 || !aligned(p->eu, 16) || !aligned(p->ev, 16))
    return -1;
  return on_device(p->device, [&] {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int ne = p->ne, k = p->k;
    T *ov = out + (int64_t)ne * k;
    if (k == 1) {
      const int threads = (ne + kGatherEdges - 1) / kGatherEdges;
      const int blocks = (threads + kGatherBlock - 1) / kGatherBlock;
      if (aligned(out, 16) && aligned(ov, 16))
        banded_gather1_kernel<T, true><<<blocks, kGatherBlock, 0, s>>>(
            x, p->eu, p->ev, out, ov, ne);
      else
        banded_gather1_kernel<T, false><<<blocks, kGatherBlock, 0, s>>>(
            x, p->eu, p->ev, out, ov, ne);
      return cudaGetLastError();
    }
    const int blocks = (ne + kGatherBlock - 1) / kGatherBlock;
    switch (vector_width<T>(k, x, out, ov)) {
      case 4:
        if constexpr (sizeof(T) == 4) {
          banded_gatherk_kernel<T, 4><<<blocks, kGatherBlock, 0, s>>>(
              x, p->eu, p->ev, out, ov, ne, k);
          break;
        }
      case 2:
        banded_gatherk_kernel<T, 2><<<blocks, kGatherBlock, 0, s>>>(
            x, p->eu, p->ev, out, ov, ne, k);
        break;
      default:
        banded_gatherk_kernel<T, 1><<<blocks, kGatherBlock, 0, s>>>(
            x, p->eu, p->ev, out, ov, ne, k);
    }
    return cudaGetLastError();
  });
}

template <typename T>
int banded_scatter(const BandedPlan *p, const T *vu, const T *vv, T *out,
                   void *stream) {
  const int64_t grid = (int64_t)p->tiles + (int64_t)p->n_seg * p->k;
  if (p->nv < 1 || p->ne < 0 || p->k < 1 || p->n_long < 0 ||
      p->n_seg < p->n_long || p->lanes < 1 || p->lanes > kMaxScatterLanes ||
      (p->lanes & (p->lanes - 1)) != 0 ||
      p->tiles != scatter_tiles(p->nv, p->lanes) || grid > 0x7fffffff)
    return -1;
  return on_device(p->device, [&] {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 g(static_cast<unsigned>(grid));
#define CP_SCATTER(V, W) \
  banded_scatter_kernel<T, V, W><<<g, kBandedBlock, 0, s>>>(vu, vv, out, *p)
    if (p->k == 1) {
      CP_SCATTER(1, 1);
    } else {
      switch (vector_width<T>(p->k, vu, vv, out)) {
        case 4:
          if constexpr (sizeof(T) == 4) {
            CP_SCATTER(4, kScatterCols);
            break;
          }
        case 2:
          CP_SCATTER(2, kScatterCols);
          break;
        default:
          CP_SCATTER(1, kScatterCols);
      }
    }
#undef CP_SCATTER
    return cudaGetLastError();
  });
}

}  // namespace cp_pfdr

extern "C" {

int cp_banded_long_row() { return cp_pfdr::kLongRow; }

int cp_banded_plan_size() { return (int)sizeof(cp_pfdr::BandedPlan); }

// (scatter block threads, most lanes a vertex, vertex tiles of nv vertices
// at `lanes` lanes)
void cp_banded_launch_shape(int nv, int lanes, int *out) {
  out[0] = cp_pfdr::kBandedBlock;
  out[1] = cp_pfdr::kMaxScatterLanes;
  out[2] = cp_pfdr::scatter_tiles(nv, lanes);
}

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
