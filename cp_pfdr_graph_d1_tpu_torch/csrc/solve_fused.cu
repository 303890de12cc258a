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
// Design.  The TPU kernel keeps all of its state in VMEM for the whole
// solve.  Here the card's aggregate shared memory plays that part: one
// persistent block per SM, each owning a contiguous slice [v0, v1) of the
// vertices (ops/solve_fused.py:partition balances slots and vertices), holds
// its vertices' iterate and forward values and its slice of the dense
// operator A[:, v0:v1] in shared memory for the whole solve (what does not
// fit is read from global memory: the iterate from its current buffer, the
// forward values from p, the operator from L2, so any size launches).  The
// product r = A x is split over the blocks: right after a block writes its
// new iterate it adds A[:, v0:v1] x[v0:v1] into one partial per row,
// beside its two evolution partials; after the barrier every block adds
// the partials of each row in the same fixed order (a warp per row: lanes
// over the blocks, then a fixed shuffle tree), so every block holds the
// same r and the same stopping decision, and A^t r for its own columns
// comes from its slice of the operator.  No float
// atomics: two runs give the same bits.
//
// An iteration has two grid barriers: (a) the forward step p of the
// block's vertices; (b) for every slot of the block's incidence list (CSR,
// slot-parallel), the pair prox of its edge recomputed from the old z and
// the p and x of both ends (both ends of an edge call the same function on
// the same values, so they agree bit for bit), the edge's owner (the block
// of its smaller endpoint) writing the new z; then the vertex sums (a
// thread per vertex, a warp per hub vertex of more than kHubRow slots), the
// vertex prox and the partials.  x and z are double-buffered, so no block
// reads a value another block is overwriting.
//
// Bound.  Per iteration the dense operator is read twice (2 N V
// multiply-adds) and every slot does one pair prox (about 30 operations);
// on the 19,600-vertex mesh with N = 91 that is 3.6 M multiply-adds and
// 3.5 M slot operations, 0.13 us at the card's float32 rate, far below the
// two grid barriers and the dependent loads of a slot's pair prox (its
// edge's z and the other end's p and x from L2), which bound it.  PERF.md
// holds the measured times.
#include <cooperative_groups.h>

#include <cstdint>

#include "pfdr_common.cuh"

namespace cg = cooperative_groups;

namespace cp_pfdr {

constexpr int kSolveThreads = 512;
constexpr int kSolveWarps = kSolveThreads / 32;
// rows of more slots than this are summed by a warp
constexpr int kHubRow = 32;
// bit of an incidence entry marking the slot that writes its edge's z
constexpr unsigned kWriterBit = 0x80000000u;
enum SolveOpKind { kSolveDense = 0, kSolveGram = 1, kSolveDiag = 2 };

// dynamic shared memory of a block (must match ops/solve_fused.smem_bytes):
// the row sums (n_rows + 2), the reduction scratch (64), the block's
// iterate and forward values (nb_max each, when in shared memory), the
// operator's slice (n_rows x nb_max, when in shared memory) and the slot
// contributions (slot_cap, when in shared memory)
inline size_t solve_smem_bytes(int itemsize, int n_rows, int nb_max,
                               int xs_in_smem, int op_in_smem,
                               int slot_cap) {
  size_t n = (size_t)(n_rows + 2) + 64;
  if (xs_in_smem) n += 2 * (size_t)nb_max;
  if (op_in_smem) n += (size_t)n_rows * nb_max;
  n += (size_t)slot_cap;
  return n * itemsize;
}

template <typename T>
struct SolveArgs {
  const T *op, *aty, *ga, *th_l1, *x0, *z0, *ec;
  // per block: first vertex (vstart[G + 1]) and hub rows (hub_off[G + 1]
  // into hubs); per incidence entry k: the slot (edge s < E as u-end, E + s
  // as v-end) with kWriterBit where it writes the edge, the other endpoint
  // and the own endpoint's index inside its block
  const int *vstart, *hub_off, *hubs, *inc_off, *inc_slot, *inc_other,
      *inc_self;
  T *xb[2], *zb[2];  // [0]: the outputs; [1]: the second buffers
  T *p, *partials, *wzs, *dif_out;
  int *it_out;
  int op_kind, n_rows, rv_cap, ne, rv, it_max, vkind, positivity;
  int nb_max, xs_in_smem, op_in_smem, slots_in_smem;
  T rho, lo, hi, dif_tol2, eps;
};

// r and the evolution sums: row q of the [rows, G] partials, added in the
// same order by every block (lane l the blocks l, l + 32, ..., then a fixed
// shuffle tree); the sums land in shared memory
template <typename T>
__device__ __forceinline__ void sum_partials(const T *partials, int rows,
                                             T *sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = gridDim.x;
  for (int q = warp; q < rows; q += kSolveWarps) {
    T acc = T(0);
    for (int b = lane; b < g; b += 32) acc += __ldcg(&partials[q * g + b]);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) sums[q] = acc;
  }
}

// the block's share of r = A x: row n of A[:, v0:v1] x[v0:v1] into
// partials[n G + b] (a warp per row, lanes over the columns, fixed tree)
template <typename T>
__device__ __forceinline__ void product_partials(const T *acol, int64_t lda,
                                                 const T *xs, int nb,
                                                 int n_rows, T *partials) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < n_rows; n += kSolveWarps) {
    T acc = T(0);
    for (int j = lane; j < nb; j += 32) acc += acol[n * lda + j] * xs[j];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) partials[n * gridDim.x + blockIdx.x] = acc;
  }
}

// the contribution of incidence entry k to its vertex (wu zu at a u-end, wv
// zv at a v-end) from the pair prox of its edge; the writer stores the new
// pair.  ps/xs: the block's forward values and iterate; p/xc: everyone's.
template <typename T>
__device__ __forceinline__ T slot_term(const SolveArgs<T> &a, int k,
                                       const T *ps, const T *xs, const T *zc,
                                       T *zn, const T *xc) {
  const unsigned code = static_cast<unsigned>(__ldg(&a.inc_slot[k]));
  const int s = static_cast<int>(code & ~kWriterBit);
  const int w = __ldg(&a.inc_other[k]);
  const int me = __ldg(&a.inc_self[k]);
  const int ne = a.ne;
  const bool at_v = s >= ne;
  const int e = at_v ? s - ne : s;
  const T pm = ps[me], xm = xs[me];
  const T pw = __ldcg(&a.p[w]), xw = __ldcg(&xc[w]);
  const T zu = __ldcg(&zc[e]), zv = __ldcg(&zc[ne + e]);
  const T wdu = __ldg(&a.ec[2 * ne + e]), wdv = __ldg(&a.ec[3 * ne + e]);
  const T th = __ldg(&a.ec[4 * ne + e]);
  T zun, zvn;
  if (at_v)
    pair_prox_relax(pw, pm, zu, zv, xw, xm, wdu, wdv, th, a.rho, zun, zvn);
  else
    pair_prox_relax(pm, pw, zu, zv, xm, xw, wdu, wdv, th, a.rho, zun, zvn);
  if (code & kWriterBit) {
    zn[e] = zun;
    zn[ne + e] = zvn;
  }
  return at_v ? __ldg(&a.ec[ne + e]) * zvn : __ldg(&a.ec[e]) * zun;
}

// end of an iteration at the block's vertex j (global v): the vertex prox
// of acc, zero beyond rv, the new iterate into xn[v] (and into xs[j] when
// xs is in shared memory; else xs is the current buffer, read only), and
// the two evolution terms
template <typename T>
__device__ __forceinline__ void vertex_end(const SolveArgs<T> &a, int j,
                                           int v, T acc, T *xs, T *xn,
                                           T &num, T &den) {
  T x = vertex_prox(acc, __ldg(&a.th_l1[v]), a.vkind, a.positivity, a.lo,
                    a.hi);
  if (v >= a.rv) x = T(0);
  const T d = x - xs[j];
  num += d * d;
  den += x * x;
  if (a.xs_in_smem) xs[j] = x;
  xn[v] = x;
}

template <typename T>
__global__ void __launch_bounds__(kSolveThreads, 1)
solve_fused_kernel(SolveArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *smem = reinterpret_cast<T *>(smem_raw);
  const int b = blockIdx.x, g = gridDim.x;
  const int v0 = a.vstart[b], nb = a.vstart[b + 1] - v0;
  const int k0 = a.inc_off[v0], nk = a.inc_off[v0 + nb] - k0;
  const int h0 = a.hub_off[b], h1 = a.hub_off[b + 1];
  const int n_rows = a.n_rows, rows = n_rows + 2, ne = a.ne;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // shared memory: row sums, scratch, iterate, forward values, operator
  // slice, slot contributions (solve_smem_bytes); the iterate and forward
  // values not in shared memory are read where they are written (the
  // block's own slice of the x buffers and of p, so plain loads see them
  // after the block's barriers)
  const bool xs_in = a.xs_in_smem;
  T *sums = smem;
  T *scratch = sums + rows;
  T *xsh = scratch + 64;
  T *ps = xs_in ? xsh + a.nb_max : a.p + v0;
  T *as = xsh + (xs_in ? 2 * a.nb_max : 0);
  T *buf = as + (a.op_in_smem ? (int64_t)n_rows * a.nb_max : 0);
  if (!a.slots_in_smem) buf = a.wzs + k0;
  const T *acol = a.op_in_smem ? as : a.op + v0;
  const int64_t lda = a.op_in_smem ? a.nb_max : a.rv_cap;

  // set-up: the operator's slice, the block's iterate, z0 into z buffer 0,
  // r's partials of x0
  if (a.op_kind == kSolveDense && a.op_in_smem)
    for (int64_t q = threadIdx.x; q < (int64_t)n_rows * nb;
         q += kSolveThreads) {
      const int n = static_cast<int>(q / nb), j = static_cast<int>(q % nb);
      as[n * lda + j] = __ldg(&a.op[(int64_t)n * a.rv_cap + v0 + j]);
    }
  for (int j = threadIdx.x; j < nb; j += kSolveThreads) {
    const T x = a.x0[v0 + j];
    if (xs_in) xsh[j] = x;
    a.xb[0][v0 + j] = x;
  }
  for (int s = b * kSolveThreads + threadIdx.x; s < 2 * ne;
       s += g * kSolveThreads)
    a.zb[0][s] = a.z0[s];
  __syncthreads();
  if (a.op_kind == kSolveDense)
    product_partials(acol, lda, xs_in ? xsh : a.xb[0] + v0, nb, n_rows,
                     a.partials);
  grid.sync();

  int it = 0, par = 0;
  T dif = a.dif_tol2 > T(1) ? a.dif_tol2 : T(1);
  while (true) {
    // (a) the row sums, the stopping test, the gradient and forward step of
    // the block's vertices (reference :356-464)
    sum_partials(a.partials, rows, sums);
    __syncthreads();
    if (it > 0) {
      const T sn = sums[n_rows], sd = sums[n_rows + 1];
      dif = sd > a.eps ? sn / sd : sn / a.eps;
    }
    if (!(it < a.it_max && dif >= a.dif_tol2)) break;
    const T *xc = a.xb[par];
    T *xs = xs_in ? xsh : a.xb[par] + v0;
    for (int j = threadIdx.x; j < nb; j += kSolveThreads) {
      const int v = v0 + j;
      T gr = T(0);
      if (a.op_kind == kSolveDense) {
        for (int n = 0; n < n_rows; ++n) gr += sums[n] * acol[n * lda + j];
      } else if (a.op_kind == kSolveGram) {
        for (int k = 0; k < a.rv_cap; ++k)
          gr += __ldcg(&xc[k]) * __ldg(&a.op[(int64_t)k * a.rv_cap + v]);
      } else {
        gr = __ldg(&a.op[v]) * xs[j];
      }
      const T pv = forward_value(xs[j], __ldg(&a.ga[v]),
                                 gr - __ldg(&a.aty[v]));
      if (xs_in) ps[j] = pv;
      a.p[v] = pv;
    }
    grid.sync();
    // (b) the pair prox of every slot's edge (:466-489), the edge -> vertex
    // sums (:491-497), the vertex prox (:499-512), the partials
    const int nxt = par ^ 1;
    T *xn = a.xb[nxt];
    for (int k = threadIdx.x; k < nk; k += kSolveThreads)
      buf[k] = slot_term(a, k0 + k, ps, xs, a.zb[par], a.zb[nxt], xc);
    __syncthreads();
    T num = T(0), den = T(0);
    for (int j = threadIdx.x; j < nb; j += kSolveThreads) {
      const int beg = __ldg(&a.inc_off[v0 + j]) - k0;
      const int end = __ldg(&a.inc_off[v0 + j + 1]) - k0;
      if (end - beg > kHubRow) continue;
      T acc = T(0);
      for (int k = beg; k < end; ++k) acc += buf[k];
      vertex_end(a, j, v0 + j, acc, xs, xn, num, den);
    }
    for (int h = h0 + warp; h < h1; h += kSolveWarps) {
      const int v = __ldg(&a.hubs[h]);
      const int beg = __ldg(&a.inc_off[v]) - k0;
      const int end = __ldg(&a.inc_off[v + 1]) - k0;
      T acc = T(0);
      for (int k = beg + lane; k < end; k += 32) acc += buf[k];
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) vertex_end(a, v - v0, v, acc, xs, xn, num, den);
    }
    block_sum2(num, den, scratch);  // ends with __syncthreads: xs complete
    if (threadIdx.x == 0) {
      a.partials[n_rows * g + b] = num;
      a.partials[(n_rows + 1) * g + b] = den;
    }
    if (a.op_kind == kSolveDense)
      product_partials(acol, lda, xs_in ? xsh : xn + v0, nb, n_rows,
                       a.partials);
    par = nxt;
    ++it;
    grid.sync();
  }
  // the last iterate into the outputs (buffer 0)
  if (par != 0) {
    for (int j = threadIdx.x; j < nb; j += kSolveThreads)
      a.xb[0][v0 + j] = xs_in ? xsh[j] : a.xb[1][v0 + j];
    for (int s = b * kSolveThreads + threadIdx.x; s < 2 * ne;
         s += g * kSolveThreads)
      a.zb[0][s] = __ldcg(&a.zb[1][s]);
  }
  if (b == 0 && threadIdx.x == 0) {
    *a.it_out = it;
    *a.dif_out = dif;
  }
}

template <typename T>
int solve_fused(const T *op, const T *aty, const T *ga, const T *th_l1,
                const T *x0, const T *z0, const T *ec, const int *index,
                const int *dims, const double *consts, T *x, T *z,
                T *scratch, int *it_out, T *dif_out, void *stream) {
  // dims: op_kind, n_rows, rv_cap, ne, rv, it_max, vkind, positivity,
  // grid, nb_max, n_hubs, op_in_smem, slots_in_smem, slot_cap, device,
  // xs_in_smem
  const int op_kind = dims[0], grid_n = dims[8];
  if (op_kind < kSolveDense || op_kind > kSolveDiag || dims[2] < 1 ||
      dims[3] < 1 || grid_n < 1 || dims[9] < 0)
    return -1;
  SolveArgs<T> a;
  a.op = op;
  a.aty = aty;
  a.ga = ga;
  a.th_l1 = th_l1;
  a.x0 = x0;
  a.z0 = z0;
  a.ec = ec;
  a.op_kind = op_kind;
  a.n_rows = op_kind == kSolveDense ? dims[1] : 0;
  a.rv_cap = dims[2];
  a.ne = dims[3];
  a.rv = dims[4];
  a.it_max = dims[5];
  a.vkind = dims[6];
  a.positivity = dims[7];
  a.nb_max = dims[9];
  a.xs_in_smem = dims[15];
  a.op_in_smem = op_kind == kSolveDense && dims[11];
  a.slots_in_smem = dims[12];
  // index: vstart [G + 1], hub_off [G + 1], hubs [n_hubs], inc_off
  // [rv_cap + 1], inc_slot, inc_other, inc_self [2E] each
  a.vstart = index;
  a.hub_off = a.vstart + grid_n + 1;
  a.hubs = a.hub_off + grid_n + 1;
  a.inc_off = a.hubs + dims[10];
  a.inc_slot = a.inc_off + a.rv_cap + 1;
  a.inc_other = a.inc_slot + 2 * a.ne;
  a.inc_self = a.inc_other + 2 * a.ne;
  // scratch: x buffer 1 [rv_cap], z buffer 1 [2E], p [rv_cap], partials
  // [(n_rows + 2) G], slot contributions [2E]
  a.xb[0] = x;
  a.zb[0] = z;
  a.xb[1] = scratch;
  a.zb[1] = a.xb[1] + a.rv_cap;
  a.p = a.zb[1] + 2 * a.ne;
  a.partials = a.p + a.rv_cap;
  a.wzs = a.partials + (int64_t)(a.n_rows + 2) * grid_n;
  a.it_out = it_out;
  a.dif_out = dif_out;
  a.rho = T(consts[0]);
  a.lo = T(consts[1]);
  a.hi = T(consts[2]);
  a.dif_tol2 = T(consts[3]);
  a.eps = T(consts[4]);
  const size_t smem = solve_smem_bytes(
      sizeof(T), a.n_rows, a.nb_max, a.xs_in_smem, a.op_in_smem,
      a.slots_in_smem ? dims[13] : 0);
  return on_device(dims[14], [&] {
    auto kernel = solve_fused_kernel<T>;
    int sms = 0, per_sm = 0, coop = 0, dev = dims[14];
    cudaError_t err =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(reinterpret_cast<const void *>(kernel),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void *>(kernel), kSolveThreads,
          smem);
    if (err != cudaSuccess) return err;
    if (!coop || (int64_t)per_sm * sms < grid_n)
      return cudaErrorCooperativeLaunchTooLarge;
    void *args[] = {&a};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void *>(kernel), dim3(grid_n),
        dim3(kSolveThreads), args, smem, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace cp_pfdr

extern "C" {

size_t cp_solve_fused_smem_bytes(int itemsize, int n_rows, int nb_max,
                                 int xs_in_smem, int op_in_smem,
                                 int slot_cap) {
  return cp_pfdr::solve_smem_bytes(itemsize, n_rows, nb_max, xs_in_smem,
                                   op_in_smem, slot_cap);
}

// (block threads, hub row threshold)
void cp_solve_fused_shape(int *out) {
  out[0] = cp_pfdr::kSolveThreads;
  out[1] = cp_pfdr::kHubRow;
}

#define CP_SOLVE_FUSED_ENTRY(NAME, T)                                        \
  int NAME(const T *op, const T *aty, const T *ga, const T *th_l1,           \
           const T *x0, const T *z0, const T *ec, const int *index,          \
           const int *dims, const double *consts, T *x, T *z, T *scratch,    \
           int *it_out, T *dif_out, void *stream) {                          \
    return cp_pfdr::solve_fused<T>(op, aty, ga, th_l1, x0, z0, ec, index,    \
                                   dims, consts, x, z, scratch, it_out,      \
                                   dif_out, stream);                         \
  }

CP_SOLVE_FUSED_ENTRY(cp_solve_fused_f32, float)
CP_SOLVE_FUSED_ENTRY(cp_solve_fused_f64, double)

#undef CP_SOLVE_FUSED_ENTRY
}
