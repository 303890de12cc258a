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
// Two schedules, chosen by the wrapper (ops/solve_small.py:cluster_size).
//
// One block (C = 1, small problems and the diagonal operator): 1024
// threads run the whole solve, with __syncthreads between the phases of an
// iteration.  The TPU kernel gathers endpoints and scatters edges with a
// one-hot [rv_cap, 2e] matrix on the MXU; here x and the forward values p
// live in shared memory and the endpoints are indexed loads.  The edge ->
// vertex sum walks a per-vertex incidence list (CSR, built once by the
// wrapper) in a fixed order, and the evolution sums use a fixed shuffle
// tree: no atomics, so the iteration count does not change between runs.
// The operator, the auxiliary pairs z and the five edge constants stay in
// global memory (L2-resident).  One warp per row of A for r = A x and one
// thread per vertex for the second product, each reading coalesced rows.
//
// A thread-block cluster (C = 2..16 CTAs on neighbouring SMs, one per SM;
// dense and Gram operators):
// CTA c owns the vertices [c cs, (c + 1) cs) (cs = rv_cap / C), its slice of
// the operator (the dense A's columns, or the Gram matrix's rows) in its
// shared memory where it fits (else streamed from L2), its slice of x
// (double-buffered by the iteration's parity), of the forward values and
// of the vertex constants (Gamma, A^t y, l1 thresholds, incidence
// offsets), and the edges [c ne_c, (c + 1) ne_c).  A cluster barrier
// orders memory at cluster scope, so global reads after it miss L1: what a
// phase reads every iteration lives in shared memory where it is small.
// An iteration has three cluster
// barriers: (1) after each CTA's partial product over its slice (A's
// columns times its x for r = A x; its Gram rows times its x for g), whose
// C partials every CTA adds in rank order through distributed shared memory
// (map_shared_rank); (2) after the forward step of its own vertices; (3)
// after the edge phase, which reads the endpoints' x and forward values
// from the CTAs that own them through distributed shared memory (a replica
// of all of x and p that each CTA copies once an iteration measured
// slower, PERF.md) and writes w z to global memory in incidence order (the wrapper gives each endpoint slot its
// position in the list).  The vertex phase then sums each own vertex's
// contiguous run of terms through L2, the lanes that share a vertex (all
// threads busy when the slice is small) each a contiguous part of it,
// joined by a fixed shuffle tree.  The evolution sums go from each CTA's
// fixed shuffle tree to a fixed butterfly over the C CTAs' partials, read
// by one warp after the next barrier (1): every CTA stops at the same
// iteration with the same bits.
//
// Bound.  One SM (C = 1) does all the work, so a large reduced problem is
// bound by that SM's bandwidth to L2 (the operator is read twice an
// iteration) and by the barriers between phases; a small one by the
// barriers alone.  A cluster keeps the dense operator of every problem the
// route sends here in C SMs' shared memory (at rv_cap 4096 and N = 91,
// 1.49 MB in float32 over 16 CTAs), and is bound by its three cluster
// barriers and the latency of its distributed-shared-memory reads.
#include <cooperative_groups.h>

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

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
// bytes of incidence terms a thread of the cluster's vertex phase loads at
// once; rows of A a warp of its partial product takes at once
constexpr int kIncBatchBytes = 128;
constexpr int kRowsPerPass = 4;

// dynamic shared memory of one CTA of a cluster of c: x at two parities,
// the forward values, Gamma, A^t y and the l1 thresholds (cs each), the
// partial products and r (n_op each), the reduction scratch, the evolution
// partials and the cluster's ratio; the operator slice (n_op cs values)
// with op_in_smem; then the incidence offsets of the own vertices (cs + 1
// ints)
template <typename T>
size_t cluster_smem_bytes(int rv_cap, int n_op, int c, int op_in_smem) {
  const size_t cs = (rv_cap + c - 1) / c;
  size_t n = 6 * cs + 2 * (size_t)n_op + 64 + 3;
  if (op_in_smem) n += (size_t)n_op * cs;
  return sizeof(T) * n + sizeof(int) * (cs + 1);
}

// value of vertex i from the slice `local` (the same offset in every CTA)
// of the CTA that owns it
template <typename T>
__device__ __forceinline__ T owned_value(cg::cluster_group &cl,
                                         T *local, int i, int cs, int rank) {
  const int o = i / cs;
  const int li = i - o * cs;
  return o == rank ? local[li] : cl.map_shared_rank(local, o)[li];
}

// sum over the cluster's CTAs, in rank order, of element i of the array
// `local` (the same offset in every CTA); the C loads are issued together
template <typename T>
__device__ __forceinline__ T rank_sum(cg::cluster_group &cl, T *local, int i,
                                      int C) {
  T v[kMaxCluster];
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    v[c] = c < C ? cl.map_shared_rank(local, c)[i] : T(0);
  T acc = v[0];
#pragma unroll
  for (int c = 1; c < kMaxCluster; ++c)
    if (c < C) acc += v[c];
  return acc;
}

// the cluster schedule (file comment): CTA `rank` of C owns vertices
// [v0, v0 + nvl) and edges [e0, e0 + nel); the operator is dense or Gram
template <typename T>
__global__ void __launch_bounds__(kSmallThreads, 1)
solve_small_cluster_kernel(int op_kind, const T *__restrict__ op, int n_op,
                           int op_in_smem, const T *__restrict__ aty,
                           const T *__restrict__ ga,
                           const T *__restrict__ th_l1,
                           const T *__restrict__ x0, const T *__restrict__ z0,
                           const T *__restrict__ ec,
                           const int *__restrict__ eu,
                           const int *__restrict__ ev,
                           const int *__restrict__ inc_off,
                           const int *__restrict__ inc_pos, int rv_cap,
                           int ne, int rv, int it_max, T rho, int vkind,
                           int positivity, T lo, T hi, T dif_tol2, T eps,
                           T *__restrict__ xo, T *__restrict__ zo,
                           T *__restrict__ wz, int *__restrict__ it_out,
                           T *__restrict__ dif_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int cs = (rv_cap + C - 1) / C;
  const int v0 = rank * cs;
  const int nvl = max(0, min(cs, rv_cap - v0));
  const int ne_c = (ne + C - 1) / C;
  const int e0 = rank * ne_c;
  const int nel = max(0, min(ne_c, ne - e0));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *xs = reinterpret_cast<T *>(smem_raw);  // [2][cs] x by parity
  T *ps = xs + 2 * cs;                      // [cs] forward values
  T *sga = ps + cs;                         // [cs] Gamma
  T *saty = sga + cs;                       // [cs] A^t y
  T *sth = saty + cs;                       // [cs] l1 thresholds
  T *part = sth + cs;                       // [n_op] partial product
  T *rsum = part + n_op;                    // [n_op] r = A x (dense)
  T *scratch = rsum + n_op;                 // [64] reduction scratch
  T *difp = scratch + 64;                   // [3] evolution partials, dif
  T *ops = difp + 3;                        // operator slice (op_in_smem)
  // [cs + 1] incidence offsets of the own vertices
  int *soff = reinterpret_cast<int *>(ops + (op_in_smem ? (size_t)n_op * cs
                                                        : 0));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned full = 0xffffffffu;
  const T *wu = ec;
  const T *wv = ec + ne;
  const T *wdu = ec + 2 * ne;
  const T *wdv = ec + 3 * ne;
  const T *thd = ec + 4 * ne;
  T *zu = zo;
  T *zv = zo + ne;
  const bool dense = op_kind == kOpDense;
  // lanes that share a vertex of the vertex phase: a power of two, all
  // kSmallThreads threads busy when the slice is small
  int tpv = 1;
  while (tpv < 32 && 2 * tpv * cs <= kSmallThreads) tpv *= 2;
  const int sub = lane & (tpv - 1);
  // r = A x over the own columns (dense; element (n, jj) of the slice at
  // base[n stride + col0 + jj]): a warp takes kRowsPerPass rows at once,
  // each summed lane-strided, then by a fixed shuffle tree
  auto dense_partial = [&](const T *base, int64_t stride, int col0,
                           const T *xc) {
    constexpr int kWarps = kSmallThreads / 32;
    for (int n0 = warp; n0 < n_op; n0 += kRowsPerPass * kWarps) {
      T acc[kRowsPerPass];
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) acc[r] = T(0);
      for (int jj = lane; jj < nvl; jj += 32) {
        const T xv = xc[jj];
#pragma unroll
        for (int r = 0; r < kRowsPerPass; ++r)
          if (n0 + r * kWarps < n_op)
            acc[r] += base[(n0 + r * kWarps) * stride + col0 + jj] * xv;
      }
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRowsPerPass; ++r)
          acc[r] += __shfl_down_sync(full, acc[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerPass; ++r)
          if (n0 + r * kWarps < n_op) part[n0 + r * kWarps] = acc[r];
      }
    }
  };
  // partial g over the own Gram rows (row kk at base[kk stride + j])
  auto gram_partial = [&](const T *base, int64_t stride, const T *xc) {
    for (int j = tid; j < rv_cap; j += kSmallThreads) {
      T acc = T(0);
      for (int kk = 0; kk < nvl; ++kk) acc += xc[kk] * base[kk * stride + j];
      part[j] = acc;
    }
  };
  // A^t r over the own columns
  auto dense_grad = [&](const T *base, int64_t stride, int col0, int jj) {
    T g = T(0);
    for (int n = 0; n < n_op; ++n) g += rsum[n] * base[n * stride + col0 + jj];
    return g;
  };

  // the own slices of x, z, the vertex constants and the operator
  for (int jj = tid; jj < nvl; jj += kSmallThreads) {
    xs[jj] = x0[v0 + jj];
    sga[jj] = ga[v0 + jj];
    saty[jj] = aty[v0 + jj];
    sth[jj] = th_l1[v0 + jj];
  }
  for (int jj = tid; jj <= nvl; jj += kSmallThreads)
    soff[jj] = inc_off[v0 + jj];
  for (int s = tid; s < nel; s += kSmallThreads) {
    zu[e0 + s] = z0[e0 + s];
    zv[e0 + s] = z0[ne + e0 + s];
  }
  if (op_in_smem) {
    const int64_t n_vals = (int64_t)n_op * cs;
    for (int64_t i = tid; i < n_vals; i += kSmallThreads) {
      if (dense) {
        const int n = static_cast<int>(i / cs), jj = static_cast<int>(i % cs);
        ops[i] = jj < nvl ? op[(int64_t)n * rv_cap + v0 + jj] : T(0);
      } else {
        const int kk = static_cast<int>(i / rv_cap);
        const int j = static_cast<int>(i % rv_cap);
        ops[i] = kk < nvl ? op[(int64_t)(v0 + kk) * rv_cap + j] : T(0);
      }
    }
  }
  cluster.sync();

  int it = 0, cur = 0;
  T dif = dif_tol2 > T(1) ? dif_tol2 : T(1);
  while (true) {
    const T *xc = xs + cur * cs;
    // (a) partial product over this CTA's slice
    if (dense && op_in_smem) {
      dense_partial(ops, cs, 0, xc);
    } else if (dense) {
      dense_partial(op, rv_cap, v0, xc);
    } else if (op_in_smem) {
      gram_partial(ops, rv_cap, xc);
    } else {
      gram_partial(op + (int64_t)v0 * rv_cap, rv_cap, xc);
    }
    cluster.sync();  // (1)
    if (it > 0 && warp == 0) {
      // the last iteration's evolution: warp 0 adds the C partials by a
      // fixed butterfly and leaves it in difp[2] for the block
      T num = T(0), den = T(0);
      if (lane < C) {
        const T *rp = cluster.map_shared_rank(difp, lane);
        num = rp[0];
        den = rp[1];
      }
      for (int off = 16; off > 0; off >>= 1) {
        num += __shfl_xor_sync(full, num, off);
        den += __shfl_xor_sync(full, den, off);
      }
      if (lane == 0) difp[2] = den > eps ? num / den : num / eps;
    }
    // (b) gradient and forward step P = 2X - Ga grad (:463-464) of the own
    // vertices, the partials added in rank order
    if (dense)
      for (int n = tid; n < n_op; n += kSmallThreads)
        rsum[n] = rank_sum(cluster, part, n, C);
    __syncthreads();
    if (it > 0) dif = difp[2];
    if (!(it < it_max && dif >= dif_tol2)) break;
    for (int jj = tid; jj < nvl; jj += kSmallThreads) {
      T g;
      if (dense && op_in_smem)
        g = dense_grad(ops, cs, 0, jj);
      else if (dense)
        g = dense_grad(op, rv_cap, v0, jj);
      else
        g = rank_sum(cluster, part, v0 + jj, C);
      ps[jj] = forward_value(xc[jj], sga[jj], g - saty[jj]);
    }
    cluster.sync();  // (2)
    // (c) per-edge d1 pair prox + relaxation (:466-489) of the own edges;
    // the edge terms go to global memory in incidence order
    for (int s = tid; s < nel; s += kSmallThreads) {
      const int e = e0 + s;
      const int u = __ldg(eu + e), v = __ldg(ev + e);
      T *xcm = xs + cur * cs;
      const T pu = owned_value(cluster, ps, u, cs, rank);
      const T pv = owned_value(cluster, ps, v, cs, rank);
      const T xu = owned_value(cluster, xcm, u, cs, rank);
      const T xv = owned_value(cluster, xcm, v, cs, rank);
      T zun, zvn;
      pair_prox_relax(pu, pv, zu[e], zv[e], xu, xv, __ldg(wdu + e),
                      __ldg(wdv + e), __ldg(thd + e), rho, zun, zvn);
      zu[e] = zun;
      zv[e] = zvn;
      __stcg(wz + __ldg(inc_pos + e), __ldg(wu + e) * zun);
      __stcg(wz + __ldg(inc_pos + ne + e), __ldg(wv + e) * zvn);
    }
    cluster.sync();  // (3)
    // (d) weighted edge -> vertex accumulation (:491-497), vertex prox
    // (:499-512) and evolution terms (:514-529) of the own vertices.  The
    // edge terms lie contiguous in incidence order; tpv lanes share a
    // vertex, each adding a contiguous run of its row (read through L2
    // kIncBatchBytes at a time, in order), the runs added by a fixed
    // shuffle tree
    T num = T(0), den = T(0);
    T *xn_out = xs + (cur ^ 1) * cs;
    for (int jb = warp * (32 / tpv); jb < nvl; jb += kSmallThreads / tpv) {
      const int jj = jb + lane / tpv;
      T a = T(0);
      if (jj < nvl) {
        const int beg = soff[jj], end = soff[jj + 1];
        const int run = (end - beg + tpv - 1) / tpv;
        const int r0 = beg + sub * run;
        const int r1 = min(r0 + run, end);
        constexpr int kBatch = kIncBatchBytes / sizeof(T);
        for (int k = r0; k < r1; k += kBatch) {
          T t[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            t[i] = k + i < r1 ? __ldcg(wz + k + i) : T(0);
#pragma unroll
          for (int i = 0; i < kBatch; ++i)
            if (k + i < r1) a += t[i];
        }
      }
      for (int off = tpv / 2; off > 0; off >>= 1)
        a += __shfl_down_sync(full, a, off, tpv);
      if (jj < nvl && sub == 0) {
        const int v = v0 + jj;
        T xn = vertex_prox(a, sth[jj], vkind, positivity, lo, hi);
        if (v >= rv) xn = T(0);
        const T d = xn - xc[jj];
        num += d * d;
        den += xn * xn;
        xn_out[jj] = xn;
      }
    }
    block_sum2(num, den, scratch);
    if (tid == 0) {
      difp[0] = num;
      difp[1] = den;
    }
    cur ^= 1;
    ++it;
  }
  for (int jj = tid; jj < nvl; jj += kSmallThreads)
    xo[v0 + jj] = xs[cur * cs + jj];
  if (rank == 0 && tid == 0) {
    *it_out = it;
    *dif_out = dif;
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

template <typename T>
int launch_cluster(int c, size_t smem, cudaStream_t s, int op_kind,
                   const T *op, int n_op, int op_in_smem, const T *aty,
                   const T *ga, const T *th_l1, const T *x0, const T *z0,
                   const T *ec, const int *eu, const int *ev,
                   const int *inc_off, const int *inc_pos, int rv_cap,
                   int ne, int rv, int it_max, T rho, int vkind,
                   int positivity, T lo, T hi, T dif_tol2, T eps, T *xo,
                   T *zo, T *wz, int *it_out, T *dif_out) {
  auto kernel = solve_small_cluster_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && c > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kSmallThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, op_kind, op, n_op, op_in_smem, aty,
                           ga, th_l1, x0, z0, ec, eu, ev, inc_off, inc_pos,
                           rv_cap, ne, rv, it_max, rho, vkind, positivity, lo,
                           hi, dif_tol2, eps, xo, zo, wz, it_out, dif_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cluster: C CTAs (1: the one-block schedule); inc_pos: the position of
// each endpoint slot in the incidence list (the cluster schedule writes the
// edge terms in incidence order); op_in_smem: the operator's slice in
// shared memory (the wrapper's choice) on a cluster, which takes the dense
// and Gram operators
template <typename T>
int solve_small(int op_kind, const T *op, int n_rows, const T *aty,
                const T *ga, const T *th_l1, const T *x0, const T *z0,
                const T *ec, const int *eu, const int *ev, const int *inc_off,
                const int *inc_slot, const int *inc_pos, int rv_cap, int ne,
                int rv, int it_max,
                double rho, int vkind, int positivity, double lo, double hi,
                double dif_tol2, double eps, T *xo, T *zo, T *wz, int *it_out,
                T *dif_out, int cluster, int op_in_smem, void *stream) {
  if (op_kind < kOpDense || op_kind > kOpDiag || rv_cap < 1 || ne < 1 ||
      cluster < 1 || cluster > kMaxCluster || cluster > rv_cap ||
      (cluster > 1 && op_kind == kOpDiag))
    return -1;
  if (op_kind != kOpDense) n_rows = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 1) {
    const int n_op = op_kind == kOpGram ? rv_cap : n_rows;
    const size_t smem = cluster_smem_bytes<T>(rv_cap, n_op, cluster,
                                              op_in_smem);
    return launch_cluster<T>(
        cluster, smem, s, op_kind, op, n_op, op_in_smem, aty, ga, th_l1, x0,
        z0, ec, eu, ev, inc_off, inc_pos, rv_cap, ne, rv, it_max, T(rho),
        vkind, positivity, T(lo), T(hi), T(dif_tol2), T(eps), xo, zo, wz,
        it_out, dif_out);
  }
  const size_t smem = smem_bytes<T>(rv_cap, n_rows);
  cudaError_t err = cudaFuncSetAttribute(
      solve_small_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
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
           const int *inc_slot, const int *inc_pos, int rv_cap, int ne,      \
           int rv, int it_max,                                                \
           double rho, int vkind, int positivity, double lo, double hi,       \
           double dif_tol2, double eps, T *xo, T *zo, T *wz, int *it_out,     \
           T *dif_out, int cluster, int op_in_smem, void *stream) {          \
    return cp_pfdr::solve_small<T>(op_kind, op, n_rows, aty, ga, th_l1, x0,   \
                                   z0, ec, eu, ev, inc_off, inc_slot,         \
                                   inc_pos, rv_cap,                           \
                                   ne, rv, it_max, rho, vkind, positivity,    \
                                   lo, hi, dif_tol2, eps, xo, zo, wz, it_out, \
                                   dif_out, cluster, op_in_smem, stream);     \
  }

CP_SMALL_ENTRY(cp_solve_small_f32, float)
CP_SMALL_ENTRY(cp_solve_small_f64, double)

#undef CP_SMALL_ENTRY

// dynamic shared memory of the one-block launch, in bytes
size_t cp_solve_small_smem_bytes(int itemsize, int rv_cap, int n_rows) {
  return itemsize == 8 ? cp_pfdr::smem_bytes<double>(rv_cap, n_rows)
                       : cp_pfdr::smem_bytes<float>(rv_cap, n_rows);
}

// dynamic shared memory of one CTA of a cluster launch, in bytes (n_op: A's
// rows for the dense operator, rv_cap for the Gram one)
size_t cp_solve_small_cluster_smem_bytes(int itemsize, int rv_cap, int n_op,
                                         int cluster, int op_in_smem) {
  return itemsize == 8
             ? cp_pfdr::cluster_smem_bytes<double>(rv_cap, n_op, cluster,
                                                   op_in_smem)
             : cp_pfdr::cluster_smem_bytes<float>(rv_cap, n_op, cluster,
                                                  op_in_smem);
}

int cp_solve_small_max_cluster() { return cp_pfdr::kMaxCluster; }

}
