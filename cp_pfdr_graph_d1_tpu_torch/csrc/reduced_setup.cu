// Set-up of one reduced cut-pursuit problem in one launch, for Hopper
// (sm_90a): the power iteration of the DIAG Lipschitz metric, then the
// initial preconditioning, from the reduced operator and graph to the
// inputs of the whole-solve kernels (solve_small, solve_fused).
//
// Replaces no TPU kernel: the JAX package runs these steps as XLA
// operations (ops/power_iter.py:operator_norm,
// solvers/pfdr_quadratic.py:initial_precondition).  In the port they were
// eager PyTorch operations: about 70 launches for the preconditioning, and
// a device read after every power step for its stopping test, so the host
// waited on the card some 17 times a reduced problem.  The plain version is
// ops/reduced_setup.py:reduced_setup_plain.
//
// One block of 1024 threads, in two parts.
//
// Power iteration (operator_norm, operator_norm_matrix.cpp:180-215), when
// the wrapper hands over a symmetric matrix M [p, p]: the 10 restarts are
// the columns of X [p, 10], kept in shared memory column after column, with
// a second buffer for the product.  M stays in global memory (in L1 or L2
// after the first step: 33-66 KB at the EEG problem's p of 91, 1-2 MB
// at the wrapper's cap of 512), Jacobi-equilibrated on the fly with
// `equilibrate` (M_ij / (d_i d_j), d = sqrt(max(diag M, 0)), 1 where that
// is 0; d in shared memory).  The product takes a row a warp, the lanes on
// neighbouring columns, each lane keeping the 10 restarts' partial sums,
// joined by a fixed shuffle tree; lane 0 also sums the squares of its
// warp's rows, and 10 threads add the 32 warps' sums in warp order into the
// column norms and take the stopping test ((a - b) < tol b on every
// restart) in the same barrier (__syncthreads_and).  The
// start is threefry_uniform's, kept on the card by the wrapper.  The metric
// is scale * max(b), scale a [rv_cap] vector read with a stride (the
// diagonal of the reduced Gram, or the squared column norms).  Without M the
// wrapper hands over the metric itself.
//
// Preconditioning (initial_precondition, then _finalize_precond): a thread
// a vertex, then a thread an edge, with a barrier between the phases.  The
// vertex sums of the edge weights walk the incidence list (CSR, the
// container's order) with no atomics, and every block-wide sum has a fixed
// order, so two launches give the same bits.  Gamma and the inverse vertex
// weights pass between the phases through the outputs ga and th_l1, and
// the raw edge weights through the first row of ec; each is overwritten
// with its own value last.
//
// Bound.  A power step does 10 p^2 multiply-adds on one SM, with three
// barriers; at the EEG problem's p of 91 to 128 the shuffle trees and the
// barriers bound it, at about 6.5 us a step on the H100.  Past the
// wrapper's cap on p (ops/reduced_setup.py:FUSED_POWER_MAX_DIM) the one
// SM's work loses to the card's matrix products, a host read a step
// included.  The preconditioning reads the operator once (the dense A: N
// rv_cap values) and the edges twice, a block's worth at a time, and is
// bound by latency: 0.1 ms at 4096 reduced vertices, 1.7 ms at 262,144,
// still ahead of the plain chain's launches over the whole card there.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kSetupThreads = 1024;
// restarts of the power iteration (config.OPERATOR_NORM_NB_INIT)
constexpr int kPowerRestarts = 10;
enum SetupKind { kSetupDense = 0, kSetupGram = 1, kSetupDiag = 2 };
// opt-in dynamic shared memory of one Hopper block (232,448 bytes), less
// room for the kernel's static shared variables
constexpr size_t kSetupSmemLimit = 232448 - 4096;

// The launch's arguments (mirrored by ops/reduced_setup.py:_Params).  The
// float arrays are of the launch's type; null marks an absent one.  A^t y
// comes from the wrapper (a matrix product for the dense operator): of the
// set-up's products, it alone moves the solution, and it stays the one the
// PyTorch set-up formed.
struct SetupParams {
  int kind;          // SetupKind of the reduced operator
  int n_rows;        // rows of the dense operator (kSetupDense)
  int rv_cap;        // vertices
  int ne;            // edges
  int p;             // dimension of M; 0: no power iteration
  int equilibrate;   // Jacobi-equilibrate M first
  int it_max;        // power steps at most
  int scale_stride;  // stride of scale, in elements
  double tol;        // the power iteration's relative tolerance
  double cap;        // 1.9 (2 - rho), the metric's cap over the metric
  const void *mat;   // dense [n_rows, rv_cap], Gram [rv_cap, rv_cap], diag
  const void *aty;   // [rv_cap] A^t y
  const void *pm;    // M [p, p]
  const void *start;  // [p, kPowerRestarts] restarts' start
  const void *scale;  // [rv_cap] (strided) metric scale
  const void *lip_in;  // [rv_cap] the metric, without M
  const void *la_d1;  // [ne]
  const void *la_l1;  // [rv_cap] or null
  const void *x0;     // [rv_cap] warm start
  const long long *eu;
  const long long *ev;
  const int *inc_off;   // [rv_cap + 1] incidence offsets
  const int *inc_slot;  // [2 ne] endpoint slots (e: u-end, ne + e: v-end)
  void *ga;     // [rv_cap] Gamma
  void *th_l1;  // [rv_cap] l1 thresholds
  void *ec;     // [5, ne] wu, wv, w_d1u, w_d1v, th_d1
  void *z0;     // [2, ne] the warm start's endpoint values
  void *lip;    // [rv_cap] the metric (written with M)
  int *steps;   // power steps taken (written with M)
};

// norms of the kPowerRestarts columns of x (column k at x + k p) into
// norm[0..kPowerRestarts-1] in shared memory, read by every thread after
// the call
template <typename T>
__device__ void column_norms(const T *x, int p, T *scratch, T *norm) {
  T v[kPowerRestarts];
#pragma unroll
  for (int k = 0; k < kPowerRestarts; ++k) v[k] = T(0);
  for (int j = threadIdx.x; j < p; j += kSetupThreads) {
#pragma unroll
    for (int k = 0; k < kPowerRestarts; ++k) {
      const T e = x[k * p + j];
      v[k] += e * e;
    }
  }
  T s;
  block_sum_k<T, kPowerRestarts>(v, scratch, s);
  if (threadIdx.x < kPowerRestarts) norm[threadIdx.x] = sqrt(s);
  __syncthreads();
}

// y = M x for the kPowerRestarts columns (column k at + k p), M [p, p]
// symmetric, equilibrated by d unless d is null: a warp a row, the lanes on
// neighbouring columns.  Lane 0 of each warp also sums the squares of its
// rows' values, warp w's into part[k * 32 + w].
template <typename T>
__device__ void power_product(const T *m, const T *d, int p, const T *x,
                              T *y, T *part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T sq[kPowerRestarts];
#pragma unroll
  for (int k = 0; k < kPowerRestarts; ++k) sq[k] = T(0);
  for (int i = warp; i < p; i += kSetupThreads / 32) {
    const T *row = m + (int64_t)i * p;
    const T di = d ? d[i] : T(1);
    T acc[kPowerRestarts];
#pragma unroll
    for (int k = 0; k < kPowerRestarts; ++k) acc[k] = T(0);
    for (int j = lane; j < p; j += 32) {
      const T mij = d ? row[j] / (di * d[j]) : row[j];
#pragma unroll
      for (int k = 0; k < kPowerRestarts; ++k) acc[k] += mij * x[k * p + j];
    }
#pragma unroll
    for (int k = 0; k < kPowerRestarts; ++k)
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kPowerRestarts; ++k) {
        y[k * p + i] = acc[k];
        sq[k] += acc[k] * acc[k];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kPowerRestarts; ++k) part[k * 32 + warp] = sq[k];
  }
  __syncthreads();
}

// the norm of column k (thread k < kPowerRestarts) from the warps' partial
// sums of squares, added in warp order
template <typename T>
__device__ __forceinline__ T part_norm(const T *part, int k) {
  T s = T(0);
  for (int w = 0; w < kSetupThreads / 32; ++w) s += part[k * 32 + w];
  return sqrt(s);
}

// the largest eigenvalue of M by the power iteration of operator_norm;
// writes the step count and returns the value in every thread.  smem holds
// the equilibration, the iterate and its product ((2 kPowerRestarts + 1) p
// values); scratch (32 kPowerRestarts values) serves the start's norms,
// then the warps' sums of squares.
template <typename T>
__device__ T power_norm(const SetupParams &prm, T *smem, T *scratch) {
  __shared__ T s_b[kPowerRestarts];
  __shared__ T s_norm;
  T *part = scratch;
  const int tid = threadIdx.x;
  const int p = prm.p;
  const int np = kPowerRestarts * p;
  const T *mg = static_cast<const T *>(prm.pm);
  const T *start = static_cast<const T *>(prm.start);
  const T tol = T(prm.tol);
  T *d = smem;       // [p] equilibration
  T *x = d + p;      // [10 p] the iterate, column after column
  T *y = x + np;     // [10 p] its product
  for (int i = tid; i < np; i += kSetupThreads) {
    const int j = i / kPowerRestarts;
    x[(i - j * kPowerRestarts) * p + j] = start[i];
  }
  if (prm.equilibrate)
    for (int j = tid; j < p; j += kSetupThreads) {
      const T mjj = mg[(int64_t)j * p + j];
      const T dj = sqrt(mjj > T(0) ? mjj : T(0));
      d[j] = dj > T(0) ? dj : T(1);
    }
  __syncthreads();
  const T *eq = prm.equilibrate ? d : nullptr;
  // one warm-up application (operator_norm_matrix.cpp:192-194)
  column_norms(x, p, scratch, s_b);
  for (int i = tid; i < np; i += kSetupThreads) x[i] = x[i] / s_b[i / p];
  __syncthreads();
  power_product(mg, eq, p, x, y, part);
  if (tid < kPowerRestarts) s_b[tid] = part_norm(part, tid);
  __syncthreads();
  int steps = 0;
  for (int step = 1; step <= prm.it_max; ++step) {
    steps = step;
    // y holds the iterate: divide by the norms (1 where 0), apply M
    for (int i = tid; i < np; i += kSetupThreads) {
      const T b = s_b[i / p];
      y[i] = y[i] / (b > T(0) ? b : T(1));
    }
    __syncthreads();
    power_product(mg, eq, p, y, x, part);
    // the stopping test (a - b) < tol b on every restart, and the new norms
    int ok = 1;
    if (tid < kPowerRestarts) {
      const T a = part_norm(part, tid);
      const T b = s_b[tid];
      ok = a - b < tol * (b > T(0) ? b : T(1));
      s_b[tid] = b > T(0) ? a : T(0);
    }
    const int done = __syncthreads_and(ok);
    T *t = x;
    x = y;
    y = t;
    if (done) break;
  }
  if (tid == 0) {
    T b = s_b[0];
    for (int k = 1; k < kPowerRestarts; ++k) b = s_b[k] > b ? s_b[k] : b;
    s_norm = b;
    *prm.steps = steps;
  }
  __syncthreads();
  return s_norm;
}

// dynamic shared memory of a launch whose M has dimension p: the power
// iteration's vectors
template <typename T>
size_t setup_smem_bytes(int p) {
  return sizeof(T) * (2 * kPowerRestarts + 1) * (size_t)p;
}

template <typename T>
__global__ void __launch_bounds__(kSetupThreads, 1)
reduced_setup_kernel(const SetupParams prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T scratch[32 * kPowerRestarts];
  __shared__ T s_c;
  const int tid = threadIdx.x;
  const int nv = prm.rv_cap;
  const int ne = prm.ne;
  const T *mat = static_cast<const T *>(prm.mat);
  const T *aty = static_cast<const T *>(prm.aty);
  const T *la_d1 = static_cast<const T *>(prm.la_d1);
  const T *la_l1 = static_cast<const T *>(prm.la_l1);
  const T *x0 = static_cast<const T *>(prm.x0);
  T *ga = static_cast<T *>(prm.ga);
  T *th = static_cast<T *>(prm.th_l1);
  T *ec = static_cast<T *>(prm.ec);
  T *z0 = static_cast<T *>(prm.z0);

  // the DIAG Lipschitz metric
  const T *lip = static_cast<const T *>(prm.lip_in);
  if (prm.p > 0) {
    const T c = power_norm<T>(prm, reinterpret_cast<T *>(smem_raw), scratch);
    const T *scale = static_cast<const T *>(prm.scale);
    T *out = static_cast<T *>(prm.lip);
    for (int v = tid; v < nv; v += kSetupThreads)
      out[v] = scale[(int64_t)v * prm.scale_stride] * c;
    lip = out;  // each thread reads back its own vertices below
  }

  // diag(A^t A), the preconditioner's inverse (A^t y / that) and its mean
  // amplitude (PFDR_graph_quadratic_d1_l1.cpp:145-154); diag(A^t A) waits
  // in ga
  T cnt = T(0), amp = T(0);
  for (int v = tid; v < nv; v += kSetupThreads) {
    T h;
    if (prm.kind == kSetupDense) {
      h = T(0);
      for (int i = 0; i < prm.n_rows; ++i) {
        const T e = mat[(int64_t)i * nv + v];
        h += e * e;
      }
    } else {
      h = prm.kind == kSetupGram ? mat[(int64_t)v * nv + v] : mat[v];
    }
    const T pinv = h != T(0) ? aty[v] / h : T(0);
    ga[v] = h;
    cnt += pinv != T(0) ? T(1) : T(0);
    amp += fabs(pinv);
  }
  block_sum2(cnt, amp, scratch);
  if (tid == 0) s_c = amp != T(0) ? cnt / amp : T(1);
  __syncthreads();
  const T c = s_c;

  // raw edge weights c la_d1, in ec's first row until the edge phase
  for (int e = tid; e < ne; e += kSetupThreads) ec[e] = c * la_d1[e];
  __syncthreads();

  // vertex weights (their sums over the incidence list), Gamma and its cap
  // (:193-239); the inverse weights wait in th_l1
  const T cap = T(prm.cap);
  for (int v = tid; v < nv; v += kSetupThreads) {
    T aux = T(0);
    for (int k = prm.inc_off[v]; k < prm.inc_off[v + 1]; ++k) {
      const int s = prm.inc_slot[k];
      aux += ec[s < ne ? s : s - ne];
    }
    T h = ga[v] + aux;
    th[v] = aux != T(0) ? T(1) / aux : T(0);
    if (la_l1) h = h + c * la_l1[v];
    T g = h != T(0) ? T(1) / h : T(1);
    const T l = lip[v];
    if (l > T(0)) {
      // PyTorch divides a number by a tensor as the reciprocal times it
      const T lim = (T(1) / l) * cap;
      g = lim < g ? lim : g;
    }
    ga[v] = g;
  }
  __syncthreads();

  // splitting weights, d1 prox weights and thresholds (:241-267), and the
  // warm start's endpoint values
  for (int e = tid; e < ne; e += kSetupThreads) {
    const int64_t u = prm.eu[e], w = prm.ev[e];
    const T raw = ec[e];
    const T wu = raw * th[u];
    const T wv = raw * th[w];
    const T du = wu / ga[u];
    const T dv = wv / ga[w];
    const T s = du + dv;
    const T prod = du * dv;
    ec[e] = wu;
    ec[ne + e] = wv;
    ec[2 * ne + e] = s != T(0) ? du / s : T(0.5);
    ec[3 * ne + e] = s != T(0) ? dv / s : T(0.5);
    ec[4 * ne + e] =
        prod > T(0) ? la_d1[e] * (prod != T(0) ? s / prod : T(0)) : T(0);
    z0[e] = x0[u];
    z0[ne + e] = x0[w];
  }
  __syncthreads();
  for (int v = tid; v < nv; v += kSetupThreads)
    th[v] = la_l1 ? ga[v] * la_l1[v] : T(0);
}


template <typename T>
int reduced_setup(const SetupParams &prm, void *stream) {
  if (prm.kind < kSetupDense || prm.kind > kSetupDiag || prm.rv_cap < 1 ||
      prm.ne < 1 || prm.p < 0 || prm.it_max < 0 ||
      (prm.p > 0 && (!prm.pm || !prm.start || !prm.scale || !prm.lip ||
                     !prm.steps)) ||
      (prm.p == 0 && !prm.lip_in) || !prm.aty)
    return -1;
  const size_t smem = prm.p > 0 ? setup_smem_bytes<T>(prm.p) : 0;
  if (smem > kSetupSmemLimit) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      reduced_setup_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  reduced_setup_kernel<T><<<1, kSetupThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cp_pfdr

extern "C" {

// itemsize 4: float32, 8: float64
int cp_reduced_setup(const cp_pfdr::SetupParams *prm, int itemsize,
                     void *stream) {
  return itemsize == 8 ? cp_pfdr::reduced_setup<double>(*prm, stream)
                       : cp_pfdr::reduced_setup<float>(*prm, stream);
}

// dynamic shared memory of a launch whose M has dimension p, in bytes
size_t cp_reduced_setup_smem_bytes(int itemsize, int p) {
  return itemsize == 8 ? cp_pfdr::setup_smem_bytes<double>(p)
                       : cp_pfdr::setup_smem_bytes<float>(p);
}

// the restarts of the power iteration
int cp_reduced_setup_restarts() { return cp_pfdr::kPowerRestarts; }

}  // extern "C"
