// Device helpers shared by the PFDR kernels of this directory: the per-edge
// d1 pair prox with relaxation, the vertex prox, and a deterministic block
// reduction.  Formulas follow PFDR_graph_quadratic_d1_l1.cpp:463-529 and the
// JAX package's kernels (ops/stencil_fused.py:_kernel,
// ops/solve_small.py:_kernel).
#pragma once

#include <cuda_runtime.h>

namespace cp_pfdr {

enum VertexKind { kVertexNone = 0, kVertexL1 = 1, kVertexBounds = 2 };

// forward step P = 2 X - Gamma grad (:463-464).  Every evaluation of a
// vertex's forward value goes through this one function, so two threads
// that both need it get the same bits.
template <typename T>
__device__ __forceinline__ T forward_value(T x, T ga, T grad) {
  return T(2) * x - ga * grad;
}

// d1 pair prox on the auxiliary pair (zu, zv) of one edge, then relaxation
// by rho (:466-489).  pu/pv: forward values of the endpoints, xu/xv: current
// iterates of the endpoints.
template <typename T>
__device__ __forceinline__ void pair_prox_relax(
    T pu, T pv, T zu, T zv, T xu, T xv, T wdu, T wdv, T th, T rho,
    T &zu_new, T &zv_new) {
  const T au = pu - zu;
  const T av = pv - zv;
  const T avg = wdu * au + wdv * av;
  const T diff = au - av;
  T mag = fabs(diff) - th;
  mag = mag > T(0) ? mag : T(0);
  const T shrunk = diff > T(0) ? mag : (diff < T(0) ? -mag : T(0));
  zu_new = zu + rho * ((avg + wdv * shrunk) - xu);
  zv_new = zv + rho * ((avg - wdu * shrunk) - xv);
}

// vertex prox (:499-512): l1 soft threshold (+ positivity), box clamp, or
// none (+ positivity)
template <typename T>
__device__ __forceinline__ T vertex_prox(T a, T th_l1, int kind,
                                         int positivity, T lo, T hi) {
  if (kind == kVertexL1) {
    T pos = a - th_l1;
    pos = pos > T(0) ? pos : T(0);
    if (!positivity) {
      T neg = a + th_l1;
      pos += neg < T(0) ? neg : T(0);
    }
    return pos;
  }
  if (kind == kVertexBounds) {
    T c = a > lo ? a : lo;
    return c < hi ? c : hi;
  }
  if (positivity) return a > T(0) ? a : T(0);
  return a;
}

// Sums (a, b) over the block in a fixed order: shuffle tree inside each
// warp, then warp 0 over the per-warp sums.  The result is valid in thread
// 0.  scratch holds 2 * 32 values.  Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void block_sum2(T &a, T &b, T *scratch) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(full, a, off);
    b += __shfl_down_sync(full, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < nwarps ? scratch[lane] : T(0);
    b = lane < nwarps ? scratch[32 + lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(full, a, off);
      b += __shfl_down_sync(full, b, off);
    }
  }
  __syncthreads();
}

}  // namespace cp_pfdr
