// Schedule shared by the two circulant kernels (circulant_fused.cu, one
// plane; circulant_fused_simplex.cu, K label planes) on a graph decomposed
// into offset families plus a remainder (CirculantGraphD1).
//
// A first launch of kCircFirstBlock-thread blocks writes the forward field
// (0 at the padded positions u >= V) and gives each vertex whose remainder
// row holds more than kLongRow slots a block that sums the row.  The main
// launch gives each padded vertex G threads (family_groups), each a
// contiguous group of its families: a block holds kCircBlock / G vertices
// times G groups, so a warp holds 32 consecutive vertices of one group and
// every slot load is coalesced.  The groups' sums meet in shared memory and
// are added in group order by the group-0 thread, which ends the vertex.
#pragma once

#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kCircBlock = 256;
// threads of the first launch's blocks: a hub row of the remainder's
// padding edges (618 slots at the mesh scale) takes one slot a thread
constexpr int kCircFirstBlock = 1024;
constexpr int kMaxFamilyGroups = 8;
// main-launch blocks resident on one SM (caps the registers at 48 a
// thread: the mesh's 640 blocks fit in one wave)
constexpr int kCircMinBlocks = 5;

// family groups of a vertex: the largest power of two at most
// min(F, kMaxFamilyGroups)
inline int family_groups(int nf) {
  int g = 1;
  while (2 * g <= nf && 2 * g <= kMaxFamilyGroups) g *= 2;
  return g;
}

// blocks of the main launch over vv padded vertices
inline int circulant_blocks(int vv, int groups) {
  const int tv = kCircBlock / groups;
  return (vv + tv - 1) / tv;
}

// blocks of the first launch that write n forward values, one a thread
inline int forward_blocks(int64_t n) {
  return static_cast<int>((n + kCircFirstBlock - 1) / kCircFirstBlock);
}

template <typename T>
__device__ __forceinline__ T padded_at(const T *plane, int nv, int i) {
  return i < nv ? __ldg(plane + i) : T(0);
}

// wv of a slot from its wu and w_d1u and its endpoints' Gamma, as the TPU
// kernels derive it (ops/circulant_fused.py:148-160,
// ops/circulant_fused_simplex.py:113-119): 0 where Gamma_u = 0
template <typename T>
__device__ __forceinline__ T derived_wv(T wu, T wdu, T gau, T gav) {
  const T wdv = T(1) - wdu;
  const T safe_u = wdu > T(0) ? wdu : T(1);
  const T safe_g = gau > T(0) ? gau : T(1);
  return wu * (wdv / safe_u) * (gau > T(0) ? gav / safe_g : T(0));
}

// position of this thread in a main-launch block of `groups` groups: its
// group g, its vertex's place in the group (lane) and the padded vertex u
struct GroupPosition {
  int g, lane, u;
};

__device__ __forceinline__ GroupPosition group_position(int groups) {
  const int tv = kCircBlock / groups;
  GroupPosition p;
  p.g = threadIdx.x / tv;
  p.lane = threadIdx.x - p.g * tv;
  p.u = blockIdx.x * tv + p.lane;
  return p;
}

// the families [f0, f1) of group g
__device__ __forceinline__ void group_families(int g, int nf, int groups,
                                               int &f0, int &f1) {
  f0 = g * nf / groups;
  f1 = (g + 1) * nf / groups;
}

// adds the groups' sums of each of K values into the group-0 thread of the
// vertex, in group order.  group_sums holds kCircBlock values.  Every
// thread of the block must call it.
template <typename T, int KA>
__device__ __forceinline__ void add_group_sums(T (&acc)[KA], int K,
                                               const GroupPosition &p,
                                               int groups, T *group_sums) {
  const int tv = kCircBlock / groups;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (p.g > 0) group_sums[threadIdx.x] = acc[k];
    __syncthreads();
    if (p.g == 0)
      for (int h = 1; h < groups; ++h)
        acc[k] = acc[k] + group_sums[h * tv + p.lane];
    __syncthreads();
  }
}

// sums K values per thread over a first-launch block in a fixed order, two
// at a time (block_sum2); the sums are valid in thread 0
template <typename T, int KA>
__device__ __forceinline__ void block_sum_values(T (&acc)[KA], int K,
                                                 T *scratch) {
  for (int k = 0; k < K; k += 2) {
    T b = k + 1 < K ? acc[k + 1] : T(0);
    block_sum2(acc[k], b, scratch);
    if (k + 1 < K) acc[k + 1] = b;
  }
}

}  // namespace cp_pfdr
