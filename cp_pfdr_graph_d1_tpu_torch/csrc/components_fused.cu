// Connected components of a masked [H, W] stencil graph, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/components_fused.py
// (_fused_components_call, _kernel).  Every vertex ends with the smallest
// vertex index reachable from it over the edges whose mask is set (every
// circular shift family, both directions): the unique fixpoint that the TPU
// kernel reaches by synchronous rounds of rolls and minimums, as many as
// the components' diameters need.
//
// Design: union-find on the label table in three launches, a fixed number
// of passes whatever the diameters.
//   1. tile pass: a block of 256 threads labels a 32 x 32 tile in shared
//      memory.  Each row of the tile is a warp's segment: a ballot of the
//      edges to the left neighbour gives every cell the start of its run
//      (the smallest cell of the run), then every other set edge with both
//      ends in the tile hooks its two runs, once for each stretch of edges
//      two runs share (an edge is skipped when its twin, the previous cell
//      along the other axis, has the same edge set between the same two
//      runs).  The hooks are packed into a queue a warp and joined with the
//      lanes stepping together (warp_unite); synchronous pointer jumping
//      then takes every entry to its root.  Each cell's label, written to
//      the label table and to the tile-label scratch, is its tile
//      component's smallest cell.
//   2. hook pass: a thread a cell hooks the tile labels of its set edges
//      that leave the tile (twins skipped the same way) on the global
//      table, the warp stepping together, reads and writes at L2.
//   3. flatten pass: every cell walks from its tile label to the root.
// Only integer atomics are used.  A root only ever points to a smaller
// index, so each tree's root is its smallest vertex and, once every set
// edge is joined, each component's root is its minimum: the labels equal
// the plain version's whatever order the atomics land in.
//
// Schedules measured on the H100 and deleted (PERF.md, section 6): one
// cooperative launch with two grid barriers (slower than three launches in
// 7 of 9 cases); the init pass "smallest of a cell and its set-edge
// neighbours" on the whole field (parent chains up every column: 346-411
// us at 724 x 724), and in 32 x 32 tiles; one block holding a 140 x 140
// field in shared memory (224 us); 64 x 64 tiles; roots linked by a
// pseudo-random priority; lane-by-lane union loops (20-45k cycles a tile).
//
// Bound.  The mask read once (F bytes a cell) and the labels written once
// (4 bytes a cell): F V + 4 V bytes, 0.94 us at 724 x 724, F = 2.  The
// passes chase parent pointers through shared memory and L2, so the kernel
// is bound by the latency of those dependent reads and by the launches.
#include <cstdint>

#include "pfdr_common.cuh"

namespace cp_pfdr {

constexpr int kCompThreads = 256;
constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kCompPasses = 3;

// launch plan of a components call (mirrored by ops/components_fused._Plan)
struct CompPlan {
  int *tl;  // [H * W] scratch: the tile labels
  int h, w, nf, device;
  int dy[kMaxFamilies], dx[kMaxFamilies];
};

struct CompArgs {
  const unsigned char *__restrict__ mask;  // [F, H * W]: edge (f, cell) set
  int *lab;                                // [H * W] parent table, labels
  int *tl;                                 // [H * W] tile labels
  int h, w;
  Shifts sh;
};

// -- union-find -------------------------------------------------------------

// a parent table in shared memory
struct SharedTable {
  volatile int *p;
  __device__ int ld(int x) const { return p[x]; }
  __device__ void st(int x, int v) const { p[x] = v; }
  __device__ int cas(int x, int e, int v) const {
    return atomicCAS(const_cast<int *>(p + x), e, v);
  }
};

// a parent table in global memory, read and written at L2 (a value read
// stale is still an ancestor, and the passes are ordered by launches)
struct GlobalTable {
  int *p;
  __device__ int ld(int x) const { return __ldcg(p + x); }
  __device__ void st(int x, int v) const { __stcg(p + x, v); }
  __device__ int cas(int x, int e, int v) const {
    return atomicCAS(p + x, e, v);
  }
};

// Joins the sets of a and b for every lane with act set, all lanes of the
// warp stepping together: each step climbs both ends one level (path
// halving: a non-root gets its grandparent, still an ancestor) or, at two
// roots, hooks the larger under the smaller with atomicCAS, climbing on
// from the new parent when another lane hooked it first.  (A loop per lane
// leaves the lanes at different points of the find and hook loops, and the
// warp then runs them one after another: 20k cycles a tile for about 200
// hooks.)
template <class Table>
__device__ __forceinline__ void warp_unite(Table par, bool act, int a,
                                           int b) {
  while (__any_sync(0xffffffffu, act)) {
    if (!act) continue;
    if (a == b) {
      act = false;
      continue;
    }
    const int pa = par.ld(a), pb = par.ld(b);
    if (pa != a || pb != b) {
      if (pa != a) {
        const int g = par.ld(pa);
        par.st(a, g);
        a = g;
      }
      if (pb != b) {
        const int g = par.ld(pb);
        par.st(b, g);
        b = g;
      }
      continue;
    }
    const int hi = a > b ? a : b, lo = a > b ? b : a;
    const int old = par.cas(hi, hi, lo);
    if (old == hi)
      act = false;
    else if (hi == a)
      a = old;
    else
      b = old;
  }
}

// -- passes ----------------------------------------------------------------

constexpr int kTileCells = kTileH * kTileW;
constexpr int kTileThreads = kTileCells / 4;  // 4 cells a thread

__device__ __forceinline__ int tile_of(int i, int j, int w) {
  return (i / kTileH) * ((w + kTileW - 1) / kTileW) + j / kTileW;
}

// whether a set edge of family (dy, dx) at column j joins two cells next
// to each other in one 32-column segment of a tile row (the left one
// first): such edges make the row runs of the tile pass
__device__ __forceinline__ bool run_edge(int dy, int dx, int j, int w) {
  if (dy != 0 || (dx != 1 && dx != -1)) return false;
  const int jv = j + dx;
  return jv >= 0 && jv < w && jv / 32 == j / 32;
}

// the cell whose edge of the same family, when it joins the same two
// components, makes the edge at (i, j) redundant: the previous cell along
// the other axis, (-1, -1) when that leaves the tile
__device__ __forceinline__ int2 twin_cell(int dy, int i, int j) {
  if (dy != 0) return j % kTileW ? make_int2(i, j - 1) : make_int2(-1, -1);
  return i % kTileH ? make_int2(i - 1, j) : make_int2(-1, -1);
}

// The tile pass: one block labels its tile in shared memory over the set
// edges with both ends in it (local row-major indices, whose order is the
// global one), then writes each cell's root, as a global index, to a.lab
// and to a.tl (the copy the hook pass compares).
//   0. the tile's mask bits, all of a thread's loads issued at once;
//   1. every cell's run: the start of the cells joined to their left
//      neighbours in its 32-column segment (a ballot of those edges), kept
//      in run[] and the runs' parent table sp[];
//   2. every other in-tile set edge hooks its two runs, skipped when its
//      twin (twin_cell) has the same edge set between the same two runs:
//      one hook for each stretch of edges that two runs share;
//   3. every entry to its root by synchronous pointer jumping, and each
//      cell's root written out.
// NF > 0: the family count known at compile time.
template <int NF>
__global__ void __launch_bounds__(kTileThreads)
comp_tile_kernel(CompArgs a) {
  constexpr int TH = kTileH, TW = kTileW, n = kTileCells, nt = kTileThreads;
  __shared__ int sp[n];
  __shared__ int run[n];
  __shared__ int2 wq[nt / 32][128];  // a warp's hooks of one family
  __shared__ unsigned short bits[n];
  const int nf = NF > 0 ? NF : a.sh.n;
  const int hw = a.h * a.w;
  const int ntw = (a.w + TW - 1) / TW;
  const int t = blockIdx.x;
  const int ti = t / ntw;
  const int i0 = ti * TH, j0 = (t - ti * ntw) * TW;
  unsigned char m[4][NF > 0 ? NF : kMaxFamilies];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int l = threadIdx.x + q * nt;
    const int i = i0 + l / TW, j = j0 + l % TW;
#pragma unroll
    for (int f = 0; f < (NF > 0 ? NF : kMaxFamilies); ++f)
      m[q][f] = (f < nf && i < a.h && j < a.w)
                    ? a.mask[(int64_t)f * hw + i * a.w + j]
                    : 0;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned b = 0;
#pragma unroll
    for (int f = 0; f < (NF > 0 ? NF : kMaxFamilies); ++f)
      b |= (m[q][f] != 0 ? 1u : 0u) << f;
    bits[threadIdx.x + q * nt] = (unsigned short)b;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int l = threadIdx.x + q * nt;
    bool left = false;
    if (lane > 0 && i0 + l / TW < a.h && j0 + l % TW < a.w) {
      const unsigned here = bits[l], before = bits[l - 1];
      for (int f = 0; f < nf; ++f) {
        if (a.sh.dy[f] != 0) continue;
        if (a.sh.dx[f] == 1) left = left || ((before >> f) & 1u);
        if (a.sh.dx[f] == -1) left = left || ((here >> f) & 1u);
      }
    }
    // lane k of the warp holds column k of its tile row
    const unsigned breaks = __ballot_sync(0xffffffffu, !left);
    const unsigned upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1u;
    const int start = l - lane + (31 - __clz(breaks & upto));
    run[l] = start;
    sp[l] = start;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int f = 0; f < nf; ++f) {
    const int dy = a.sh.dy[f], dx = a.sh.dx[f];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = threadIdx.x + q * nt;
      const int i = i0 + l / TW, j = j0 + l % TW;
      bool need = false;
      int ra = 0, rb = 0;
      if (((bits[l] >> f) & 1u) && !run_edge(dy, dx, j, a.w)) {
        const int vi = wrap_near(i + dy, a.h) - i0;
        const int vj = wrap_near(j + dx, a.w) - j0;
        if (vi >= 0 && vi < TH && vj >= 0 && vj < TW) {
          ra = run[l];
          rb = run[vi * TW + vj];
          need = ra != rb;
          const int2 tw = twin_cell(dy, i, j);
          if (need && tw.x >= 0) {
            const int lt = (tw.x - i0) * TW + tw.y - j0;
            const int ui = wrap_near(tw.x + dy, a.h) - i0;
            const int uj = wrap_near(tw.y + dx, a.w) - j0;
            need = !(((bits[lt] >> f) & 1u) && ui >= 0 && ui < TH &&
                     uj >= 0 && uj < TW && run[lt] == ra &&
                     run[ui * TW + uj] == rb);
          }
        }
      }
      // the warp's hooks of this family, packed into its queue
      const unsigned ball = __ballot_sync(0xffffffffu, need);
      if (need) wq[warp][cnt + __popc(ball & below)] = make_int2(ra, rb);
      cnt += __popc(ball);
    }
    __syncwarp();
    for (int k = 0; k < cnt; k += 32) {
      const bool act = k + lane < cnt;
      const int2 e = act ? wq[warp][k + lane] : make_int2(0, 0);
      warp_unite(SharedTable{sp}, act, e.x, e.y);
    }
    __syncwarp();
  }
  __syncthreads();
  // every entry to its root: synchronous pointer jumping until no entry
  // changes (each round halves the depth of every tree)
  bool moved = true;
  while (__syncthreads_or(moved)) {
    moved = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = threadIdx.x + q * nt;
      const int p = sp[l], g = sp[p];
      if (g != p) {
        sp[l] = g;
        moved = true;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int l = threadIdx.x + q * nt;
    const int i = i0 + l / TW, j = j0 + l % TW;
    if (i >= a.h || j >= a.w) continue;
    const int r = sp[l];
    const int g = (i0 + r / TW) * a.w + j0 + r % TW;
    a.lab[i * a.w + j] = g;
    a.tl[i * a.w + j] = g;
  }
}

// the hook pass: each cell hooks the tile labels of its set edges that
// leave its tile, an edge skipped when its twin has the same edge set
// between the same two tile labels (a.tl, which this pass does not write)
template <int NF>
__global__ void __launch_bounds__(kCompThreads)
comp_hook_kernel(CompArgs a) {
  const int hw = a.h * a.w;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < hw;
  const int nf = NF > 0 ? NF : a.sh.n;
  const int i = live ? c / a.w : 0, j = live ? c - i * a.w : 0;
  unsigned char m[NF > 0 ? NF : kMaxFamilies];
#pragma unroll
  for (int f = 0; f < (NF > 0 ? NF : kMaxFamilies); ++f)
    m[f] = live && f < nf ? a.mask[(int64_t)f * hw + c] : 0;
  const int tc = tile_of(i, j, a.w);
#pragma unroll
  for (int f = 0; f < (NF > 0 ? NF : kMaxFamilies); ++f) {
    if (f >= nf) break;  // nf is the same in every lane
    bool need = m[f] != 0;
    int ra = 0, rb = 0;
    if (need) {
      const int dy = a.sh.dy[f], dx = a.sh.dx[f];
      const int vi = wrap_near(i + dy, a.h), vj = wrap_near(j + dx, a.w);
      const int tv = tile_of(vi, vj, a.w);
      ra = __ldg(a.tl + c);
      rb = __ldg(a.tl + vi * a.w + vj);
      need = tv != tc && ra != rb;
      const int2 tw = twin_cell(dy, i, j);
      if (need && tw.x >= 0) {
        const int ct = tw.x * a.w + tw.y;
        const int ui = wrap_near(tw.x + dy, a.h);
        const int uj = wrap_near(tw.y + dx, a.w);
        need = !(a.mask[(int64_t)f * hw + ct] && tile_of(ui, uj, a.w) == tv &&
                 __ldg(a.tl + ct) == ra && __ldg(a.tl + ui * a.w + uj) == rb);
      }
    }
    warp_unite(GlobalTable{a.lab}, need, ra, rb);
  }
}

// the flatten pass: every cell to its root (read-only walks from its tile
// label, at L2)
__global__ void __launch_bounds__(kCompThreads)
comp_flatten_kernel(CompArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.h * a.w) return;
  int x = __ldg(a.tl + c), p = __ldcg(a.lab + x);
  while (p != x) {
    x = p;
    p = __ldcg(a.lab + x);
  }
  a.lab[c] = x;
}

// -- host ------------------------------------------------------------------

inline int grid_of(int n, int threads) { return (n + threads - 1) / threads; }

template <int NF>
cudaError_t launch_passes(const CompArgs &a, cudaStream_t s) {
  const int cells = grid_of(a.h * a.w, kCompThreads);
  comp_tile_kernel<NF><<<grid_of(a.h, kTileH) * grid_of(a.w, kTileW),
                         kTileThreads, 0, s>>>(a);
  comp_hook_kernel<NF><<<cells, kCompThreads, 0, s>>>(a);
  comp_flatten_kernel<<<cells, kCompThreads, 0, s>>>(a);
  return cudaGetLastError();
}

int components(const CompPlan *p, const unsigned char *mask, int *lab,
               void *stream) {
  if (p->nf < 1 || p->nf > kMaxFamilies || p->h < 1 || p->w < 1) return -1;
  CompArgs a;
  a.mask = mask;
  a.lab = lab;
  a.tl = p->tl;
  a.h = p->h;
  a.w = p->w;
  a.sh.n = p->nf;
  for (int f = 0; f < p->nf; ++f) {
    // |dy| < h and |dx| < w (the wrapper reduces the shifts), so one add
    // or subtract wraps a neighbour's coordinate (wrap_near)
    if (abs(p->dy[f]) >= p->h || abs(p->dx[f]) >= p->w) return -1;
    a.sh.dy[f] = p->dy[f];
    a.sh.dx[f] = p->dx[f];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(p->device, [&]() -> cudaError_t {
    switch (p->nf) {
      case 2: return launch_passes<2>(a, s);
      case 4: return launch_passes<4>(a, s);
      default: return launch_passes<0>(a, s);
    }
  });
}

}  // namespace cp_pfdr

extern "C" {

int cp_components_plan_size() { return (int)sizeof(cp_pfdr::CompPlan); }

// (threads of a block, tile rows, tile columns, passes)
void cp_components_shape(int *out) {
  out[0] = cp_pfdr::kCompThreads;
  out[1] = cp_pfdr::kTileH;
  out[2] = cp_pfdr::kTileW;
  out[3] = cp_pfdr::kCompPasses;
}

int cp_components_fused(const cp_pfdr::CompPlan *plan,
                        const unsigned char *mask, int *lab, void *stream) {
  return cp_pfdr::components(plan, mask, lab, stream);
}
}
