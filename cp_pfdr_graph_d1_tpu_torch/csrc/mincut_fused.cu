// A whole certified PDHG min-cut on an [H, W] stencil field, in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/mincut_fused.py
// (fused_pdhg_min_cut, _kernel).  It solves the relaxation
//   min_{x in [0,1]^V} <c, x> + sum_e w_e |x_u - x_v|
// by diagonally preconditioned primal-dual steps (Pock & Chambolle 2011):
//   z_e <- clip(z_e + sigma_e w_e (xb_u - xb_v), -1, 1)
//   x_v <- clip(x_v - tau_v ((K^t z)_v + c_v), 0, 1),  xb <- 2 x_new - x,
// in chunks of `check_every` steps.  After each chunk it evaluates the 15
// super-level-set cuts {x > t} (t = ts[0..14]) and the dual bound
// sum_v min(0, c_v + (K^t z)_v); it stops when the best cut is within `tol`
// of the bound (the duality-gap certificate) or after `it_max` steps.  It
// starts from (x0, z0), returns x, z, the gap, the best threshold and the
// step count, with the iteration semantics of the TPU kernel and of
// maxflow/device.py:_pdhg_min_cut.  Family f links cell c = (i, j) to its
// head c + s_f = ((i + dy_f) mod H, (j + dx_f) mod W); cell c owns the dual
// z[f, c] of that edge, and (K^t z)_c = sum_f w z[f, c] - w z[f, c - s_f].
//
// Design.  The primal step of a cell needs the new duals of its in-edges
// (f, c - s_f), which other threads own.  Instead of a grid-wide barrier
// between the dual and the primal half-steps, the thread of each cell also
// recomputes those duals from the old state, with the same device function
// (dual_step) on the same values, so the bits equal the owner's.  Products
// are rounded on their own (mul_rn: never contracted into an FMA), so
// every step is the plain version's arithmetic, operation for operation.
// Two schedules, chosen by ops/mincut_fused.py:choose_schedule from the
// field's size, type and the card's limits (never after a failure):
//
// (a) stream: every field in global memory (L2 at these sizes), a
//     grid-stride walk over the cells, xb and z double-buffered by step
//     parity (a step reads buffer p and writes 1 - p, so no thread reads a
//     value another thread overwrites in the same step), sigma * w
//     computed once, and ONE grid barrier per step.  Odd steps walk the
//     cells backwards, so a step starts on what the last one touched last
//     and L2 still holds (float64 at 724 x 724 moves 59 MB a step, more
//     than the 50 MB L2).  Any size, float32 and float64.
// (b) band: float32 fields of at most kBandFamilies families, a multiple of
//     kGroup columns wide, whose state fits the card's shared memory (its
//     threads work on groups of four columns: 16-byte shared-memory
//     accesses, the index arithmetic once a group).  One persistent
//     block per SM owns a band of rows (at least max |dy_f| rows each) for
//     the whole cut, and holds x, c, tau of its rows, and xb, z, w and
//     sigma * w of its rows plus max |dy_f| halo rows on each side, in
//     shared memory.  A step:
//     read the two neighbour bands' boundary rows of xb and z of the
//     previous step into the halo, update the duals of the band's edges
//     and of the halo edges whose head is in the band (the recomputation
//     above, at band scale), then the primal step, and publish the band's
//     boundary rows.  A boundary value travels in one 8-byte word with the
//     number of its step (double-buffered by parity), so a reader waits on
//     the word itself, without a flag or a fence; the cooperative launch
//     keeps every block resident, so the wait cannot deadlock.  The halo
//     follows the circular wrap, so any weights are served; no grid
//     barrier per step.
//
// The certificate's 16 sums (15 cut values and the dual bound) are reduced
// per block by a fixed shuffle tree into per-block partials; after a grid
// barrier every block adds the partials in block order, so every block
// takes the same stopping decision and the result does not change between
// runs (no float atomics).
//
// Bound.  A step reads x, xb, c, tau and, per family, w, sigma * w and z,
// and writes x, xb and z: (4 + 3F) values read and (2 + F) written per
// cell, 29 MB per step at 724 x 724 with F = 2 in float32, which the 50 MB
// L2 holds; a few operations per value, so schedule (a) is bound by L2
// traffic and its barrier.  Schedule (b) moves only the boundary rows
// through L2 and is bound by shared-memory traffic and the latency of the
// neighbour handshake.  PERF.md holds the measured times.
#include <cooperative_groups.h>

#include <cstdint>

#include "pfdr_common.cuh"

namespace cg = cooperative_groups;

namespace cp_pfdr {

constexpr int kCutThreads = 256;    // schedule (a)
constexpr int kCutBlocksPerSM = 4;  // (a): registers for 1024 threads an SM
constexpr int kBandThreads = 1024;  // schedule (b), one block per SM
constexpr int kThresholds = 15;
constexpr int kCutSums = kThresholds + 1;  // 15 cut values, the dual bound

enum CutSchedule { kScheduleStream = 0, kScheduleBand = 1 };

// a neighbour band that has not finished its step after this many clock
// cycles (about 20 s) never will: the launch traps instead of hanging
constexpr long long kSpinLimit = 1ll << 35;
// schedule (b) is compiled for 1 to kBandFamilies shift families
constexpr int kBandFamilies = 4;

template <typename T>
struct CutArgs {
  const T *w, *c, *tau, *sigma, *x0, *z0, *ts, *tol;
  T *x, *z, *ws, *gap_out, *tbest_out;
  int *it_out;
  int h, w_, it_max, check_every;
  int nb, hd, n_r;  // schedule (b): bands, halo depth, rows of the largest
  Shifts sh;        // as given (dy signed)
  int dyp[kMaxFamilies], dxp[kMaxFamilies];  // in [0, H) x [0, W)
  // schedule (b): column-group offset and remainder of each family's head
  // (+dx) and tail (-dx), dx taken in [0, W)
  int hq[kMaxFamilies], hr[kMaxFamilies], tq[kMaxFamilies], tr[kMaxFamilies];
};

// values of T in schedule (b)'s dynamic shared memory: xb, z, w, sigma * w
// over n_r + 2 hd rows; x, c, tau over n_r rows; the certificate's scratch
inline int64_t band_values(int w, int f, int hd, int n_r) {
  return (int64_t)w * ((int64_t)(n_r + 2 * hd) * (1 + 3 * f) + 3 * n_r) +
         32 * kCutSums + kCutSums;
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// the dual step of one edge from its tail's and head's xb.  Every
// evaluation goes through this function, so the owner and a thread that
// recomputes the edge get the same bits.
template <typename T>
__device__ __forceinline__ T dual_step(T z, T sw, T xb_tail, T xb_head) {
  T zn = z + mul_rn(sw, xb_tail - xb_head);
  zn = zn < T(-1) ? T(-1) : zn;
  return zn > T(1) ? T(1) : zn;
}

template <typename T>
__device__ __forceinline__ T primal_step(T xc, T tau, T adj, T cc) {
  T xn = xc - mul_rn(tau, adj + cc);
  xn = xn < T(0) ? T(0) : xn;
  return xn > T(1) ? T(1) : xn;
}

// next (row, column) of a walk with a fixed stride di * wd + dj (dj < wd)
// over a row-major [.., wd] field: no division per cell
__device__ __forceinline__ void walk_rc(int &i, int &j, int di, int dj,
                                        int wd) {
  i += di;
  j += dj;
  if (j >= wd) {
    j -= wd;
    ++i;
  }
}

// the same walk carrying the flat index c
__device__ __forceinline__ void walk_next(int &c, int &i, int &j, int stride,
                                          int di, int dj, int wd) {
  c += stride;
  walk_rc(i, j, di, dj, wd);
}

// adds cell (xc, cc, g = c + (K^t z)_c)'s terms to the certificate sums;
// head_x(f) is x at the head of family f's edge, we(f) its weight
template <typename T, typename HeadX, typename Weight>
__device__ __forceinline__ void certificate_terms(T (&v)[kCutSums],
                                                  const T *ts, int nf, T xc,
                                                  T cc, T g, HeadX head_x,
                                                  Weight we) {
  v[kThresholds] += g < T(0) ? g : T(0);
#pragma unroll
  for (int t = 0; t < kThresholds; ++t)
    if (xc > ts[t]) v[t] += cc;
  for (int f = 0; f < nf; ++f) {
    const T xv = head_x(f);
    const T wf = we(f);
#pragma unroll
    for (int t = 0; t < kThresholds; ++t)
      if ((xc > ts[t]) != (xv > ts[t])) v[t] += wf;
  }
}

// block partials of the certificate -> (gap, t_best) in every block, the
// partials added in block order
template <typename T>
__device__ __forceinline__ void certificate_finish(
    cg::grid_group &grid, T (&v)[kCutSums], T *scratch, T *s_tot,
    T *partials, const T *ts, T &gap, T &t_best) {
  T tot;
  block_sum_k<T, kCutSums>(v, scratch, tot);
  if (threadIdx.x < kCutSums)
    partials[blockIdx.x * kCutSums + threadIdx.x] = tot;
  grid.sync();
  if (threadIdx.x < kCutSums) {
    T s = T(0);
    for (int b = 0; b < (int)gridDim.x; ++b)
      s += __ldcg(partials + b * kCutSums + threadIdx.x);
    s_tot[threadIdx.x] = s;
  }
  __syncthreads();
  T best = s_tot[0];
  int bi = 0;
  for (int t = 1; t < kThresholds; ++t)
    if (s_tot[t] < best) {
      best = s_tot[t];
      bi = t;
    }
  gap = best - s_tot[kThresholds];
  t_best = ts[bi];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// schedule (a): stream, one grid barrier per step
// ---------------------------------------------------------------------------

// NF > 0: F known at compile time; NF == 0: F = a.sh.n
template <typename T, int NF>
__global__ void __launch_bounds__(kCutThreads, kCutBlocksPerSM)
    mincut_stream_kernel(CutArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T scratch[32 * kCutSums];
  __shared__ T s_tot[kCutSums];
  const int h = a.h, wd = a.w_, hw = h * wd;
  const int nf = NF > 0 ? NF : a.sh.n;
  const int stride = gridDim.x * blockDim.x;
  const int tid0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int di = stride / wd, dj = stride - di * wd;
  const int i0 = tid0 / wd, j0 = tid0 - i0 * wd;
  // workspace: sigma * w [F, HW], xb [2, HW], z buffer 1 [F, HW] (buffer 0
  // is the output z), the certificate's partials
  T *sw = a.ws;
  T *xbb = sw + (int64_t)nf * hw;
  T *z1 = xbb + 2 * (int64_t)hw;
  T *partials = z1 + (int64_t)nf * hw;
  T *x = a.x;

  for (int c = tid0, i = i0, j = j0; c < hw;
       walk_next(c, i, j, stride, di, dj, wd)) {
    x[c] = a.x0[c];
    xbb[c] = a.x0[c];
    for (int f = 0; f < nf; ++f) {
      const int64_t e = (int64_t)f * hw + c;
      a.z[e] = a.z0[e];
      sw[e] = mul_rn(a.sigma[e], a.w[e]);
    }
  }
  grid.sync();

  const T tol = *a.tol;
  int it = 0, st = 0;
  T gap = T(__int_as_float(0x7f800000));  // +inf
  T t_best = a.ts[0];
  while (it < a.it_max && gap > tol) {
    for (int k = 0; k < a.check_every; ++k, ++st) {
      const int p = st & 1;
      const T *xb_r = xbb + (int64_t)p * hw;
      T *xb_w = xbb + (int64_t)(1 - p) * hw;
      const T *z_r = p ? z1 : a.z;
      T *z_w = p ? a.z : z1;
      // odd steps walk the cells backwards, so that a step starts on the
      // fields the previous one touched last, which L2 still holds
      for (int q = tid0, iq = i0, jq = j0; q < hw;
           walk_next(q, iq, jq, stride, di, dj, wd)) {
        const int c = p ? hw - 1 - q : q;
        const int i = p ? h - 1 - iq : iq, j = p ? wd - 1 - jq : jq;
        const T xbc = xb_r[c];
        T acc = T(0);
#pragma unroll
        for (int f = 0; f < nf; ++f) {
          int hi = i + a.dyp[f], hj = j + a.dxp[f];
          hi -= hi >= h ? h : 0;
          hj -= hj >= wd ? wd : 0;
          int ti = i - a.dyp[f], tj = j - a.dxp[f];
          ti += ti < 0 ? h : 0;
          tj += tj < 0 ? wd : 0;
          const int u = ti * wd + tj;
          const int64_t e = (int64_t)f * hw + c;
          const int64_t e2 = (int64_t)f * hw + u;
          // the owned edge, then the in-edge (f, u) as its owner computes it
          const T zo = dual_step(z_r[e], sw[e], xbc, xb_r[hi * wd + hj]);
          z_w[e] = zo;
          const T zi = dual_step(z_r[e2], sw[e2], xb_r[u], xbc);
          acc = acc + mul_rn(a.w[e], zo) - mul_rn(a.w[e2], zi);
        }
        const T xc = x[c];
        const T xn = primal_step(xc, a.tau[c], acc, a.c[c]);
        xb_w[c] = T(2) * xn - xc;
        x[c] = xn;
      }
      grid.sync();
    }
    // certificate: the 15 threshold cuts and the dual bound
    const T *zc = (st & 1) ? z1 : a.z;
    T v[kCutSums];
#pragma unroll
    for (int t = 0; t < kCutSums; ++t) v[t] = T(0);
    for (int c = tid0, i = i0, j = j0; c < hw;
         walk_next(c, i, j, stride, di, dj, wd)) {
      T acc = T(0);
      for (int f = 0; f < nf; ++f) {
        int ti = i - a.dyp[f], tj = j - a.dxp[f];
        ti += ti < 0 ? h : 0;
        tj += tj < 0 ? wd : 0;
        const int64_t e = (int64_t)f * hw + c;
        const int64_t e2 = (int64_t)f * hw + ti * wd + tj;
        acc = acc + mul_rn(a.w[e], zc[e]) - mul_rn(a.w[e2], zc[e2]);
      }
      const T cc = a.c[c];
      certificate_terms<T>(
          v, a.ts, nf, x[c], cc, cc + acc,
          [&](int f) {
            int hi = i + a.dyp[f], hj = j + a.dxp[f];
            hi -= hi >= h ? h : 0;
            hj -= hj >= wd ? wd : 0;
            return x[hi * wd + hj];
          },
          [&](int f) { return a.w[(int64_t)f * hw + c]; });
    }
    certificate_finish<T>(grid, v, scratch, s_tot, partials, a.ts, gap,
                          t_best);
    it += a.check_every;
  }
  if (st & 1)  // the last step wrote buffer 1 (visible since the barrier)
    for (int c = tid0; c < hw; c += stride)
      for (int f = 0; f < nf; ++f)
        a.z[(int64_t)f * hw + c] = z1[(int64_t)f * hw + c];
  if (tid0 == 0) {
    *a.gap_out = gap;
    *a.tbest_out = t_best;
    *a.it_out = it;
  }
}

// ---------------------------------------------------------------------------
// schedule (b): band, the field in shared memory (float32)
// ---------------------------------------------------------------------------

// The halo exchange: a boundary value travels with the number of the step
// whose state it is, in one 8-byte word (stored and loaded whole), so a
// reader waits on the word itself: no flag, no fence.  Words of parity p
// hold the state of the steps st with st & 1 == p.
__device__ __forceinline__ unsigned long long ll_pack(float v,
                                                      unsigned tag) {
  return ((unsigned long long)tag << 32) | __float_as_uint(v);
}

__device__ __forceinline__ unsigned long long ll_load(
    const unsigned long long *p) {
  return *static_cast<const volatile unsigned long long *>(p);
}

// the value of `word`, loaded from p, once it carries `tag` (reloading p
// until it does)
__device__ __forceinline__ float ll_value(unsigned long long word,
                                          const unsigned long long *p,
                                          unsigned tag) {
  if ((unsigned)(word >> 32) != tag) {
    const long long t0 = clock64();
    do {
      if (clock64() - t0 > kSpinLimit) __trap();
      word = ll_load(p);
    } while ((unsigned)(word >> 32) != tag);
  }
  return __uint_as_float((unsigned)word);
}

// Schedule (b) works on groups of four neighbouring columns of a row:
// 16-byte shared-memory accesses, and the index arithmetic once per group.
// A family's other end lies kGroup * q + r columns away (r < kGroup), so
// its four values are taken from two groups.
constexpr int kGroup = 4;

__device__ __forceinline__ float4 ld4(const float *p) {
  return *reinterpret_cast<const float4 *>(p);
}

__device__ __forceinline__ void st4(float *p, float4 v) {
  *reinterpret_cast<float4 *>(p) = v;
}

// columns r .. r + 3 of the eight values lo.x .. lo.w, hi.x .. hi.w
__device__ __forceinline__ float4 take4(float4 lo, float4 hi, int r) {
  switch (r) {
    case 0: return lo;
    case 1: return make_float4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_float4(lo.z, lo.w, hi.x, hi.y);
    default: return make_float4(lo.w, hi.x, hi.y, hi.z);
  }
}

// the four values of row `row` (a pointer to its first column) that lie
// off columns kGroup * g .. + 3 by the shift of group offset q, remainder r
__device__ __forceinline__ float4 off4(const float *row, int g, int q, int r,
                                       int ng) {
  int g0 = g + q;
  g0 -= g0 >= ng ? ng : 0;
  const float4 lo = ld4(row + kGroup * g0);
  if (r == 0) return lo;
  const int g1 = g0 + 1 == ng ? 0 : g0 + 1;
  return take4(lo, ld4(row + kGroup * g1), r);
}

template <int NF>
__global__ void __launch_bounds__(kBandThreads, 1)
    mincut_band_kernel(CutArgs<float> a) {
  using T = float;
  using Word = unsigned long long;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = a.h, wd = a.w_, hw = h * wd, ng = wd / kGroup;
  const int hd = a.hd, nb = a.nb, n_r = a.n_r;
  const int plane = (n_r + 2 * hd) * wd;
  // shared layout: rows lr in [0, nr + 2 hd) are global rows r0 - hd + lr
  // (mod H); the band's own rows are lr in [hd, hd + nr)
  T *s_xb = reinterpret_cast<T *>(smem_raw);
  T *s_z = s_xb + plane;
  T *s_w = s_z + NF * plane;
  T *s_sw = s_w + NF * plane;
  T *s_x = s_sw + NF * plane;
  T *s_c = s_x + n_r * wd;
  T *s_tau = s_c + n_r * wd;
  T *scratch = s_tau + n_r * wd;
  T *s_tot = scratch + 32 * kCutSums;
  // global workspace: the boundary rows' words of xb [2, HW] and z
  // [2, F, HW] by parity, the certificate's partials
  Word *xbg = reinterpret_cast<Word *>(a.ws);
  Word *zg = xbg + 2 * (int64_t)hw;
  T *partials = reinterpret_cast<T *>(zg + 2 * (int64_t)NF * hw);

  const int b = blockIdx.x, t = threadIdx.x;
  const int r0 = (int)((int64_t)b * h / nb);
  const int nr = (int)((int64_t)(b + 1) * h / nb) - r0;
  const int eb = nr + 2 * hd;
  // cell walk (init, certificate) and group walk (the steps)
  const int dl = kBandThreads / wd, dj = kBandThreads - dl * wd;
  const int l0 = t / wd, j0 = t - l0 * wd;
  const int gl = kBandThreads / ng, gj = kBandThreads - gl * ng;
  const int m0 = t / ng, g00 = t - m0 * ng;
  auto grow = [&](int lr) {  // global row of shared row lr
    int g = r0 - hd + lr;
    g += g < 0 ? h : 0;
    return g >= h ? g - h : g;
  };
  auto own = [&](int lr) { return lr >= hd && lr < hd + nr; };
  // own rows whose xb and z the neighbours read: hd rows at each end
  auto boundary = [&](int lr) { return lr < 2 * hd || lr >= nr; };
  auto publish = [&](Word *dst, float4 v, unsigned tag) {
    dst[0] = ll_pack(v.x, tag);
    dst[1] = ll_pack(v.y, tag);
    dst[2] = ll_pack(v.z, tag);
    dst[3] = ll_pack(v.w, tag);
  };

  for (int lr = l0, j = j0; lr < eb; walk_rc(lr, j, dl, dj, wd)) {
    const int64_t gc = (int64_t)grow(lr) * wd + j;
    const int sc = lr * wd + j;
    s_xb[sc] = a.x0[gc];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const T wv = a.w[f * hw + gc];
      s_z[f * plane + sc] = a.z0[f * hw + gc];
      s_w[f * plane + sc] = wv;
      s_sw[f * plane + sc] = mul_rn(a.sigma[f * hw + gc], wv);
    }
    if (own(lr)) {
      const int oc = (lr - hd) * wd + j;
      s_x[oc] = a.x0[gc];
      s_c[oc] = a.c[gc];
      s_tau[oc] = a.tau[gc];
      if (boundary(lr))  // no step's tag: 0 is never waited for
        for (int p = 0; p < 2; ++p) {
          __stcg(xbg + (int64_t)p * hw + gc, ll_pack(T(0), 0u));
          for (int f = 0; f < NF; ++f)
            __stcg(zg + ((int64_t)p * NF + f) * hw + gc, ll_pack(T(0), 0u));
        }
    }
  }
  grid.sync();

  int p = 0;         // parity of the state being read
  unsigned tag = 0;  // step number of the state being written
  // dual half-step on the groups of rows [lo, hi): the band's edges, and
  // the halo edges whose head is in the band (recomputed as their owner
  // computes them)
  auto dual_rows = [&](int lo, int hi) {
    for (int lr = lo + m0, g = g00; lr < hi; walk_rc(lr, g, gl, gj, ng)) {
      const bool own_l = own(lr);
      const bool pub = own_l && boundary(lr);
      const int sc = lr * wd + kGroup * g;
      const float4 xbc = ld4(s_xb + sc);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int hrow = lr + a.sh.dy[f];
        if (!own_l && !own(hrow)) continue;
        const float4 xh = off4(s_xb + hrow * wd, g, a.hq[f], a.hr[f], ng);
        const int q = f * plane + sc;
        const float4 z4 = ld4(s_z + q), sw4 = ld4(s_sw + q);
        const float4 zn = make_float4(dual_step(z4.x, sw4.x, xbc.x, xh.x),
                                      dual_step(z4.y, sw4.y, xbc.y, xh.y),
                                      dual_step(z4.z, sw4.z, xbc.z, xh.z),
                                      dual_step(z4.w, sw4.w, xbc.w, xh.w));
        st4(s_z + q, zn);
        if (pub)
          publish(zg + ((int64_t)(1 - p) * NF + f) * hw +
                      (int64_t)grow(lr) * wd + kGroup * g,
                  zn, tag);
      }
    }
  };
  // primal half-step on the groups of the band's rows [lo, hi)
  auto primal_rows = [&](int lo, int hi) {
    for (int lr = lo + m0, g = g00; lr < hi; walk_rc(lr, g, gl, gj, ng)) {
      const int sc = lr * wd + kGroup * g;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int q = f * plane + sc;
        const float4 w4 = ld4(s_w + q), z4 = ld4(s_z + q);
        const int trow = f * plane + (lr - a.sh.dy[f]) * wd;
        const float4 wt = off4(s_w + trow, g, a.tq[f], a.tr[f], ng);
        const float4 zt = off4(s_z + trow, g, a.tq[f], a.tr[f], ng);
        acc.x = acc.x + mul_rn(w4.x, z4.x) - mul_rn(wt.x, zt.x);
        acc.y = acc.y + mul_rn(w4.y, z4.y) - mul_rn(wt.y, zt.y);
        acc.z = acc.z + mul_rn(w4.z, z4.z) - mul_rn(wt.z, zt.z);
        acc.w = acc.w + mul_rn(w4.w, z4.w) - mul_rn(wt.w, zt.w);
      }
      const int oc = (lr - hd) * wd + kGroup * g;
      const float4 xc = ld4(s_x + oc), tau4 = ld4(s_tau + oc),
                   c4 = ld4(s_c + oc);
      const float4 xn = make_float4(primal_step(xc.x, tau4.x, acc.x, c4.x),
                                    primal_step(xc.y, tau4.y, acc.y, c4.y),
                                    primal_step(xc.z, tau4.z, acc.z, c4.z),
                                    primal_step(xc.w, tau4.w, acc.w, c4.w));
      const float4 xbn = make_float4(T(2) * xn.x - xc.x, T(2) * xn.y - xc.y,
                                     T(2) * xn.z - xc.z, T(2) * xn.w - xc.w);
      st4(s_x + oc, xn);
      st4(s_xb + sc, xbn);
      if (boundary(lr))
        publish(xbg + (int64_t)(1 - p) * hw + (int64_t)grow(lr) * wd +
                    kGroup * g,
                xbn, tag);
    }
  };

  const T tol = *a.tol;
  int it = 0, st = 0;
  T gap = T(__int_as_float(0x7f800000));  // +inf
  T t_best = a.ts[0];
  while (it < a.it_max && gap > tol) {
    for (int k = 0; k < a.check_every; ++k, ++st) {
      p = st & 1;
      tag = (unsigned)(st + 1);
      if (st > 0 && hd > 0) {
        // the neighbours' boundary rows of state st: the 1 + F words of a
        // cell requested at once, then each waited for
        const Word *xsrc = xbg + (int64_t)p * hw;
        const Word *zsrc = zg + (int64_t)p * NF * hw;
        for (int q = l0, j = j0; q < 2 * hd; walk_rc(q, j, dl, dj, wd)) {
          const int lr = q < hd ? q : q + nr;
          const int64_t gc = (int64_t)grow(lr) * wd + j;
          const int sc = lr * wd + j;
          Word word[1 + NF];
          word[0] = ll_load(xsrc + gc);
#pragma unroll
          for (int f = 0; f < NF; ++f)
            word[1 + f] = ll_load(zsrc + f * (int64_t)hw + gc);
          s_xb[sc] = ll_value(word[0], xsrc + gc, (unsigned)st);
#pragma unroll
          for (int f = 0; f < NF; ++f)
            s_z[f * plane + sc] = ll_value(
                word[1 + f], zsrc + f * (int64_t)hw + gc, (unsigned)st);
        }
      }
      __syncthreads();
      dual_rows(0, eb);
      __syncthreads();
      primal_rows(hd, hd + nr);
    }
    __syncthreads();
    // certificate: x of the whole field through global memory
    for (int lr = hd + l0, j = j0; lr < hd + nr; walk_rc(lr, j, dl, dj, wd))
      __stcg(a.x + (int64_t)grow(lr) * wd + j, s_x[(lr - hd) * wd + j]);
    grid.sync();
    T v[kCutSums];
#pragma unroll
    for (int q = 0; q < kCutSums; ++q) v[q] = T(0);
    for (int lr = hd + l0, j = j0; lr < hd + nr;
         walk_rc(lr, j, dl, dj, wd)) {
      const int sc = lr * wd + j;
      T acc = T(0);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        int tc = j - a.dxp[f];
        tc += tc < 0 ? wd : 0;
        const int q = f * plane + sc;
        const int q2 = f * plane + (lr - a.sh.dy[f]) * wd + tc;
        acc = acc + mul_rn(s_w[q], s_z[q]) - mul_rn(s_w[q2], s_z[q2]);
      }
      const int oc = (lr - hd) * wd + j;
      const T cc = s_c[oc];
      certificate_terms<T>(
          v, a.ts, NF, s_x[oc], cc, cc + acc,
          [&](int f) {
            const int hrow = lr + a.sh.dy[f];
            int hc = j + a.dxp[f];
            hc -= hc >= wd ? wd : 0;
            return own(hrow) ? s_x[(hrow - hd) * wd + hc]
                             : __ldcg(a.x + (int64_t)grow(hrow) * wd + hc);
          },
          [&](int f) { return s_w[f * plane + sc]; });
    }
    certificate_finish<T>(grid, v, scratch, s_tot, partials, a.ts, gap,
                          t_best);
    it += a.check_every;
  }
  for (int lr = hd + l0, j = j0; lr < hd + nr; walk_rc(lr, j, dl, dj, wd)) {
    const int64_t gc = (int64_t)grow(lr) * wd + j;
    a.x[gc] = s_x[(lr - hd) * wd + j];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      a.z[f * hw + gc] = s_z[f * plane + lr * wd + j];
  }
  if (b == 0 && t == 0) {
    *a.gap_out = gap;
    *a.tbest_out = t_best;
    *a.it_out = it;
  }
}

// schedule (b)'s launch: exactly nb co-resident blocks of kBandThreads
// with `smem` bytes of dynamic shared memory each, or a CUDA error
template <int NF>
int band_launch(CutArgs<float> &a, size_t smem, cudaStream_t stream) {
  auto kernel = mincut_band_kernel<NF>;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void *>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void *>(kernel), kBandThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || (int64_t)per_sm * sms < a.nb)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void *args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void *>(kernel), dim3(a.nb), dim3(kBandThreads),
      args, smem, stream));
}

template <typename T>
int mincut(const T *w, const T *c, const T *tau, const T *sigma, const T *x0,
           const T *z0, const T *ts, const T *tol, T *x, T *z, T *ws,
           T *gap_out, T *tbest_out, int *it_out, int h, int w_, int f,
           const int *shifts, int it_max, int check_every, int schedule,
           int blocks, void *stream) {
  CutArgs<T> a;
  if (make_shifts(f, shifts, a.sh) != 0 || h < 1 || w_ < 1 ||
      check_every < 1 || blocks < 1)
    return -1;
  int hd = 0;
  for (int k = 0; k < f; ++k) {
    a.dyp[k] = ((a.sh.dy[k] % h) + h) % h;
    a.dxp[k] = ((a.sh.dx[k] % w_) + w_) % w_;
    const int ady = a.sh.dy[k] < 0 ? -a.sh.dy[k] : a.sh.dy[k];
    hd = ady > hd ? ady : hd;
    const int back = a.dxp[k] == 0 ? 0 : w_ - a.dxp[k];
    a.hq[k] = a.dxp[k] / kGroup;
    a.hr[k] = a.dxp[k] % kGroup;
    a.tq[k] = back / kGroup;
    a.tr[k] = back % kGroup;
  }
  a.w = w;
  a.c = c;
  a.tau = tau;
  a.sigma = sigma;
  a.x0 = x0;
  a.z0 = z0;
  a.ts = ts;
  a.tol = tol;
  a.x = x;
  a.z = z;
  a.ws = ws;
  a.gap_out = gap_out;
  a.tbest_out = tbest_out;
  a.it_out = it_out;
  a.h = h;
  a.w_ = w_;
  a.it_max = it_max;
  a.check_every = check_every;
  a.nb = blocks;
  a.hd = hd;
  a.n_r = (h + blocks - 1) / blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (schedule == kScheduleStream) {
    void *args[] = {&a};
    const int need = (h * w_ + kCutThreads - 1) / kCutThreads;
    const int grid = need < blocks ? need : blocks;
    return f == 2 ? cooperative_launch(mincut_stream_kernel<T, 2>,
                                       kCutThreads, grid, args, s, nullptr)
                  : cooperative_launch(mincut_stream_kernel<T, 0>,
                                       kCutThreads, grid, args, s, nullptr);
  }
  if constexpr (sizeof(T) == 4) {
    // every band at least hd rows (a halo lies in the two neighbours),
    // the column shifts within one wrap, at most kBandFamilies families,
    // rows of whole column groups
    if (schedule != kScheduleBand || blocks > h ||
        (int64_t)hd * blocks > h || w_ % kGroup != 0)
      return -1;
    for (int k = 0; k < f; ++k)
      if (a.sh.dx[k] <= -w_ || a.sh.dx[k] >= w_) return -1;
    const size_t smem = band_values(w_, f, hd, a.n_r) * sizeof(T);
    switch (f) {
      case 1: return band_launch<1>(a, smem, s);
      case 2: return band_launch<2>(a, smem, s);
      case 3: return band_launch<3>(a, smem, s);
      case 4: return band_launch<4>(a, smem, s);
      default: return -1;
    }
  }
  return -1;  // schedule (b) is float32 only
}

}  // namespace cp_pfdr

extern "C" {

int cp_mincut_sums() { return cp_pfdr::kCutSums; }

int cp_mincut_band_families() { return cp_pfdr::kBandFamilies; }


// bytes of schedule (b)'s dynamic shared memory (float32)
long long cp_mincut_band_bytes(int w, int f, int hd, int n_r) {
  return (long long)cp_pfdr::band_values(w, f, hd, n_r) * 4;
}

// SM count and largest opt-in shared memory per block of a device
int cp_device_limits(int dev, int *sms, int *smem_optin) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

#define CP_MINCUT_ENTRY(NAME, T)                                              \
  int NAME(const T *w, const T *c, const T *tau, const T *sigma, const T *x0, \
           const T *z0, const T *ts, const T *tol, T *x, T *z, T *ws,         \
           T *gap_out, T *tbest_out, int *it_out, int h, int w_, int f,       \
           const int *shifts, int it_max, int check_every, int schedule,      \
           int blocks, void *stream) {                                        \
    return cp_pfdr::mincut<T>(w, c, tau, sigma, x0, z0, ts, tol, x, z, ws,    \
                              gap_out, tbest_out, it_out, h, w_, f, shifts,   \
                              it_max, check_every, schedule, blocks, stream); \
  }

CP_MINCUT_ENTRY(cp_mincut_fused_f32, float)
CP_MINCUT_ENTRY(cp_mincut_fused_f64, double)

#undef CP_MINCUT_ENTRY
}
