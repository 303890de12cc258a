// Connected components of a masked [H, W] stencil graph, in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cp_pfdr_graph_d1_tpu/ops/components_fused.py
// (_fused_components_call, _kernel).  Every vertex ends with the smallest
// vertex index reachable from it over the edges whose mask is set: the
// unique fixpoint of min-label propagation, which the TPU kernel reaches by
// synchronous rounds of rolls and minimums.
//
// Design.  One cooperative launch runs the rounds until one changes no
// label, or `it_max` rounds (the vertex count) have run.  A round visits
// every cell (grid-stride), takes the minimum of its label and the labels of
// its neighbours across set edges (both directions of each shift family),
// then jumps twice through the label table (l <- min(l, lab[l])), which the
// TPU avoided only because its gathers are element-serial.  Labels are
// int32 and updated in place while other threads read them: a label only
// decreases and always names a vertex of the same component that is not
// larger than the cell, so any mix of old and new values read in a round
// keeps that invariant, and a round that changes nothing proves the
// fixpoint.  The result is the plain version's bit for bit; only the number
// of rounds differs.  A per-block "changed" vote goes to one of three round
// flags in global memory, read after the grid barrier that ends the round
// (three, so that resetting the flag of round r + 1 never races with a slow
// block still reading the flag of round r - 1).
//
// Bound.  A round reads the F mask planes (one byte per edge) and the label
// table with some random access through the jumps, and writes the labels
// that change: a few bytes per vertex per round, L2-resident up to millions
// of vertices.  Rounds needed grow with the largest component's diameter
// divided by what the jumps shortcut, so the kernel is bound by the number
// of rounds times one grid barrier plus one pass over L2.  PERF.md holds the
// measured times.
#include <cooperative_groups.h>

#include <cstdint>

#include "pfdr_common.cuh"

namespace cg = cooperative_groups;

namespace cp_pfdr {

constexpr int kCompThreads = 256;

struct CompArgs {
  const unsigned char *mask;  // [F, H * W]: edge (f, cell) present
  int *lab;                   // [H * W] labels
  int *flags;                 // [3] per-round "changed" flags
  int *rounds_out;
  int h, w, it_max;
  Shifts sh;
};

__global__ void __launch_bounds__(kCompThreads)
components_kernel(CompArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int hw = a.h * a.w;
  const int stride = gridDim.x * blockDim.x;
  const int tid0 = blockIdx.x * blockDim.x + threadIdx.x;
  volatile int *lab = a.lab;
  volatile int *flags = a.flags;

  for (int c = tid0; c < hw; c += stride) lab[c] = c;
  if (tid0 == 0) flags[0] = flags[1] = flags[2] = 0;
  grid.sync();

  int r = 0;
  bool changed = true;
  while (changed && r < a.it_max) {
    if (tid0 == 0) flags[(r + 1) % 3] = 0;
    int ch = 0;
    for (int c = tid0; c < hw; c += stride) {
      const int i = c / a.w, j = c - i * a.w;
      const int l0 = lab[c];
      int l = l0;
      for (int f = 0; f < a.sh.n; ++f) {
        const int dy = a.sh.dy[f], dx = a.sh.dx[f];
        if (a.mask[(int64_t)f * hw + c]) {
          const int lv = lab[shifted_cell(i, j, dy, dx, a.h, a.w)];
          l = lv < l ? lv : l;
        }
        const int u = shifted_cell(i, j, -dy, -dx, a.h, a.w);
        if (a.mask[(int64_t)f * hw + u]) {
          const int lu = lab[u];
          l = lu < l ? lu : l;
        }
      }
      int lj = lab[l];
      l = lj < l ? lj : l;
      lj = lab[l];
      l = lj < l ? lj : l;
      if (l < l0) {
        lab[c] = l;
        ch = 1;
      }
    }
    if (__syncthreads_or(ch) && threadIdx.x == 0) flags[r % 3] = 1;
    grid.sync();
    changed = flags[r % 3] != 0;
    ++r;
  }
  if (tid0 == 0) *a.rounds_out = r;
}

int components(const unsigned char *mask, int *lab, int *flags,
               int *rounds_out, int max_blocks, int h, int w, int f,
               const int *shifts, int it_max, void *stream) {
  CompArgs a;
  if (make_shifts(f, shifts, a.sh) != 0 || h < 1 || w < 1 || max_blocks < 1)
    return -1;
  a.mask = mask;
  a.lab = lab;
  a.flags = flags;
  a.rounds_out = rounds_out;
  a.h = h;
  a.w = w;
  a.it_max = it_max;
  void *args[] = {&a};
  const int need = (h * w + kCompThreads - 1) / kCompThreads;
  return cooperative_launch(components_kernel, kCompThreads,
                            need < max_blocks ? need : max_blocks, args,
                            static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace cp_pfdr

extern "C" {

int cp_components_fused(const unsigned char *mask, int *lab, int *flags,
                        int *rounds_out, int max_blocks, int h, int w, int f,
                        const int *shifts, int it_max, void *stream) {
  return cp_pfdr::components(mask, lab, flags, rounds_out, max_blocks, h, w,
                             f, shifts, it_max, stream);
}
}
