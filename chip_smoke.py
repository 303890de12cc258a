#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage, from the root of the repository, on a machine with a CUDA device::

    python3 chip_smoke.py

It imports nothing of JAX.  Phases, one or more lines each:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build of the hand-written kernels (``csrc/``, one ``nvcc`` per source,
   all at once) and the host C++ from the repository's sources;
3. ``stencil_fused`` against its plain PyTorch version on the 140 x 140,
   F = 2 field of the EEG-scale problem, for the four vertex proxes, in
   float64 and float32 (and ``StencilGraphD1.fused_iteration`` against the
   standalone wrapper, bit for bit), with the time per launch of both;
4. ``solve_small`` against its plain version on reduced problems of that
   problem (its first steepest cut, about 2.6k components, and a 128-block
   partition), for the dense, Gram and diagonal operators, on the
   thread-block cluster the wrapper picks and on forced ones
   (``SMALL_FORCED``: one block, 2, 4 and 8 CTAs);
5. ``mincut_fused`` against its plain version at 140 x 140, 512 x 512
   and 724 x 724 (10 % of the edges masked, standard-normal costs),
   float64 and float32, on the schedule the kernel chooses and, in
   float32, also on schedule "stream", with microseconds per step beside
   the streamed step's bound (over the L2 copy rate measured here);
6. ``components_fused`` against its plain version at the same sizes, with
   10 % and 45 % of the edges active, on four wrapped families at 140 x 140
   and 724 x 724 and on a 48 x 48 snake (``components_cases``): labels and
   component counts equal, passes, device time, time per call and host
   time;
7. ``solve_fused`` against its plain version on the EEG problem's first
   steepest cut (dense, rv_cap 4096: ``solve_fused``'s shape below dense
   rv_cap 8192, where the route sends ``solve_small``), on the call of
   the ``pfdr-mesh-banded`` path, and on reduced problems beyond
   ``solve_small``: a
   40,000-block partition of the 724 x 724 grid with the diagonal
   operator, and the EEG grid with every vertex its own component and the
   dense operator; the unmonitored ``pfdr_quadratic_d1`` on a 1448 x 1448
   banded grid in float64, whose blocks' iterates leave shared memory;
   then ``solve_small`` against ``solve_fused`` on the same
   reduced problems, ``solve_small`` on every cluster size (the crossover
   behind ``SOLVE_FUSED_MIN_RV_CAP`` and ``solve_small.cluster_size``);
8. ``stencil_fused_simplex`` against its plain version at 140 x 140,
   F = 2, K = 4 for four losses and K = 2, 3, 8, 9, 32 for two (one
   iteration in float64 and float32, a 400-iteration float64 loop of the
   solver's kernel loop at K = 4 and 9), the graph's plan path against the
   standalone wrapper, the kernel loop with monitoring, progress lines and
   reconditioning against the staged loop, and the time per call (device,
   CUDA events, host) of both;
9. ``mincut_fused`` and ``components_fused`` against their plain versions
   on the inputs the multi-label cut-pursuit path gives them (the calls of
   an expansion cut and a components call recorded from its device loop
   at 512 x 512), the cut in float32 and float64;
10. on ``bench.py:build_mesh_problem``'s Delaunay mesh (19,600 vertices,
   strip-ordered by the port's ``strip_order``): ``banded_gather`` and
   ``banded_scatter`` (and on a 4,096-vertex star, a hub of 4,096 slots;
   ``index_select`` and ``index_add_`` timed beside them, and the host
   cost of each step of their launch path, ``[banded-host]``),
   ``banded_fused``, ``circulant_fused`` (64 families and a banded
   remainder; and the 140 x 140 grid as a circulant container, no
   remainder) and ``circulant_fused_simplex`` (K = 4, four losses, and
   400-iteration float64 loops) against their plain versions, float64 and float32, with the time per
   call of both;
11. the main paths, each with the launch counters set to 0 just before it
   and read just after: ``pfdr_quadratic_d1`` on the EEG-scale stencil
   problem (3000 iterations in float32); ``api.cp_quadratic_d1_l1`` on it
   (host cut) in float32, held against the port's own float64 run on the
   CPU (after the main paths, one more run outside their counted windows
   prints each of its reduced solves: route, cluster, iterations, call
   milliseconds); the same problem through ``cut="device"`` and the
   chained loop (``bench.py``'s options), held against the same float64
   run; and the
   524k-vertex TV denoising problem of ``bench.py`` through the
   per-iteration device loop, held against its own float64 run on the card;
   the multi-label PFDR of ``bench.py:bench_simplex`` (140 x 140, K = 4,
   3000 iterations in float32, held against float64 on the card); the
   multi-label cut-pursuit of ``bench.py:bench_cut_pursuit_simplex``
   (512 x 512, K = 4, ``cut="device"``, held against float64 on the card;
   an expansion cut that leaves the card fails the run); PFDR on the mesh
   through ``api.pfdr_quadratic_d1_l1(container="auto")`` (which must
   pick the circulant container; 3000 float32 iterations, held against
   float64 on the card, and the staged COO loop timed beside it), on a
   ``BandedGraphD1`` monitored (``banded_fused``) and unmonitored (one
   ``solve_fused`` launch), and the K = 4 multi-label PFDR of
   ``bench_unstructured_simplex`` on the circulant container;
12. ``cp-reduced-options``: the EEG problem with PFDR options the
   whole-solve kernels do not serve (reconditioning; progress lines) on
   the default ``fused="auto"``: through the API's host cut and the
   device loop, their reduced problems in the staged loop, held against
   the float64 run at 1e-3; ``fused="on"`` with them raises;
   then where the time goes (``torch.profiler``);
13. slice 5, distribution: ``halo_fused`` against its plain version (one
   rank's iteration on a 512 x 2048 row block of a 2048 x 2048 field, the
   neighbours' strips cut from the plain iteration of the whole field's
   blocks, so no processes: float64 and float32, halo depth 1 and 2, the
   first, a middle and the last block), then the main path ``pfdr-halo``:
   ``parallel.pfdr_quadratic_d1_halo`` on the 2048 x 2048 field under the
   EEG operator (N = 91), 500 iterations, against the single-card
   ``stencil_fused`` solve, at P = 1 in this process (an NCCL group of one
   rank), and at P = 2 and 4 in spawned ranks that share the card over
   gloo (strips staged through pinned host memory); with two cards or
   more also one NCCL rank per card.  The same spawned ranks run the other
   distributed entries once at P = 2 against their single-card
   counterparts (``pfdr-halo-simplex``, ``pfdr-dp``, ``cp-dist``,
   ``cp-sharded``, ``cp-sharded-simplex``; cut as ``p2_cuts`` prints).
   The single-card solves these are held against run before the counted
   window, and the P = 1 busy share is profiled after it.
14. slice 11, four more main paths, their float64 references made on the
   card before the counted windows: ``cp-device-mesh`` (``cut="device"``
   cut-pursuit on the mesh as a COO ``GraphD1`` and as a
   ``BandedGraphD1``: the plain PDHG cut and components on the card, the
   banded graph's float transfers through ``banded_gather`` /
   ``banded_scatter``; at most 1e-3 above the float64 host cut; ms per CP
   iteration, PDHG steps per cut and component rounds per call);
   ``route-fallback`` (a 140 x 140 stencil of 17 shift families through
   PFDR and ``cut="device"`` cut-pursuit, K = 33 multi-label PFDR on the
   140 x 140 stencil and on the mesh's ``CirculantGraphD1``, all on the
   default options: the staged loops and plain cuts, none of the kernels
   these inputs are beyond, held against float64 at 1e-3; ``fused="on"``
   raises on each PFDR input); ``cp-duplex-device`` (the EEG problem
   through ``cut="device", duplex=True``, ``components_fused`` and the
   plain duplex cut, against the host duplex cut at 1e-3; and the
   per-iteration device loop without duplex, timed); ``checkpoint``
   (``utils.save_state`` / ``load_state`` of a float64 PFDR state resumed
   on the card bit for bit, of a cut-pursuit state, and ``utils.profile``
   leaving a trace).
15. slice 12: in the P = 2 ranks of ``pfdr-halo``, ``cp-dist-device``
   (``parallel.cp_quadratic_d1_dist`` with ``cut="device"`` on the EEG
   problem's 140 x 140 stencil in float32, the operator's rows sharded over
   the ranks: the chained loop with ``chain_options()``, then
   ``chain="off"``; the same partition and values on both ranks, the
   objective within 1e-3 relative of the float64 host cut, one card's
   ``cp_quadratic_d1`` of each timed beside it before the counted window)
   and ``example-distributed`` (``examples/torch_example_distributed.py``'s
   four paths in the same two ranks, held to the example's assertions);
   then the main path ``examples``: ``examples/torch_example_EEG_CP.py``
   and ``torch_example_labeling_CP.py`` on the card, held to the bars of
   ``tests/test_examples.py``.  The card's name and power limit stand
   beside these paths' times.

``python3 chip_smoke.py --compare`` runs only ``compare_timings`` (the
``stencil_fused_simplex`` and ``components_fused`` calls, the
``pfdr-simplex`` iterations and the two kernels' splits, then the
``circulant_fused_simplex``, ``circulant_fused`` and ``banded_fused``
calls and the two quadratic mesh solves' iterations, ``solve_small``'s 300
iterations on the main shapes, the EEG host cut, the ``mincut_fused``
steps and the banded per-call times), which an older checkout of the port
can run with its own kernels when this script is copied into its root.

The line before the last is the JSON kernel report; the last line is the
JSON result.  Any failed check raises, and the script then exits with a
non-zero code before printing either.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

V_SIDE = 140      # 140 x 140 grid: V = 19.6k, the EEG cortical-mesh size
N_OBS = 91        # EEG electrode count
LA_D1 = 2e-3
LA_L1 = 2e-3

# kernel-vs-plain tolerances.  float64: the two versions differ only by
# FMA contraction and summation order, ~1e-16 relative per operation.
# float32: the same differences at float32's 1.2e-7 epsilon, carried
# through up to a few hundred iterations of a nonexpansive iteration
F64_TOL = 1e-10
F32_TOL = 1e-4

# the card's name and power limit (nvidia-smi), set by phase_env and
# printed beside the times of the later paths
CARD = None


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def build_grid_problem(seed=7):
    """The EEG-scale fused LASSO of ``bench.py`` (``build_grid_problem``):
    dense A with N = 91 rows on a 140 x 140 grid, three constant sources."""
    h = w = V_SIDE
    v = h * w
    idx = np.arange(v).reshape(h, w)
    r = np.random.default_rng(seed)
    a = (r.standard_normal((N_OBS, v)) / np.sqrt(N_OBS)).astype(np.float32)
    x_true = np.zeros(v, np.float32)
    for _ in range(3):
        i, j = r.integers(10, h - 16, 2)
        x_true[idx[i:i + 6, j:j + 6].ravel()] = r.uniform(0.5, 2.0)
    y = (a @ x_true + 0.01 * r.standard_normal(N_OBS)).astype(np.float32)
    return a, y


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_profile(fn, reps, counts=None):
    """Device time of ``reps`` calls of ``fn`` from torch.profiler's CUDA
    activity: ``(device us per call, {kernel name: us per call}, host-clock
    us per call of the profiled window)``; ``counts``, a dict, receives
    each item's number of launches or copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6 / reps
    per = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if t > 0:
            per[ev.key] = t / reps
            if counts is not None:
                counts[ev.key] = ev.count
    return sum(per.values()), per, wall


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def vertex_proxes():
    """The four vertex proxes the stage kernels take."""
    from cp_pfdr_graph_d1_tpu_torch import VertexProx
    return [VertexProx(kind="l1"), VertexProx(kind="l1", positivity=True),
            VertexProx(kind="bounds", lo=-0.5, hi=0.8), VertexProx()]


def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    global CARD
    CARD = card
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)"
          f", device 0: {torch.cuda.get_device_name(0)}")
    print(card, flush=True)
    return card


def phase_build():
    from cp_pfdr_graph_d1_tpu_torch import _build, maxflow, native
    t0 = time.monotonic()
    _build.cuda_kernels()
    t_cuda = time.monotonic() - t0
    check(native.available(), "native PFDR did not build")
    check(maxflow._get_lib() is not None, "native min-cut did not build")
    t_all = time.monotonic() - t0
    log = _build.build_log.get("cp_pfdr_kernels", (0.0, ""))[1]
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] CUDA kernels {t_cuda:.2f} s, with host C++ {t_all:.2f} s"
          f" (nvcc for {_build.CUDA_ARCH})")
    for ln in ptxas:
        print(f"[build] ptxas: {ln}")
    sys.stdout.flush()


def stencil_setup(dtype, device):
    """State of one PFDR stage on the EEG stencil: a preconditioner from the
    problem and a random iterate and auxiliary pairs (seeded)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import DenseOp, StencilGraphD1
    from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import \
        initial_precondition
    from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
    a, y = build_grid_problem()
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=dtype, device=device)
    op = DenseOp(torch.as_tensor(a, dtype=dtype, device=device))
    obs = torch.as_tensor(y, dtype=dtype, device=device)
    la_l1 = torch.full((g.num_vertices,), LA_L1, dtype=dtype, device=device)
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    pre = initial_precondition(op, obs, g, la_l1, 1.5, lip, Lipsch.SCAL)
    r = np.random.default_rng(11)
    t = lambda z: torch.as_tensor(z, dtype=dtype, device=device)  # noqa
    x = t(np.abs(r.normal(size=g.num_vertices)) * 0.5)
    zu = t(r.normal(size=g.num_edges) * 0.5)
    zv = t(r.normal(size=g.num_edges) * 0.5)
    grad = op.grad(x, obs)
    return g, pre, x, grad, zu, zv


def phase_stencil(device="cuda"):
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused as sf
    # absolute error of the fields x, zu, zv; relative error of the sums
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    rel_errs = {torch.float64: 0.0, torch.float32: 0.0}
    times = {}
    for dtype in (torch.float64, torch.float32):
        g, pre, x, grad, zu, zv = stencil_setup(dtype, device)
        h, w = g.field_shape
        f = len(g.shifts)
        args = (x.reshape(h, w), grad.reshape(h, w), pre.ga.reshape(h, w),
                pre.th_l1.reshape(h, w)) + tuple(
            a.reshape(f, h, w) for a in (zu, zv, pre.wu, pre.wv, pre.w_d1u,
                                         pre.w_d1v, pre.th_d1))
        for vp in vertex_proxes():
            kw = dict(shifts=g.shifts, rho=1.5, vkind=vp.kind,
                      positivity=vp.positivity, lo=float(vp.lo),
                      hi=float(vp.hi))
            out_k, same = twice_equal(
                lambda: sf.fused_stencil_iteration(*args, **kw))
            out_p = sf.stencil_iteration_plain(*args, **kw)
            if device == "cuda":
                check(out_k[0].is_cuda, "kernel output not on the card")
            # the plan path on the graph ([V] and [E] rows) gives the
            # standalone wrapper's bits
            out_g = g.fused_iteration(x, grad, pre, zu, zv, 1.5, vp)
            check(all(torch.equal(a.reshape(-1), b.reshape(-1))
                      for a, b in zip(out_g, out_k)),
                  f"stencil_fused {dtype} {vp.kind}: fused_iteration "
                  f"differs from the standalone wrapper")
            err = max(max_err(k, p) for k, p in zip(out_k[:3], out_p[:3]))
            rel = max(max_err(k, p) / max(1.0, float(p.abs()))
                      for k, p in zip(out_k[3:], out_p[3:]))
            errs[dtype] = max(errs[dtype], err)
            rel_errs[dtype] = max(rel_errs[dtype], rel)
            tol = F64_TOL if dtype == torch.float64 else F32_TOL
            name = f"{vp.kind}{'+pos' if vp.positivity else ''}"
            check(err <= tol, f"stencil_fused {dtype} {name}: x/zu/zv abs "
                  f"err {err:.3g} > {tol}")
            check(rel <= tol, f"stencil_fused {dtype} {name}: num/den rel "
                  f"err {rel:.3g} > {tol}")
            check(same, f"stencil_fused {dtype} {name}: two calls differ")
            print(f"[stencil_fused] {str(dtype)[6:]} {vp.kind:6s} "
                  f"pos={int(vp.positivity)} x/zu/zv max|kernel-plain| = "
                  f"{err:.3e}, num/den max|kernel-plain|/max(1,|plain|) = "
                  f"{rel:.3e} (tol {tol:g}), two calls bit-equal, "
                  f"fused_iteration bit-equal")
        if dtype == torch.float32 and device == "cuda":
            kw = dict(shifts=g.shifts, rho=1.5, vkind="l1", positivity=True,
                      lo=-np.inf, hi=np.inf)
            def kern():
                return sf.fused_stencil_iteration(*args, **kw)

            def plain():
                return sf.stencil_iteration_plain(*args, **kw)

            times["ms"] = cuda_ms(kern, 500)
            times["plain_ms"] = cuda_ms(plain, 200)
            counts = {}
            dev_k, per_k, _ = device_profile(kern, 200, counts)
            dev_p, per_p, _ = device_profile(plain, 200)
            times["device_us"], times["plain_device_us"] = dev_k, dev_p
            times["host_us"] = host_us(kern)
            # one kernel, launched once a call (the profiler may drop an
            # event at the start of its window, never add one)
            check(len(per_k) == 1 and 0 < max(counts.values()) <= 200,
                  f"stencil_fused: not one launch a stage: {counts}")
            print(f"[stencil_fused] float32 {h}x{w} F={f} l1+pos, per call: "
                  f"kernel {times['ms'] * 1e3:.2f} us between CUDA events "
                  f"({dev_k:.2f} us of device time, one launch: "
                  f"{counts}), {times['host_us']:.2f} us of host time "
                  f"(10,000 calls); plain {times['plain_ms'] * 1e3:.2f} us "
                  f"({dev_p:.2f} us of device time, {len(per_p)} distinct "
                  f"kernels)")
    sys.stdout.flush()
    return errs, rel_errs, times


@functools.lru_cache(maxsize=None)
def first_cut_partition():
    """Labels and contracted graph of the EEG problem's first steepest cut
    (float64 on the host, as the cut-pursuit loop computes it)."""
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as cp
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import (
        build_reduced_graph, connected_components)
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    a, y = build_grid_problem()
    a64, y64 = a.astype(np.float64), y.astype(np.float64)
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=torch.float64, device="cpu")
    eu, ev, la = g.host_coo()
    v = g.num_vertices
    la_l1 = np.full(v, LA_L1)
    a1 = a64.sum(axis=1)
    ry1, raa1, rl1 = float(a1 @ y64), float(a1 @ a1), float(la_l1.sum())
    x1 = (ry1 - rl1) / raa1 if ry1 > rl1 else 0.0
    x_full = np.full(v, x1)
    dfs = a64.T @ (a64 @ x_full - y64) + np.sign(x_full) * la_l1
    active, _ = cp._steepest_cut(dfs, x_full, eu, ev, la,
                                 np.zeros(len(eu), bool), la_l1, True,
                                 -np.inf, np.inf, False)
    num_comp, cv = connected_components(v, eu, ev, ~active & (la > 0))
    rg = build_reduced_graph(cv, num_comp, eu, ev, la, active, 1e-16)
    return cv, rg, eu, ev, la


def block_partition(eu, ev, la, rows=8, cols=16):
    """A partition of the grid into rows x cols rectangular blocks."""
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import \
        build_reduced_graph
    i, j = np.divmod(np.arange(V_SIDE * V_SIDE), V_SIDE)
    cv = ((i * rows) // V_SIDE * cols + (j * cols) // V_SIDE).astype(np.int32)
    active = cv[eu] != cv[ev]
    return cv, build_reduced_graph(cv, rows * cols, eu, ev, la, active,
                                   1e-16)


def small_inputs(kind, cv, rg, dtype, device, sort_edges=False):
    """Kernel inputs of one reduced problem, prepared as the cut-pursuit
    route prepares them (``_reduce_solve_small``; ``sort_edges`` for
    ``solve_fused``)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import GraphD1, VertexProx
    from cp_pfdr_graph_d1_tpu_torch.operators import DenseOp, DiagOp, GramOp
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as cp
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import (
        bucket, pad_reduced_graph)
    a, y = build_grid_problem()
    t = lambda z: torch.as_tensor(z, dtype=dtype, device=device)  # noqa
    num_comp = rg.num_components
    rv_cap = max(bucket(num_comp), 128)
    reu, rev, rla = pad_reduced_graph(rg, rv_cap, max(bucket(len(rg.eu)),
                                                      128))
    g = GraphD1.create(reu, rev, rla, num_vertices=rv_cap, dtype=dtype,
                       device=device)
    cv_t = torch.as_tensor(cv, device=device)
    if kind == "diag":
        mat, ry, lip = cp._reduce_diag(t((a * a).sum(axis=0)), t(a.T @ y),
                                       cv_t, rv_cap)
        r_op = DiagOp(mat)
    else:
        mat, ry, lip = cp._reduce_dense(t(a), t(y), cv_t, rv_cap,
                                        kind == "gram")
        r_op = GramOp(mat) if kind == "gram" else DenseOp(mat)
    r_la_l1 = np.zeros(rv_cap)
    np.add.at(r_la_l1, cv, LA_L1)
    x0 = t(np.r_[np.full(num_comp, 0.01), np.zeros(rv_cap - num_comp)])
    args, _ = cp.kernel_solve_inputs(
        r_op, mat, ry, lip, g, t(r_la_l1), x0, num_comp,
        vprox=VertexProx(kind="l1", positivity=True), rho=1.5, dif_tol=0.0,
        sort_edges=sort_edges)
    return args, num_comp


def solve_kw(dtype, rv):
    """Options of a kernel-vs-plain reduced solve: float64 stops on the
    evolution test (iteration counts compared exactly), float32 runs a
    fixed 300 iterations."""
    import torch
    if dtype == torch.float64:
        kw = dict(it_max=3000, dif_tol2=1e-14, eps=1e-7)
    else:
        kw = dict(it_max=300, dif_tol2=0.0,
                  eps=float(np.finfo(np.float32).eps))
    kw.update(rv=rv, rho=1.5, vkind="l1", positivity=True, lo=-np.inf,
              hi=np.inf)
    return kw


# forced cluster sizes held against the plain version beside the chosen
# one: (partition, kind, cluster); partition 0 is the first cut
SMALL_FORCED = ((0, "dense", 1), (0, "dense", 4), (0, "dense", 8),
                (1, "dense", 2), (1, "gram", 4))


def phase_solve_small(device="cuda"):
    """``solve_small`` against its plain version on the two partitions, for
    the three operators, float64 (equal iteration counts, F64_TOL) and
    float32 (300 iterations, F32_TOL), on the cluster the wrapper picks and
    on the forced schedules of ``SMALL_FORCED``; float32 dense times per
    300 iterations of both partitions."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    cv1, rg1, eu, ev, la = first_cut_partition()
    parts = ((cv1, rg1), block_partition(eu, ev, la))
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    times = {}
    runs = [(i, kind, None) for i in range(2)
            for kind in ("dense", "gram", "diag")] + list(SMALL_FORCED)
    for dtype in (torch.float64, torch.float32):
        for i, kind, cluster in runs:
            cv, rg = parts[i]
            args, rv = small_inputs(kind, cv, rg, dtype, device)
            kw = solve_kw(dtype, rv)
            xk, zk, itk, _ = ss._solve(cluster, *args, **kw)
            xp, zp, itp, _ = ss.solve_small_plain(*args, **kw)
            err = max(max_err(xk, xp), max_err(zk, zp))
            errs[dtype] = max(errs[dtype], err)
            tol = F64_TOL if dtype == torch.float64 else F32_TOL
            rv_cap = args[5].shape[0]
            n_rows = args[1].shape[0] if kind == "dense" else 0
            c = cluster or ss.cluster_size(kind, rv_cap, n_rows, dtype)
            name = f"solve_small {kind} rv={rv} {dtype} C={c}"
            check(int(itk) == int(itp), f"{name}: it {int(itk)} vs plain "
                  f"{int(itp)}")
            check(err <= tol, f"{name}: err {err:.3g} > {tol}")
            forced = "" if cluster is None else " (forced)"
            line = (f"[solve_small] {str(dtype)[6:]} {kind:5s} rv={rv:5d}"
                    f" rv_cap={rv_cap} e={args[8].shape[0]} C={c}{forced}"
                    f" it={int(itk)} max|kernel-plain| = {err:.3e} "
                    f"(tol {tol:g})")
            if dtype == torch.float32 and kind == "dense" and \
                    cluster is None and device == "cuda":
                ms = cuda_ms(lambda: ss.fused_pfdr_solve_small(
                    *args, **kw), 5)
                plain_ms = cuda_ms(lambda: ss.solve_small_plain(
                    *args, **kw), 2)
                times.setdefault("ms", {})[rv] = ms
                times.setdefault("plain_ms", {})[rv] = plain_ms
                times.setdefault("cluster", {})[rv] = c
                times.setdefault("dims", {})[rv] = (
                    rv_cap, args[8].shape[0], args[1].shape[0])
                line += (f"; {kw['it_max']} iterations: kernel "
                         f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
            print(line, flush=True)
    return errs, times


def objective(x, a, y, eu, ev, la):
    x = np.asarray(x, np.float64)
    r = a.astype(np.float64) @ x - y.astype(np.float64)
    return (0.5 * r @ r + np.sum(la * np.abs(x[eu] - x[ev]))
            + LA_L1 * np.sum(np.abs(x)))


def phase_pfdr(device="cuda", iters=3000):
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (DenseOp, PFDROptions,
                                            StencilGraphD1, VertexProx,
                                            pfdr_quadratic_d1)
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused as sf
    a, y = build_grid_problem()
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    dtype = torch.float32
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=dtype, device=device)
    op = DenseOp(torch.as_tensor(a, device=device))
    obs = torch.as_tensor(y, device=device)
    la_l1 = torch.full((g.num_vertices,), LA_L1, dtype=dtype, device=device)
    vprox = VertexProx(kind="l1", positivity=True)

    def solve(fused, it_max=iters):
        opt = PFDROptions(rho=1.5, dif_tol=0.0, it_max=it_max, fused=fused)
        return pfdr_quadratic_d1(op, obs, g, la_l1=la_l1, vprox=vprox,
                                 lipsch=lip, opt=opt)

    before = sf.fused_stencil_iteration.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve("auto")
    x = res.x.cpu()
    dt = time.perf_counter() - t0
    grew = sf.fused_stencil_iteration.launches - before
    check(grew == iters, f"stencil_fused launched {grew} times in a "
          f"{iters}-iteration solve")
    check(res.it == iters and bool(torch.isfinite(x).all()),
          "PFDR result not finite or short")
    n_edges = 2 * V_SIDE * (V_SIDE - 1)  # nonzero-weight grid edges
    print(f"[pfdr] float32 {V_SIDE}x{V_SIDE} N={N_OBS}, {iters} iterations "
          f"through "
          f"stencil_fused: {dt * 1e6 / iters:.2f} us/iteration, "
          f"{n_edges * iters / dt:.4g} edge-updates/s (launches +{grew})",
          flush=True)
    # the same solve through the staged PyTorch loop (no kernel)
    t0 = time.perf_counter()
    x_staged = solve("off").x.cpu()
    dt_staged = time.perf_counter() - t0
    eu, ev, la = g.host_coo()
    f_k = objective(x.numpy(), a, y, eu, ev, la.astype(np.float64))
    f_s = objective(x_staged.numpy(), a, y, eu, ev, la.astype(np.float64))
    check(abs(f_k - f_s) <= 1e-4 * abs(f_s),
          f"fused and staged PFDR objectives differ: {f_k} vs {f_s}")
    print(f"[pfdr] staged loop (no kernel): {dt_staged * 1e6 / iters:.2f} "
          f"us/iteration; objective fused {f_k:.7g} vs staged {f_s:.7g}, "
          f"max|x diff| {float((x - x_staged).abs().max()):.3e}", flush=True)
    return dt * 1e6 / iters


def run_cp(graph, a, y, dtype, device, host_small="auto", verbose=0):
    import torch
    from cp_pfdr_graph_d1_tpu_torch import api
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as cp
    if host_small == "auto":
        return api.cp_quadratic_d1_l1(
            y, a, None, None, None, La_l1=np.full(a.shape[1], LA_L1, dtype),
            positivity=True, CP_difTol=1e-4, CP_itMax=15, PFDR_rho=1.5,
            PFDR_difTol=1e-7, PFDR_itMax=10_000, graph=graph, device=device,
            verbose=verbose)
    # the float64 CPU reference: reduced problems of at most 1024
    # components go to the native host PFDR
    opt = dataclasses.replace(
        api._cp_options(1e-4, 15, 1.5, 1e-3, 0.0, 1e-7, 10_000, 0),
        host_small=host_small)
    res = cp.cp_quadratic_d1(
        cp.DenseOp(torch.as_tensor(a, device=device)),
        torch.as_tensor(y, device=device), graph,
        la_l1=np.full(a.shape[1], LA_L1), positivity=True, opt=opt)
    return api.CPOutput(res.cv, res.rx, res.it, res.time, res.obj, res.dif,
                        res.state)


def eeg_host_cut(device="cuda"):
    """``(graph, a, y)`` of the EEG problem's host cut in float32."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    a, y = build_grid_problem()
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=torch.float32, device=device)
    return g, a, y


def eeg_host_cut_runs(g, a, y, device="cuda"):
    """One warm-up run of the EEG host cut (its progress lines give the
    components per CP iteration), then two timed runs: returns ``(best
    seconds, warm-up seconds, last output, components)``."""
    import torch
    runs = []
    for k in range(3):
        torch.cuda.synchronize()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = run_cp(g, a, y, np.float32, device, verbose=int(k == 0))
        runs.append((time.perf_counter() - t0, out))
        if k == 0:
            comps = [int(ln.split(":")[1].split()[0])
                     for ln in buf.getvalue().splitlines()
                     if ln.startswith("CP it")]
    return min(t for t, _ in runs[1:]), runs[0][0], runs[-1][1], comps


def phase_cp(device="cuda"):
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    g, a, y = eeg_host_cut(device)
    before = ss.fused_pfdr_solve_small.launches
    t_best, t_warm, out, comps = eeg_host_cut_runs(g, a, y, device)
    grew = ss.fused_pfdr_solve_small.launches - before
    check(grew > 0, "solve_small was not launched by the cut-pursuit run")
    x = out.rX[out.Cv]
    check(np.all(np.isfinite(x)) and x.shape == (V_SIDE * V_SIDE,),
          "cut-pursuit result not finite or of the wrong shape")
    print(f"[cp] float32 on the card: min of two warm runs "
          f"{t_best * 1e3:.1f} ms (warm-up {t_warm * 1e3:.1f} ms); "
          f"{out.it} CP iterations, {len(out.rX)} components, "
          f"solve_small launches +{grew}", flush=True)
    print(f"[cp] components per CP iteration: {comps}", flush=True)

    g64 = StencilGraphD1.create((V_SIDE, V_SIDE),
                                {(0, 1): LA_D1, (1, 0): LA_D1},
                                dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    ref = run_cp(g64, a.astype(np.float64), y.astype(np.float64),
                 np.float64, "cpu", host_small="on")
    t_ref = time.perf_counter() - t0
    eu, ev, la = g64.host_coo()
    f_gpu = objective(x, a, y, eu, ev, la)
    f_ref = objective(ref.rX[ref.Cv], a, y, eu, ev, la)
    print(f"[cp] objective: card float32 {f_gpu:.7g}, CPU float64 "
          f"{f_ref:.7g} ({ref.it} CP iterations, {len(ref.rX)} components,"
          f" {t_ref:.1f} s on the host)", flush=True)
    check(f_gpu <= f_ref * (1 + 1e-3),
          f"card objective {f_gpu} worse than the CPU float64 run {f_ref} "
          f"by more than 1e-3 relative")
    return t_best, f_ref


def eeg_reduced_solves(device="cuda"):
    """One more run of the EEG host cut, outside the counted windows, with
    each reduced solve recorded (:func:`record_reduced_solves`) and printed
    with the cluster ``solve_small`` takes; returns the records."""
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    g, a, y = eeg_host_cut(device)
    _, rec = record_reduced_solves(
        lambda: run_cp(g, a, y, np.float32, device))
    for k, r in enumerate(rec):
        r["cluster"] = (ss.cluster_size(r["kind"], r["rv_cap"], r["n_rows"],
                                        r.pop("dtype"))
                        if r["route"] == "solve_small" else None)
        print(f"[cp] reduced solve {k}: rv={r['rv']} rv_cap={r['rv_cap']} "
              f"e={r['e']} {r['kind']} {r['route']}"
              f"{'' if r['cluster'] is None else ' C=' + str(r['cluster'])}"
              f" it={r['it']} call {r['call_ms']:.3f} ms", flush=True)
    print_route_totals("[cp]", rec)
    return rec


def print_route_totals(tag, rec):
    for route in ("solve_small", "solve_fused"):
        mine = [r for r in rec if r["route"] == route]
        print(f"{tag} {route}: {len(mine)} launches, "
              f"{sum(r['call_ms'] for r in mine):.3f} ms of calls in a run",
              flush=True)


def record_reduced_solves(run):
    """``(run(), records)``: ``run`` with the cut-pursuit route's two
    whole-solve wrappers wrapped, one record per reduced solve (kind, rv,
    rv_cap, operator rows, dtype, edges, route, iterations, and the call's
    milliseconds between CUDA events around the wrapper: its input
    preparation, the launch and the output allocations)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as cp
    rec = []

    def wrap(route, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            stop.synchronize()
            kind, rv_cap = args[0], args[5].shape[0]
            n_rows = args[1].shape[0] if kind == "dense" else 0
            rec.append(dict(
                kind=kind, rv=kw["rv"], rv_cap=rv_cap, n_rows=n_rows,
                dtype=args[5].dtype, e=args[8].shape[0], route=route,
                it=int(out[2]), call_ms=start.elapsed_time(stop)))
            return out
        return call

    saved = cp.fused_pfdr_solve_small, cp.fused_pfdr_solve
    cp.fused_pfdr_solve_small = wrap("solve_small", saved[0])
    cp.fused_pfdr_solve = wrap("solve_fused", saved[1])
    try:
        return run(), rec
    finally:
        cp.fused_pfdr_solve_small, cp.fused_pfdr_solve = saved


# ---------------------------------------------------------------------------
# slice 2: the device cut, the components, the large reduced solve
# ---------------------------------------------------------------------------

SIDE_524K = 724   # bench.py:bench_cut_pursuit_device, V = 524,176
CUT_TOL = 1e-6
# the card's published peaks (H100 SXM data sheet, 700 W): memory rate,
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def counters():
    """Launch counter of each kernel wrapper, by kernel name."""
    from cp_pfdr_graph_d1_tpu_torch.ops import (banded, banded_fused,
                                                circulant_fused,
                                                circulant_fused_simplex,
                                                components_fused,
                                                halo_fused, mincut_fused,
                                                solve_fused, solve_small,
                                                stencil_fused,
                                                stencil_fused_simplex)
    return {"stencil_fused": stencil_fused.fused_stencil_iteration,
            "solve_small": solve_small.fused_pfdr_solve_small,
            "mincut_fused": mincut_fused.fused_pdhg_min_cut,
            "components_fused": components_fused.fused_components,
            "solve_fused": solve_fused.fused_pfdr_solve,
            "stencil_fused_simplex":
                stencil_fused_simplex.fused_stencil_simplex_iteration,
            "banded_gather": banded.banded_gather,
            "banded_scatter": banded.banded_scatter,
            "banded_fused": banded_fused.fused_banded_iteration,
            "circulant_fused": circulant_fused.fused_circulant_iteration,
            "circulant_fused_simplex":
                circulant_fused_simplex.fused_circulant_simplex_iteration,
            "halo_fused": halo_fused.halo_fused_iteration}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def masked_stencil(side, dtype, device, frac, seed, weight=0.35):
    """A side x side, F = 2 stencil with ``frac`` of its edges active
    (seeded), as a cut-pursuit iteration masks them."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    g = StencilGraphD1.create((side, side), {(0, 1): weight, (1, 0): weight},
                              dtype=dtype, device=device)
    r = np.random.default_rng(seed)
    active = torch.as_tensor(r.random(g.num_edges) < frac, device=device)
    return g, active, r


MINCUT_SIDES = (V_SIDE, 512, SIDE_524K)   # EEG, multi-label CP, 524k CP


def l2_rate(device="cuda", nbytes=8 << 20, copies=50):
    """Bytes per second of device-to-device copies of an ``nbytes`` buffer
    that the 50 MB L2 holds (read and write counted), replayed from a CUDA
    graph so that the host does not pace them: the rate against which
    schedule "stream" of ``mincut_fused`` is bound."""
    import torch
    src = torch.ones(nbytes // 4, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            dst.copy_(src)
    ms = cuda_ms(graph.replay, 10) / copies
    return 2 * nbytes / (ms * 1e-3)


def mincut_step_bytes(v, f, itemsize):
    """Bytes one PDHG step moves when every field streams: x, xb, c, tau
    and per family w, sigma * w, z read; x, xb and per family z
    written."""
    return itemsize * v * ((4 + 3 * f) + (2 + f))


def phase_mincut(device="cuda"):
    """``mincut_fused`` against its plain version on one steepest cut at
    140 x 140, 512 x 512 and 724 x 724: 10 % of the edges active,
    standard-normal costs (seed 0).  Both runs must be certified and their
    cuts' values agree within twice the certificate (a min-cut need not be
    unique); in float64 the step counts are equal and the iterates agree to
    F64_TOL.  In float32 only the certificate and the cut value are held:
    the relaxed iterates drift by rounding over thousands of steps without
    changing the certified cut.  The schedule the kernel takes is printed
    with the microseconds per step; in float32 schedule "stream" is also
    run, held and timed beside it, with its bound per step (the bytes a
    streamed step moves over the L2 copy rate)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.maxflow.device import cut_value
    from cp_pfdr_graph_d1_tpu_torch.ops import mincut_fused as mf
    rate = l2_rate(device)
    print(f"[mincut_fused] L2-resident copy: {rate / 1e12:.3f} TB/s (8 MB, "
          f"read + write)", flush=True)
    errs, out = {}, {}
    for side in MINCUT_SIDES:
        for dtype in (torch.float64, torch.float32):
            g, active, r = masked_stencil(side, dtype, device, 0.1, 0)
            cost = torch.as_tensor(r.standard_normal(g.num_vertices),
                                   dtype=dtype, device=device)
            args, _ = mf.cut_problem(g, torch.where(active, 0.0, g.la_d1),
                                     cost, CUT_TOL)
            kw = dict(shifts=g.shifts, check_every=250)
            res_p = mf.pdhg_min_cut_plain(*args, 100_000, **kw)
            eu, ev, _ = g.host_coo()
            w = args[0].reshape(-1).cpu().numpy()
            c = args[1].reshape(-1).cpu().numpy()
            tol = float(args[6])
            chosen = mf.choose_schedule(side, side, g.shifts, dtype,
                                        *mf.device_limits(device))[0]
            scheds = [chosen] + (["stream"] if chosen != "stream" else [])
            val_p = cut_value(eu, ev, w, c, (res_p[0] > res_p[3]).reshape(-1)
                              .cpu().numpy())
            it_p = int(res_p[4])
            check(float(res_p[2]) <= tol, f"mincut {side} {dtype}: plain "
                  f"gap {float(res_p[2]):.4g} above {tol:.4g}")
            plain_ms = cuda_ms(
                lambda: mf.pdhg_min_cut_plain(*args, 100_000, **kw), 1)
            for sched in scheds:
                res_k = mf.fused_pdhg_min_cut(*args, 100_000, schedule=sched,
                                              **kw)
                check(mf.fused_pdhg_min_cut.last_schedule == sched,
                      f"mincut {side} {dtype}: ran "
                      f"{mf.fused_pdhg_min_cut.last_schedule}, not {sched}")
                x, _, gap, t_best, it = res_k
                it = int(it)
                check(float(gap) <= tol, f"mincut {side} {dtype} {sched}: "
                      f"gap {float(gap):.4g} above the certificate "
                      f"{tol:.4g}")
                val = cut_value(eu, ev, w, c, (x > t_best).reshape(-1)
                                .cpu().numpy())
                check(abs(val - val_p) <= 2 * tol, f"mincut {side} {dtype} "
                      f"{sched}: cut values {val} vs plain {val_p}")
                err = max(max_err(res_k[0], res_p[0]),
                          max_err(res_k[1], res_p[1]))
                if dtype == torch.float64:
                    check(it == it_p, f"mincut {side}: {it} steps vs plain "
                          f"{it_p}")
                    check(err <= F64_TOL, f"mincut {side} float64: x/z err "
                          f"{err:.3g}")
                ms = cuda_ms(lambda: mf.fused_pdhg_min_cut(
                    *args, 100_000, schedule=sched, **kw), 5)
                us_step = ms * 1e3 / it
                bound_us = (mincut_step_bytes(g.num_vertices, len(g.shifts),
                                              args[0].element_size())
                            / rate * 1e6)
                if sched == chosen:
                    errs[(side, dtype)] = err
                    out[(side, dtype)] = dict(
                        ms=ms, plain_ms=plain_ms, it=it, schedule=sched,
                        us_per_step=us_step, v=g.num_vertices,
                        f=len(g.shifts), stream_bound_us_per_step=bound_us)
                else:
                    out[(side, dtype)]["stream_us_per_step"] = us_step
                tag = " (chosen)" if sched == chosen else ""
                print(f"[mincut_fused] {str(dtype)[6:]} {side}x{side} F=2 "
                      f"schedule {sched}{tag}: certified cut in {it} steps (plain {it_p}), cut "
                      f"value {val:.9g} vs plain {val_p:.9g} (tol "
                      f"{2 * tol:.3g}), x/z max|kernel-plain| {err:.3e}; "
                      f"{ms:.3f} ms per cut ({us_step:.2f} us per step; "
                      f"streamed step bound {bound_us:.2f} us), plain "
                      f"{plain_ms:.1f} ms", flush=True)
    return errs, out


def snake_mask(side, device):
    """A side x side, F = 2 mask whose set edges form one path through
    every cell (a boustrophedon: each row's horizontal edges, and one
    vertical edge at alternating ends), the longest diameter a component
    of the field can have (V - 1)."""
    import torch
    m = np.zeros((2, side, side), bool)
    m[0, :, :-1] = True
    m[1, 0:side - 1:2, side - 1] = True
    m[1, 1:side - 1:2, 0] = True
    return torch.as_tensor(m, device=device)


def components_cases(device):
    """``(name, mask, shifts)`` of phase_components: 140 x 140 (the EEG
    chain's field), 512 x 512 (the multi-label CP's) and 724 x 724 (the
    524k CP's), F = 2, non-wrapping, 10 % and 45 % of the edges active (the
    mask keeps the inactive nonzero-weight edges, as a cut-pursuit
    iteration does); four families (with (1, 1) and (1, -1)) on a field
    that wraps on both axes at 140 x 140 and 724 x 724; the 48 x 48
    snake."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    cases = []
    for side in MINCUT_SIDES:
        for frac in (0.1, 0.45):
            g, active, _ = masked_stencil(side, torch.float32, device, frac,
                                          1)
            mask = (~active & (g.la_d1 > 0)).reshape(2, side, side)
            cases.append((f"{side}x{side} {frac:.0%}", mask.contiguous(),
                          g.shifts))
    four = {(0, 1): 0.3, (1, 0): 0.3, (1, 1): 0.2, (1, -1): 0.2}
    for side in (V_SIDE, SIDE_524K):
        g = StencilGraphD1.create((side, side), four, wrap=(True, True),
                                  dtype=torch.float32, device=device)
        r = np.random.default_rng(2)
        active = torch.as_tensor(r.random(g.num_edges) < 0.45, device=device)
        mask = (~active & (g.la_d1 > 0)).reshape(4, side, side)
        cases.append((f"{side}x{side} F=4 wrapped 45%", mask.contiguous(),
                      g.shifts))
    cases.append(("48x48 snake", snake_mask(48, device), ((0, 1), (1, 0))))
    return cases


def components_call_times(fn):
    """Device time (torch.profiler, 50 calls), per call between CUDA events
    (50 calls) and the host clock over 200 calls (fewer than the launch
    queue holds, so the host does not wait on the card) of ``fn``."""
    counts = {}
    dev, per, _ = device_profile(fn, 50, counts)
    kernels = {re.sub(r"^cp_pfdr::|\(.*$", "", k): f"{us:.2f} us x "
               f"{counts[k] / 50:g}" for k, us in per.items()}
    return dict(device_us=dev, ms=cuda_ms(fn, 50), host_us=host_us(fn, 200),
                kernels=kernels)


def phase_components(device="cuda"):
    """``components_fused`` against its plain version on
    ``components_cases``: labels and component counts equal bit for bit
    (the fixpoint is unique); the kernel's passes beside the plain
    version's rounds, and its times (``components_call_times``)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import components_fused as cf
    out = {}
    for name, mask, shifts in components_cases(device):
        f, h, w = mask.shape
        kw = dict(shifts=shifts, it_max=h * w)
        lab_k, passes = cf.fused_components(mask, **kw)
        lab_p, rounds_p = cf.components_plain(mask, **kw)
        iota = torch.arange(h * w, device=device)
        n_k = int((lab_k.reshape(-1) == iota).sum())
        n_p = int((lab_p.reshape(-1) == iota).sum())
        check(lab_k.dtype == torch.int32 and bool((lab_k == lab_p).all())
              and n_k == n_p, f"components {name}: labels differ ({n_k} vs "
              f"{n_p} components)")
        t = (components_call_times(lambda: cf.fused_components(mask, **kw))
             if device == "cuda" else dict(device_us=0.0, ms=0.0,
                                           host_us=0.0, kernels={}))
        plain_ms = (cuda_ms(lambda: cf.components_plain(mask, **kw), 2)
                    if device == "cuda" else 0.0)
        out[name] = dict(t, plain_ms=plain_ms, passes=int(passes),
                         plain_rounds=int(rounds_p), v=h * w, f=f,
                         components=n_k)
        print(f"[components_fused] {name}: {n_k} components, labels equal "
              f"to the plain version's; {int(passes)} passes (plain "
              f"{int(rounds_p)} rounds); {t['device_us']:.2f} us of device "
              f"time ({t['kernels']}), {t['ms'] * 1e3:.2f} us per call "
              f"(CUDA events), {t['host_us']:.2f} us of host time; plain "
              f"{plain_ms:.2f} ms", flush=True)
    return out


def block_labels(side, blocks):
    """A partition of a side x side grid into blocks x blocks rectangles."""
    i, j = np.divmod(np.arange(side * side), side)
    return ((i * blocks) // side * blocks + (j * blocks) // side)


def reduced_inputs(kind, dtype, device):
    """Kernel inputs of a reduced problem beyond ``solve_small``, prepared
    by the device route's own functions: "diag", the 524k denoising
    problem on 40,000 blocks; "dense", the EEG problem with every vertex
    its own component."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (DenseOp, IdentityOp,
                                            StencilGraphD1, VertexProx)
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as cp
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_device as cd
    if kind == "diag":
        side, la = SIDE_524K, 0.35
        op, y = IdentityOp(), denoise_problem()
        cv_np = block_labels(side, 200)
        vprox, r_l1 = VertexProx(), None
    else:
        side, la = V_SIDE, LA_D1
        a, y = build_grid_problem()
        op = DenseOp(torch.as_tensor(a, dtype=dtype, device=device))
        cv_np = np.arange(side * side)
        vprox = VertexProx(kind="l1", positivity=True)
    g = StencilGraphD1.create((side, side), {(0, 1): la, (1, 0): la},
                              dtype=dtype, device=device)
    obs = torch.as_tensor(y, dtype=dtype, device=device)
    cv_t = torch.as_tensor(cv_np, device=device)
    su, sv = g.gather_endpoints(cv_t)
    eps = float(np.finfo(np.float64 if dtype == torch.float64
                         else np.float32).eps)
    cv, num_comp, firsts, rgraph = cd.contract(g, su != sv, eps)
    rv_cap = rgraph.num_vertices
    la_l1 = torch.full((g.num_vertices,), LA_L1, dtype=dtype, device=device)
    r_la, rx0 = cd._reduce_vertex_terms(cv, torch.full_like(la_l1, 0.01),
                                        la_l1, firsts, rv_cap)
    if kind == "dense":
        r_l1 = r_la
    r_op, mat, ry, lipsch = cd._reduced_problem(op, obs, cv, num_comp,
                                                rv_cap, 1000)
    args, kw = cp.kernel_solve_inputs(
        r_op, mat, ry, lipsch, rgraph, r_l1, rx0, num_comp, vprox=vprox,
        rho=1.5, dif_tol=1e-7, sort_edges=True)
    return args, kw, num_comp, rv_cap


def twice_equal(fn):
    """Calls ``fn`` twice on the same inputs; returns the first result and
    whether the two are bit-equal (every tensor of the result)."""
    import torch
    a, b = fn(), fn()
    return a, all(torch.equal(u, v) for u, v in zip(a, b))


def phase_solve_fused(device="cuda"):
    """``solve_fused`` against its plain version: first on the EEG
    problem's first steepest cut (dense, rv_cap 4096, prepared as
    ``_kernel_solve`` prepares it for ``solve_fused``, edges sorted), then
    on reduced problems that ``solve_small`` cannot hold, then on the
    mesh call of the ``pfdr-mesh-banded`` path (float32 timed).  float64: the evolution test stops both,
    step counts equal, iterates to F64_TOL; float32: a fixed 300
    iterations, iterates to F32_TOL (the two differ in summation order
    only, carried through a nonexpansive iteration)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused as sfu
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    main = {}
    cv1, rg1, _, _, _ = first_cut_partition()
    for dtype in (torch.float64, torch.float32):
        args, rv = small_inputs("dense", cv1, rg1, dtype, device,
                                sort_edges=True)
        kw = solve_kw(dtype, rv)
        (xk, zk, itk, _), same = twice_equal(
            lambda: sfu.fused_pfdr_solve(*args, **kw))
        check(same, f"solve_fused EEG dense shape {dtype}: two calls differ")
        xp, zp, itp, _ = sfu.solve_fused_plain(*args, **kw)
        err = max(max_err(xk, xp), max_err(zk, zp))
        errs[dtype] = max(errs[dtype], err)
        main["err_" + str(dtype)[6:]] = err
        tol = F64_TOL if dtype == torch.float64 else F32_TOL
        check(int(itk) == int(itp), f"solve_fused EEG dense shape {dtype}: "
              f"it {int(itk)} vs plain {int(itp)}")
        check(err <= tol, f"solve_fused EEG dense shape {dtype}: err "
              f"{err:.3g} > {tol}")
        line = (f"[solve_fused] {str(dtype)[6:]} dense rv={rv} rv_cap="
                f"{args[5].shape[0]} e={args[8].shape[0]} (the EEG host "
                f"cut's first reduced problem) it={int(itk)} "
                f"max|kernel-plain| = {err:.3e} (tol {tol:g})")
        if dtype == torch.float32:
            ms = cuda_ms(lambda: sfu.fused_pfdr_solve(*args, **kw), 5)
            plain_ms = cuda_ms(lambda: sfu.solve_fused_plain(*args, **kw), 2)
            main.update(ms=ms, plain_ms=plain_ms, args=args, rv=rv)
            line += (f"; 300 iterations: kernel {ms:.3f} ms, plain "
                     f"{plain_ms:.1f} ms")
        print(line, flush=True)
    for kind in ("diag", "dense"):
        for dtype in (torch.float64, torch.float32):
            args, kw, rv, rv_cap = reduced_inputs(kind, dtype, device)
            n_rows = args[1].shape[0] if kind == "dense" else 0
            check(not ss.fits(rv_cap, n_rows, torch.float32),
                  f"{kind}: rv_cap {rv_cap} fits solve_small")
            if dtype == torch.float64:
                kw.update(it_max=3000, dif_tol2=1e-14)
            else:
                kw.update(it_max=300, dif_tol2=0.0)
            (xk, zk, itk, _), same = twice_equal(
                lambda: sfu.fused_pfdr_solve(*args, **kw))
            check(same, f"solve_fused {kind} {dtype}: two calls differ")
            xp, zp, itp, _ = sfu.solve_fused_plain(*args, **kw)
            err = max(max_err(xk, xp), max_err(zk, zp))
            errs[dtype] = max(errs[dtype], err)
            tol = F64_TOL if dtype == torch.float64 else F32_TOL
            check(int(itk) == int(itp), f"solve_fused {kind} {dtype}: it "
                  f"{int(itk)} vs plain {int(itp)}")
            check(err <= tol, f"solve_fused {kind} {dtype}: err {err:.3g}")
            line = (f"[solve_fused] {str(dtype)[6:]} {kind:5s} rv={rv} "
                    f"rv_cap={rv_cap} e={args[8].shape[0]} it={int(itk)} "
                    f"max|kernel-plain| = {err:.3e} (tol {tol:g})")
            if dtype == torch.float32:
                ms = cuda_ms(lambda: sfu.fused_pfdr_solve(*args, **kw), 3)
                plain_ms = cuda_ms(lambda: sfu.solve_fused_plain(*args,
                                                                 **kw), 1)
                line += (f"; 300 iterations: kernel {ms:.3f} ms, plain "
                         f"{plain_ms:.1f} ms")
            print(line, flush=True)
    # the mesh path's call: banded order, no power-of-two padding, the
    # padding edges' hub row
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        args, kw = mesh_whole_inputs(dtype, device, MESH_WHOLE_DIF_TOL
                                     if f64 else 0.0, 3000 if f64 else 300)
        (xk, zk, itk, _), same = twice_equal(
            lambda: sfu.fused_pfdr_solve(*args, **kw))
        check(same, f"solve_fused mesh {dtype}: two calls differ")
        xp, zp, itp, _ = sfu.solve_fused_plain(*args, **kw)
        err = max(max_err(xk, xp), max_err(zk, zp))
        errs[dtype] = max(errs[dtype], err)
        name = str(dtype)[6:]
        main[f"mesh_err_{name}"], main[f"mesh_it_{name}"] = err, int(itk)
        tol = F64_TOL if f64 else F32_TOL
        check(int(itk) == int(itp), f"solve_fused mesh {dtype}: it "
              f"{int(itk)} vs plain {int(itp)}")
        check(err <= tol, f"solve_fused mesh {dtype}: err {err:.3g}")
        line = (f"[solve_fused] {name} mesh BandedGraphD1 (the "
                f"pfdr-mesh-banded path's call) rv={kw['rv']} "
                f"e={args[8].shape[0]} it={int(itk)} (plain {int(itp)}) "
                f"max|kernel-plain| = {err:.3e} (tol {tol:g}), two calls "
                f"bit-equal")
        if not f64 and device == "cuda":
            t = mesh_solve_times(sfu, args, kw)
            main.update(t, mesh_args=args)
            line += (f"; 300 iterations: kernel {t['mesh_ms_300']:.3f} ms "
                     f"({t['mesh_ms_300'] * 1e3 / 300:.2f} us an "
                     f"iteration), plain {t['mesh_plain_ms_300']:.1f} ms; "
                     f"the path's 3000: kernel {t['mesh_ms']:.3f} ms "
                     f"({t['mesh_ms'] * 1e3 / 3000:.2f} us an iteration), "
                     f"plain {t['mesh_plain_ms']:.1f} ms; the launch plan "
                     f"{t['mesh_plan_ms']:.3f} ms of host time a call, "
                     f"inside these times")
        print(line, flush=True)
    return errs, main


def plan_ms(sfu, args, reps=20):
    """Host milliseconds of ``solve_fused``'s launch plan on the call's
    edge list (``make_plan``, built on every call; the card synchronised
    before and after): the mean of ``reps`` builds."""
    import torch
    op_kind, op, eu, ev = args[0], args[1], args[8], args[9]
    n_rows = op.shape[0] if op_kind == "dense" else 0
    build = functools.partial(sfu.make_plan, op_kind, eu, ev,
                              args[5].shape[0], n_rows, args[5].dtype)
    build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        build()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def mesh_solve_times(sfu, args, kw):
    """The mesh call's kernel and plain times (ms a launch, CUDA events,
    the launch plan's host time included) at 300 float32 iterations and at
    the path's 3000, and the plan's host time alone."""
    out = {"mesh_plan_ms": plan_ms(sfu, args)}
    for it_max, tag in ((300, "_300"), (3000, "")):
        k = dict(kw, it_max=it_max, dif_tol2=0.0)
        out["mesh_ms" + tag] = cuda_ms(
            lambda: sfu.fused_pfdr_solve(*args, **k), 3)
        out["mesh_plain_ms" + tag] = cuda_ms(
            lambda: sfu.solve_fused_plain(*args, **k), 1)
    return out


# a banded grid of LARGE_SIDE x LARGE_SIDE vertices: in float64 a block's
# iterate and forward values no longer fit in its shared memory (132 SMs)
LARGE_SIDE = 1448


def phase_solve_fused_large(device="cuda"):
    """:func:`solve_fused_large`, then the memory it cached handed back to
    the card (the halo phase's ranks share it)."""
    import torch
    err = solve_fused_large(device)
    if device == "cuda":
        torch.cuda.empty_cache()
    return err


def solve_fused_large(device):
    """The unmonitored whole solve of ``pfdr_quadratic_d1`` on a
    ``BandedGraphD1`` grid of ``LARGE_SIDE`` squared vertices (TV
    denoising of ``denoise_problem``'s kind at that side, float64): the
    launch reads the blocks' iterate and forward values from global memory.
    Held against the plain version on the same inputs: equal iteration
    counts, the iterate within F64_TOL, two solves bit-equal, each one
    ``solve_fused`` launch."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (BandedGraphD1, IdentityOp,
                                            PFDROptions, VertexProx)
    from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused as sfu
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_quadratic as pq
    dtype, side = torch.float64, LARGE_SIDE
    idx = np.arange(side * side).reshape(side, side)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    g = BandedGraphD1.create(eu.astype(np.int32), ev.astype(np.int32), 0.35,
                             num_vertices=side * side, dtype=dtype,
                             device=device)
    obs = torch.as_tensor(denoise_problem(side), dtype=dtype, device=device)
    op, opt = IdentityOp(), PFDROptions(rho=1.5, dif_tol=1e-3, it_max=1000)
    plan = sfu.make_plan("diag", g.eu, g.ev, g.num_vertices, 0, dtype)
    check(not plan.xs_in_smem, f"large solve: {plan.nb_max} vertices a "
          f"block fit in shared memory; the case needs a larger side")
    n0 = sfu.fused_pfdr_solve.launches
    r1 = pq.pfdr_quadratic_d1(op, obs, g, opt=opt)
    r2 = pq.pfdr_quadratic_d1(op, obs, g, opt=opt)
    check(sfu.fused_pfdr_solve.launches == n0 + 2,
          "large solve: not one solve_fused launch a solve")
    check(torch.equal(r1.x, r2.x), "large solve: two solves differ")
    pre = pq.initial_precondition(op, obs, g, None, opt.rho, None,
                                  Lipsch.SCAL)
    x0 = torch.zeros(g.num_vertices, dtype=dtype, device=device)
    args, kw = pq.whole_solve_inputs(op, obs, g, VertexProx(), pre, x0,
                                     *g.gather_endpoints(x0), opt, "diag")
    xp, _, itp, _ = sfu.solve_fused_plain(*args, **kw)
    err = max_err(r1.x, xp)
    check(int(r1.it) == int(itp), f"large solve: it {int(r1.it)} vs plain "
          f"{int(itp)}")
    check(err <= F64_TOL, f"large solve: err {err:.3g} > {F64_TOL}")
    print(f"[solve_fused] float64 diag {side}x{side} BandedGraphD1 (V="
          f"{g.num_vertices}, e={g.num_edges}; {plan.nb_max} vertices a "
          f"block, iterate and forward values in global memory) through "
          f"pfdr_quadratic_d1: it={int(r1.it)} (plain {int(itp)}) "
          f"max|kernel-plain| = {err:.3e} (tol {F64_TOL:g}), two solves "
          f"bit-equal", flush=True)
    return err


# the float64 mesh whole solve against its plain version stops on this
# relative evolution (after 190 iterations, on the CPU in float64)
MESH_WHOLE_DIF_TOL = 1e-3


def mesh_whole_inputs(dtype, device, dif_tol, it_max):
    """``(args, kw)`` of the ``solve_fused`` call that an unmonitored
    ``pfdr_quadratic_d1`` makes on the mesh's ``BandedGraphD1``
    (``bench_unstructured``'s problem, from x = 0)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions, VertexProx
    from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_quadratic as pq
    _, _, a, y = build_mesh_problem()
    g = mesh_graph("banded", dtype, device)
    op, obs, la_l1, lip = quadratic_setup(g, a, y, dtype, device)
    pre = pq.initial_precondition(op, obs, g, la_l1, 1.5, lip, Lipsch.SCAL)
    x0 = torch.zeros(g.num_vertices, dtype=dtype, device=device)
    zu, zv = g.gather_endpoints(x0)
    return pq.whole_solve_inputs(
        op, obs, g, VertexProx(kind="l1", positivity=True), pre, x0, zu, zv,
        PFDROptions(rho=1.5, dif_tol=dif_tol, it_max=it_max), "dense")


def crossover(device="cuda"):
    """solve_small on each cluster size it takes (C = 1: one block; the
    cluster the wrapper picks starred) against solve_fused (the whole card) on the same reduced
    problems of the EEG host route, float32, 300 iterations: the
    measurement behind ``SOLVE_FUSED_MIN_RV_CAP`` in
    ``solvers/cut_pursuit.py`` and ``cluster_size`` in
    ``ops/solve_small.py``.  Returns ``{(kind, rv_cap): {C: ms}}``."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused as sfu
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    cv1, rg1, eu, ev, la = first_cut_partition()
    table = {}
    for cv, rg in ((cv1, rg1), block_partition(eu, ev, la, 8, 16),
                   block_partition(eu, ev, la, 16, 16),
                   block_partition(eu, ev, la, 16, 32),
                   block_partition(eu, ev, la, 32, 32),
                   block_partition(eu, ev, la, 32, 64)):
        for kind in ("dense", "gram", "diag"):
            args, rv = small_inputs(kind, cv, rg, torch.float32, device)
            rv_cap = args[5].shape[0]
            if kind == "gram" and rv_cap > 512:
                continue  # the route premultiplies below ~2 N components
            kw = solve_kw(torch.float32, rv)
            n_rows = args[1].shape[0] if kind == "dense" else 0
            pick = ss.cluster_size(kind, rv_cap, n_rows, torch.float32)
            row = {}
            for c in ss.CLUSTER_SIZES if kind != "diag" else (1,):
                if c <= rv_cap:
                    row[c] = cuda_ms(lambda: ss._solve(c, *args, **kw), 3)
            t_f = cuda_ms(lambda: sfu.fused_pfdr_solve(*args, **kw), 3)
            table[(kind, rv_cap)] = dict(row, solve_fused=t_f)
            cells = ", ".join(f"C={c}{'*' if c == pick else ''} {t:.3f}"
                              for c, t in row.items())
            print(f"[crossover] {kind:5s} rv={rv} rv_cap={rv_cap}: "
                  f"solve_small {cells}; solve_fused {t_f:.3f} ms per 300 "
                  f"iterations", flush=True)
    return table


def denoise_problem(side=SIDE_524K):
    """The 524k-vertex TV denoising problem of ``bench.py:366-386``: twelve
    constant rectangles plus Gaussian noise (seed 5), on a ``side`` x
    ``side`` field."""
    r = np.random.default_rng(5)
    x_true = np.zeros((side, side), np.float32)
    for _ in range(12):
        i, j = r.integers(20, side - 80, 2)
        h_, w_ = r.integers(24, 64, 2)
        x_true[i:i + h_, j:j + w_] = r.uniform(0.3, 1.5)
    return (x_true + 0.15 * r.standard_normal((side, side))
            ).astype(np.float32).ravel()


def chain_options():
    """``bench.py:297-302``'s options of the EEG cut-pursuit headline."""
    from cp_pfdr_graph_d1_tpu_torch import CPOptions, PFDROptions
    return CPOptions(
        dif_tol=1e-4, it_max=15,
        pfdr=PFDROptions(rho=1.5, cond_min=1e-3, dif_rcd=0.0, dif_tol=1e-7,
                         it_max=10_000),
        cut="device", chain="auto", cut_tol=1e-6, cut_it_max=100_000,
        chain_init_pfdr=3000)


def phase_cp_chain(f_ref, device="cuda"):
    """The EEG problem through ``cut="device"`` and the chained loop, float32
    on the card; its objective no worse than 1e-3 relative above the port's
    float64 host-route run of the CPU."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import DenseOp, StencilGraphD1
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_chain as chn
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1
    a, y = build_grid_problem()
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=torch.float32, device=device)
    op = DenseOp(torch.as_tensor(a, device=device))
    obs = torch.as_tensor(y, device=device)
    la_l1 = np.full(a.shape[1], LA_L1, np.float32)
    opt = chain_options()
    check(chn.chain_admissible(op, g, opt, False, False, obs),
          "the chained loop does not admit the EEG problem")
    comps = []
    contract = chn.contract

    def recording(*args):
        out = contract(*args)
        comps.append(out[1])
        return out

    runs = []
    for k in range(3):  # one warm-up (recording its partitions), two timed
        chn.contract = recording if k == 0 else contract
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cp_quadratic_d1(op, obs, g, la_l1=la_l1, positivity=True,
                              opt=opt)
        runs.append((time.perf_counter() - t0, res))
    chn.contract = contract
    t_best = min(t for t, _ in runs[1:])
    res = runs[-1][1]
    x = res.rx[res.cv]
    check(np.all(np.isfinite(x)) and x.shape == (V_SIDE * V_SIDE,),
          "chained cut-pursuit result not finite or of the wrong shape")
    eu, ev, la = g.host_coo()
    f = objective(x, a, y, eu, ev, la)
    print(f"[cp-chain] float32 on the card, cut='device' chain='auto' "
          f"chain_init_pfdr=3000: min of two warm runs {t_best * 1e3:.1f} ms"
          f" (warm-up {runs[0][0] * 1e3:.1f} ms); {res.it} CP iterations, "
          f"{len(res.rx)} components; objective {f:.7g} against the CPU "
          f"float64 host route's {f_ref:.7g}", flush=True)
    print(f"[cp-chain] components of each contraction (the settle pass "
          f"first, the polish last): {comps}", flush=True)
    check(f <= f_ref * (1 + 1e-3), f"chained objective {f} worse than the "
          f"float64 run {f_ref} by more than 1e-3 relative")
    return t_best


def phase_cp_reduced_options(f_ref, device="cuda", device_loop=False):
    """``[cp-reduced-options]``: the EEG problem on the card with the
    default ``fused="auto"`` and PFDR options the whole-solve kernels do
    not serve.  Reconditioning (``PFDR_difRcd=1e-3``) through the API's
    host cut (and, with ``device_loop``, reconditioning with PFDR progress
    lines through the per-iteration device loop: about 90 s of host-bound
    staged iterations, so ``python3 chip_smoke.py --reduced-options`` runs
    it and the full run does not) solves its reduced problems in the staged
    loop (no ``solve_small`` / ``solve_fused`` launch), each objective
    within 1e-3 relative of the float64 run ``f_ref``
    (``bench.py:331-347``'s rule); ``fused="on"`` with them still raises,
    in both loops."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, DenseOp, PFDROptions,
                                            StencilGraphD1, api)
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1
    a, y = build_grid_problem()
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=torch.float32, device=device)
    eu, ev, la = g.host_coo()
    la_l1 = np.full(a.shape[1], LA_L1, np.float32)
    op, obs = DenseOp(torch.as_tensor(a, device=device)), torch.as_tensor(
        y, device=device)

    def run_device_loop(fused):
        pf = PFDROptions(rho=1.5, dif_rcd=1e-3, dif_tol=1e-7, it_max=10_000,
                         verbose=1000, fused=fused)
        return cp_quadratic_d1(op, obs, g, la_l1=la_l1, positivity=True,
                               opt=CPOptions(dif_tol=1e-4, it_max=15,
                                             pfdr=pf, cut="device",
                                             chain="off"))

    def host_cut(fused):
        opt = api._cp_options(1e-4, 15, 1.5, 1e-3, 1e-3, 1e-7, 10_000, 0)
        opt = dataclasses.replace(opt, pfdr=dataclasses.replace(
            opt.pfdr, fused=fused))
        return cp_quadratic_d1(op, obs, g, la_l1=la_l1, positivity=True,
                               opt=opt)

    runs = {
        "host cut, PFDR_difRcd=1e-3": lambda: api.cp_quadratic_d1_l1(
            y, a, None, None, None, La_l1=la_l1, positivity=True,
            CP_difTol=1e-4, CP_itMax=15, PFDR_rho=1.5, PFDR_difRcd=1e-3,
            PFDR_difTol=1e-7, PFDR_itMax=10_000, graph=g, device=device)}
    if device_loop:
        runs["device loop, dif_rcd=1e-3 verbose=1000"] = lambda: \
            run_device_loop("auto")
    for name, run in runs.items():
        before = read_counts()
        sync(device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = run()
        dt = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in read_counts().items() if
                v != before[k]}
        cv, rx = (out.Cv, out.rX) if hasattr(out, "Cv") else (out.cv,
                                                              out.rx)
        x = rx[cv]
        check(np.all(np.isfinite(x)) and x.shape == (V_SIDE * V_SIDE,),
              f"cp-reduced-options {name}: result not finite or of the "
              f"wrong shape")
        f = objective(x, a, y, eu, ev, la)
        print(f"[cp-reduced-options] {name}, fused='auto': {dt * 1e3:.1f} "
              f"ms, {len(rx)} components, objective {f:.7g} against "
              f"float64 {f_ref:.7g} (rel {(f - f_ref) / f_ref:.3e}); "
              f"launches {grew}", flush=True)
        check(grew.get("solve_small", 0) == 0
              and grew.get("solve_fused", 0) == 0,
              f"cp-reduced-options {name}: a whole-solve kernel ran")
        check(abs(f - f_ref) <= 1e-3 * abs(f_ref),
              f"cp-reduced-options {name}: objective {f} vs float64 "
              f"{f_ref}: more than 1e-3 relative apart")
    for name, run in (("host cut", host_cut),
                      ("device loop", run_device_loop)):
        try:
            run("on")
        except NotImplementedError as err:
            print(f"[cp-reduced-options] {name}, fused='on' with dif_rcd="
                  f"1e-3 raises: {err}", flush=True)
        else:
            check(False, f"cp-reduced-options: {name}, fused='on' with "
                  f"dif_rcd > 0 did not raise")


def reduced_options_only():
    """``python3 chip_smoke.py --reduced-options``: ``[cp-reduced-options]``
    with the device loop, against the float64 host-route run on the CPU
    (``phase_cp``'s reference)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_env()
    phase_build()
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    a, y = build_grid_problem()
    g64 = StencilGraphD1.create((V_SIDE, V_SIDE),
                                {(0, 1): LA_D1, (1, 0): LA_D1},
                                dtype=torch.float64, device="cpu")
    ref = run_cp(g64, a.astype(np.float64), y.astype(np.float64),
                 np.float64, "cpu", host_small="on")
    eu, ev, la = g64.host_coo()
    phase_cp_reduced_options(objective(ref.rX[ref.Cv], a, y, eu, ev, la),
                             device_loop=True)


def phase_cp_device(device="cuda"):
    """The 524k denoising problem through the per-iteration device loop
    (``bench.py:366-386``'s options, ``chain="off"``), float32 on the card,
    held against the same solve in float64 on the card."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, IdentityOp,
                                            PFDROptions, StencilGraphD1)
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1
    y = denoise_problem()
    side = SIDE_524K

    def run(dtype, verbose=0):
        g = StencilGraphD1.create((side, side), {(0, 1): 0.35, (1, 0): 0.35},
                                  dtype=dtype, device=device)
        opt = CPOptions(dif_tol=1e-4, it_max=4,
                        pfdr=PFDROptions(rho=1.8, dif_tol=1e-5, it_max=2000),
                        cut="device", chain="off", cut_tol=1e-5,
                        cut_it_max=50_000, verbose=verbose)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cp_quadratic_d1(IdentityOp(), torch.as_tensor(
            y, dtype=dtype, device=device), g, opt=opt)
        return time.perf_counter() - t0, res

    def obj(res):
        x = res.rx[res.cv].astype(np.float64)
        xg = x.reshape(side, side)
        return (0.5 * np.sum((x - y) ** 2)
                + 0.35 * np.sum(np.abs(xg[:, 1:] - xg[:, :-1]))
                + 0.35 * np.sum(np.abs(xg[1:] - xg[:-1])))

    before = read_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runs = [run(torch.float32, verbose=1)]
    comps = [int(ln.split(":")[1].split()[0])
             for ln in buf.getvalue().splitlines() if ln.startswith("CP it")]
    runs += [run(torch.float32), run(torch.float32)]
    grew = {k: v - before[k] for k, v in read_counts().items()}
    t_best = min(t for t, _ in runs[1:])
    res = runs[-1][1]
    f32 = obj(res)
    t64, res64 = run(torch.float64)
    f64 = obj(res64)
    print(f"[cp-device] float32 on the card, 724x724 IdentityOp, cut="
          f"'device' chain='off': min of two warm runs {t_best * 1e3:.1f} ms"
          f" (warm-up {runs[0][0] * 1e3:.1f} ms); {res.it} CP iterations, "
          f"components per iteration {comps}; reduced solves of the three "
          f"runs: solve_small {grew['solve_small']}, solve_fused "
          f"{grew['solve_fused']}; objective {f32:.9g} against float64 on "
          f"the card {f64:.9g} ({t64 * 1e3:.1f} ms)", flush=True)
    check(np.all(np.isfinite(res.rx)) and res.cv.shape == (side * side,),
          "device cut-pursuit result not finite or of the wrong shape")
    check(abs(f32 - f64) <= 1e-3 * abs(f64), f"524k objective {f32} vs "
          f"float64 {f64}: more than 1e-3 relative apart")
    return t_best


# ---------------------------------------------------------------------------
# slice 3: the multi-label (simplex) family
# ---------------------------------------------------------------------------

K_SIMPLEX = 4
SIMPLEX_CASES = (("al=0", 0.0, None, False), ("al=1 la_f", 1.0, 0.8, False),
                 ("al=0.5", 0.5, None, False),
                 ("al=0.5 labels", 0.5, None, True))
SIDE_262K = 512   # bench.py:bench_cut_pursuit_simplex, V = 262,144
# nonzero-weight edges of the 140 x 140 grid
N_EDGES_EEG = 2 * V_SIDE * (V_SIDE - 1)


def simplex_q(k=None):
    """``bench.py:bench_simplex``'s observations: Dirichlet(0.7) rows of
    K = 4 labels on the 140 x 140 grid (seed 11); for another ``k``, the
    same draw of ``k`` labels."""
    k = K_SIMPLEX if k is None else k
    r = np.random.default_rng(11)
    return r.dirichlet(np.full(k, 0.7), size=V_SIDE * V_SIDE).astype(
        np.float32)


def simplex_problem(dtype, device, la_f, k=None):
    """``bench_simplex``'s stencil (140 x 140, F = 2, weights 0.5), its
    observations (of ``k`` labels: ``simplex_q``) and the loss weights
    ``la_f`` (a constant, or None)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): 0.5, (1, 0): 0.5},
                              dtype=dtype, device=device)
    q = torch.as_tensor(simplex_q(k), dtype=dtype, device=device)
    laf = (torch.full((g.num_vertices,), la_f, dtype=dtype, device=device)
           if la_f is not None else None)
    return g, q, laf


def simplex_planes(dtype, device, al, la_f, label_mode, seed=3, k=None):
    """Kernel inputs of one multi-label iteration on ``simplex_problem``
    (``k`` labels, default K_SIMPLEX): the preconditioner of the problem, a
    seeded random iterate on the simplex and random auxiliary pairs, as
    ``[K, H, W]`` and ``[F, K, H, W]`` planes; and the stencil graph."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_simplex as ps
    h = w = V_SIDE
    k = K_SIMPLEX if k is None else k
    g, q, laf = simplex_problem(dtype, device, la_f, k)
    f = len(g.shifts)
    t = lambda z: torch.as_tensor(z, dtype=dtype, device=device)  # noqa
    r = np.random.default_rng(seed)
    p = t(r.dirichlet(np.ones(k), size=h * w))
    pre = ps.initial_precondition_simplex(al, laf, g, q, p, 1.5)
    zu0, zv0 = g.gather_endpoints(p)
    zu = zu0 + t(0.05 * r.standard_normal(zu0.shape))
    zv = zv0 + t(0.05 * r.standard_normal(zv0.shape))

    def tv(a):
        return a.T.reshape(-1, h, w).contiguous()

    def te(a):
        return (a.reshape(f, h * w, k).permute(0, 2, 1)
                .reshape(f, k, h, w).contiguous())

    laf3 = (laf.reshape(1, h, w).contiguous() if laf is not None
            else torch.zeros((1, h, w), dtype=dtype, device=device))
    prev = (tv(torch.argmax(p, dim=1).to(dtype)[:, None]) if label_mode
            else tv(p))
    args = ((tv(p), tv(q), laf3, tv(pre.ga), tv(pre.ga_proj), prev)
            + tuple(te(a) for a in (zu, zv, pre.wu, pre.wv, pre.w_d1u,
                                    pre.w_d1v, pre.th_d1)))
    kw = dict(shifts=g.shifts, rho=1.5, al=al, has_laf=la_f is not None,
              label_mode=label_mode)
    return args, kw, g


def simplex_loop(dtype, device, al, la_f, label_mode, plain, k=None):
    """400 iterations of the solver's kernel loop
    (``pfdr_simplex._simplex_fused_loop``) on ``simplex_problem`` (``k``
    labels) from the uniform start, each iteration the graph's kernel step
    or, with ``plain``, the kernel's plain version, both on the card.
    Returns ``(p, iterations)``."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused_simplex as sfs
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_simplex as ps
    g, q, laf = simplex_problem(dtype, device, la_f, k)
    p0 = torch.full_like(q, 1.0 / q.shape[1])
    pre = ps.initial_precondition_simplex(al, laf, g, q, p0, 1.5)
    opt = PFDROptions(rho=1.5, dif_tol=1.0 if label_mode else 1e-9,
                      it_max=400)
    step = (functools.partial(sfs.stencil_simplex_iteration_plain,
                              shifts=g.shifts) if plain else None)
    res = ps._simplex_fused_loop(g, q, p0, laf, pre, al=al, opt=opt,
                                 has_laf=laf is not None,
                                 label_mode=label_mode, step=step)
    return res.p, res.it


# label counts of the kernel-vs-plain checks: K_SIMPLEX (the main path's,
# four losses) and the others the kernel compiles (2, 3, 8) or reads at run
# time (9, 32), an evolution and a label-mode case each; the 400-iteration
# float64 loops at K_SIMPLEX and 9
SIMPLEX_KS = (2, 3, 4, 8, 9, 32)
SIMPLEX_OTHER_CASES = (("al=1 la_f", 1.0, 0.8, False),
                       ("al=0.5 labels", 0.5, None, True))
SIMPLEX_LOOP_KS = (K_SIMPLEX, 9)


def simplex_timings(args, kw, g):
    """Times of one multi-label iteration, float32: device time
    (torch.profiler, 200 calls), per call between CUDA events (500 calls)
    and the host clock over 10,000 calls, through
    ``StencilGraphD1.fused_simplex_iteration`` and the standalone wrapper
    (an older checkout of the port takes the same calls)."""
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused_simplex as sfs
    out = {}
    for name, step in (
            ("graph", lambda: g.fused_simplex_iteration(
                *args, **{k: v for k, v in kw.items() if k != "shifts"})),
            ("standalone",
             lambda: sfs.fused_stencil_simplex_iteration(*args, **kw))):
        counts = {}
        dev = device_profile(step, 200, counts)[0]
        out[name] = dict(device_us=dev, ms=cuda_ms(step, 500),
                         host_us=host_us(step), kernels=counts)
    return out


def phase_stencil_simplex(device="cuda"):
    """``stencil_fused_simplex`` against its plain version on the card at
    140 x 140, F = 2, for K in SIMPLEX_KS: one iteration (float64 within
    1e-12, float32 within 1e-5 on p, zu, zv, and the evolution sum
    relative to max(1, |plain|); equal labels and counts in float64, at
    most 0.1 % of the vertices apart in float32, where FMA contraction may
    flip a near tie), at K = 4 for four losses, else for SIMPLEX_OTHER_CASES;
    then a 400-iteration float64 loop of each at K in SIMPLEX_LOOP_KS with
    equal iteration counts.  ``StencilGraphD1.fused_simplex_iteration``
    (its plan on the graph) equals the standalone wrapper bit for bit.
    Times (``simplex_timings``): float32, the main path's case (K = 4,
    al = 1, no la_f)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused_simplex as sfs
    tols = {torch.float64: 1e-12, torch.float32: 1e-5}
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    v = V_SIDE * V_SIDE
    for k in SIMPLEX_KS:
        cases = SIMPLEX_CASES if k == K_SIMPLEX else SIMPLEX_OTHER_CASES
        for dtype in (torch.float64, torch.float32):
            for name, al, la_f, label_mode in cases:
                args, kw, _ = simplex_planes(dtype, device, al, la_f,
                                             label_mode, k=k)
                out_k = sfs.fused_stencil_simplex_iteration(*args, **kw)
                out_p = sfs.stencil_simplex_iteration_plain(*args, **kw)
                if device == "cuda":
                    check(out_k[0].is_cuda, "kernel output not on the card")
                err = max(max_err(out_k[i], out_p[i]) for i in (0, 2, 3))
                tol = tols[dtype]
                tag = f"stencil_fused_simplex {dtype} K={k} {name}"
                if label_mode:
                    n_lab = int((out_k[1] != out_p[1]).sum())
                    d_cnt = abs(float(out_k[4]) - float(out_p[4]))
                    allowed = 0 if dtype == torch.float64 else v // 1000
                    check(n_lab <= allowed and d_cnt <= allowed,
                          f"{tag}: {n_lab} labels and count {d_cnt} apart "
                          f"(allowed {allowed})")
                    extra = (f"labels apart {n_lab}, counts "
                             f"{float(out_k[4]):.0f} vs "
                             f"{float(out_p[4]):.0f}")
                else:
                    err = max(err, max_err(out_k[1], out_p[1]))
                    rel = (max_err(out_k[4], out_p[4])
                           / max(1.0, abs(float(out_p[4]))))
                    check(rel <= tol, f"{tag}: sum rel err {rel:.3g} > "
                          f"{tol}")
                    extra = f"evolution sum rel err {rel:.3e}"
                check(err <= tol, f"{tag}: p/zu/zv err {err:.3g} > {tol}")
                errs[dtype] = max(errs[dtype], err)
                line = (f"[stencil_fused_simplex] {str(dtype)[6:]} K={k:<2d} "
                        f"{name:13s} one iteration: p/zu/zv "
                        f"max|kernel-plain| = {err:.3e} (tol {tol:g}); "
                        f"{extra}")
                if dtype == torch.float64 and k in SIMPLEX_LOOP_KS:
                    pk, itk = simplex_loop(dtype, device, al, la_f,
                                           label_mode, plain=False, k=k)
                    pp, itp = simplex_loop(dtype, device, al, la_f,
                                           label_mode, plain=True, k=k)
                    lerr = max_err(pk, pp)
                    check(itk == itp, f"{tag}: loop of {itk} iterations vs "
                          f"plain {itp}")
                    line += (f"; 400-iteration loop: {itk} iterations "
                             f"(plain {itp}), p max|kernel-plain| "
                             f"{lerr:.3e}")
                print(line, flush=True)
    # the graph's plan path against the standalone wrapper
    args, kw, g = simplex_planes(torch.float32, device, 1.0, None, False)
    gkw = {k: v for k, v in kw.items() if k != "shifts"}
    out_g = g.fused_simplex_iteration(*args, **gkw)
    out_s = sfs.fused_stencil_simplex_iteration(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(out_g, out_s)),
          "stencil_fused_simplex: the graph's plan path and the standalone "
          "wrapper differ")
    if device == "cuda":
        check(len(g._simplex_plans) == 1, f"the graph holds "
              f"{len(g._simplex_plans)} simplex plans, not 1")
    # monitoring, progress lines and reconditioning between the kernel's
    # launches, against the staged loop on the card
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions, pfdr_loss_d1_simplex
    g, q, _ = simplex_problem(torch.float64, device, None)
    runs = {}
    for fused in ("on", "off"):
        opt = PFDROptions(rho=1.5, dif_tol=1e-9, it_max=300, dif_rcd=1e-2,
                          cond_min=1e-2, verbose=100, fused=fused)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            runs[fused] = pfdr_loss_d1_simplex(g, q, al=0.5, opt=opt,
                                               monitor=True)
        runs[fused + " lines"] = out.getvalue().count("PFDR iteration")
    on, off = runs["on"], runs["off"]
    it = on.it
    obj_rel = float(((on.obj[:it + 1] - off.obj[:it + 1]).abs()
                     / off.obj[:it + 1].abs()).max())
    p_err = max_err(on.p, off.p)
    line = (f"[stencil_fused_simplex] float64 al=0.5 monitor, verbose 100, "
            f"dif_rcd 1e-2 through the kernel loop: {it} iterations (staged "
            f"loop {off.it}), objective trace rel err {obj_rel:.3e}, p "
            f"max|kernel loop - staged| {p_err:.3e}, {runs['on lines']} "
            f"progress lines (staged {runs['off lines']})")
    print(line, flush=True)
    check(it == off.it and obj_rel <= 1e-10 and p_err <= F64_TOL
          and runs["on lines"] == runs["off lines"], line)
    times = {}
    if device == "cuda":
        args, kw, g = simplex_planes(torch.float32, device, 1.0, None, False)
        t = simplex_timings(args, kw, g)
        for name, tn in t.items():
            # one kernel, launched once a call (the profiler may drop an
            # event at the start of its window, never add one)
            counts = tn["kernels"]
            check(len(counts) == 1 and 0 < max(counts.values()) <= 200,
                  f"stencil_fused_simplex ({name}): not one launch a stage: "
                  f"{counts}")

        def plain():
            return sfs.stencil_simplex_iteration_plain(*args, **kw)

        times = dict(ms=t["graph"]["ms"], device_us=t["graph"]["device_us"],
                     host_us=t["graph"]["host_us"],
                     standalone_host_us=t["standalone"]["host_us"],
                     plain_ms=cuda_ms(plain, 200),
                     plain_device_us=device_profile(plain, 200)[0])
        print(f"[stencil_fused_simplex] float32 {V_SIDE}x{V_SIDE} F=2 "
              f"K={K_SIMPLEX} al=1, per call through "
              f"StencilGraphD1.fused_simplex_iteration: {times['ms'] * 1e3:.2f}"
              f" us between CUDA events, {times['device_us']:.2f} us of "
              f"device time ({t['graph']['kernels']}), "
              f"{times['host_us']:.2f} us of host time (10,000 calls; the "
              f"standalone wrapper {times['standalone_host_us']:.2f}); plain "
              f"{times['plain_ms'] * 1e3:.2f} us ({times['plain_device_us']:.2f}"
              f" us of device time)", flush=True)
    return errs, times


def pfdr_simplex_solve(dtype, device, iters, fused="auto"):
    """``bench_simplex``'s solve: al = 1, rho = 1.5, dif_tol = 0."""
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions, pfdr_loss_d1_simplex
    g, q, _ = simplex_problem(dtype, device, None)
    return pfdr_loss_d1_simplex(
        g, q, al=1.0, opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=iters,
                                      fused=fused))


def simplex_reference(device="cuda", iters=3000):
    """The float64 solve on the card that the pfdr-simplex path is held
    against (run before the path's counted window)."""
    import torch
    return pfdr_simplex_solve(torch.float64, device, iters).p.cpu()


def phase_pfdr_simplex(p64, device="cuda", iters=3000):
    """Main path: ``pfdr_loss_d1_simplex`` on ``bench_simplex``'s problem,
    float32, through ``stencil_fused_simplex``; max |p - p64| <= 1e-3."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused_simplex as sfs
    before = sfs.fused_stencil_simplex_iteration.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pfdr_simplex_solve(torch.float32, device, iters)
    p = res.p.cpu()
    dt = time.perf_counter() - t0
    grew = sfs.fused_stencil_simplex_iteration.launches - before
    check(grew == iters, f"stencil_fused_simplex launched {grew} times in a "
          f"{iters}-iteration solve")
    check(res.it == iters and bool(torch.isfinite(p).all())
          and p.shape == (V_SIDE * V_SIDE, K_SIMPLEX),
          "multi-label PFDR result not finite, short or misshapen")
    err = max_err(p, p64)
    print(f"[pfdr-simplex] float32 {V_SIDE}x{V_SIDE} K={K_SIMPLEX}, {iters} "
          f"iterations through stencil_fused_simplex: {dt * 1e6 / iters:.2f}"
          f" us/iteration, {N_EDGES_EEG * iters / dt:.4g} edge-updates/s "
          f"(launches +{grew}); max|p - p float64 on the card| {err:.3e} "
          f"(tol 1e-3); row sums within "
          f"{float((p.double().sum(1) - 1).abs().max()):.2e} of 1",
          flush=True)
    check(err <= 1e-3, f"multi-label PFDR float32 vs float64: {err:.3g}")
    short = 300
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pfdr_simplex_solve(torch.float32, device, short, fused="off").p.cpu()
    dt_staged = time.perf_counter() - t0
    print(f"[pfdr-simplex] staged loop (no kernel), {short} iterations: "
          f"{dt_staged * 1e6 / short:.2f} us/iteration", flush=True)
    return dt * 1e6 / iters


def cp_simplex_problem():
    """``bench.py:bench_cut_pursuit_simplex``'s problem: a 512 x 512 grid of
    four quadrant labels, 35 % of the rows replaced by Dirichlet(0.8) noise
    (seed 17), float32."""
    side, k = SIDE_262K, K_SIMPLEX
    v = side * side
    idx = np.arange(v).reshape(side, side)
    r = np.random.default_rng(17)
    labels = (idx // (side // 2) % 2 * 2
              + (idx % side) // (side // 2) % 2).ravel()
    q = np.full((v, k), 0.05, np.float32)
    q[np.arange(v), labels] = 0.85
    flip = r.random(v) < 0.35
    q[flip] = r.dirichlet(np.full(k, 0.8),
                          size=int(flip.sum())).astype(np.float32)
    return q, labels


def cp_simplex_setup(dtype, device="cuda", verbose=0):
    """``bench_cut_pursuit_simplex``'s graph, observations and options
    (``bench.py:436-459``): ``cut="device"``, the per-iteration device
    loop."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, PFDROptions,
                                            StencilGraphD1)
    q_np, _ = cp_simplex_problem()
    g = StencilGraphD1.create((SIDE_262K, SIDE_262K),
                              {(0, 1): 0.4, (1, 0): 0.4}, dtype=dtype,
                              device=device)
    q = torch.as_tensor(q_np, dtype=dtype, device=device)
    opt = CPOptions(dif_tol=1e-3, it_max=10,
                    pfdr=PFDROptions(rho=1.5, dif_tol=1e-6, it_max=3000),
                    cut="device", cut_tol=1e-5, cut_it_max=50_000,
                    verbose=verbose)
    return g, q, opt


def run_cp_simplex(dtype, device="cuda", verbose=0):
    """One solve of ``cp_simplex_setup``'s problem through the entry point.
    Returns ``(seconds, result, graph, q tensor)``; fails if an expansion
    cut fell back to the host."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import cp_loss_d1_simplex
    g, q, opt = cp_simplex_setup(dtype, device, verbose)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        res = cp_loss_d1_simplex(g, q, al=1.0, opt=opt)
        np.asarray(res.rp)
        dt = time.perf_counter() - t0
    for wn in caught:
        check("falling back" not in str(wn.message),
              f"multi-label CP left the card: {wn.message}")
        warnings.warn_explicit(wn.message, wn.category, wn.filename,
                               wn.lineno)
    return dt, res, g, q


def simplex_objective(res, g, q):
    """``loss_objective + d1_objective`` of a cut-pursuit result, float64 on
    the card."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_simplex as ps
    g64 = type(g)(g.la_d1.double(), g.field_shape, g.shifts, g.wrap)
    p = torch.as_tensor(res.rp[res.cv], dtype=torch.float64, device=q.device)
    return float(ps.loss_objective(1.0, p, q.double(), None)
                 + ps.d1_objective(g64, p))


def cp_simplex_reference(device="cuda"):
    """The float64 cut-pursuit solve on the card that the cp-simplex path is
    held against (run before the path's counted window)."""
    import torch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t, res, g, q = run_cp_simplex(torch.float64, device, verbose=1)
    for ln in buf.getvalue().splitlines():
        if ln.startswith("CP-simplex it"):
            print(f"[cp-simplex] float64 reference: {ln}", flush=True)
    return dict(seconds=t, ml=res.rp[res.cv].argmax(1),
                obj=simplex_objective(res, g, q), it=res.it,
                comps=len(res.rp))


def phase_cp_simplex_kernels(device="cuda"):
    """``mincut_fused`` and ``components_fused`` against their plain
    versions on the inputs the cp-simplex path gives them: a float32 run
    of its device loop records them, and expansion cut 2 of CP iteration 3
    and that iteration's components call are replayed.  That cut misses
    its certificate within ``cut_it_max`` and continues from its own
    iterates, so both of its calls are replayed, each with the step cap
    the loop gave it, in float32 and, on the same inputs cast, in float64:
    in float64 equal steps, the same certificate outcome and equal sides;
    in float32 the same certificate outcome and, where both certify, cut
    values within twice the certificate.  The certificate of the float32
    iterates summed in float64 tells rounding in the kernel's float32 sums
    from slow convergence.  The components' labels must be equal bit for
    bit."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.maxflow.device import cut_value
    from cp_pfdr_graph_d1_tpu_torch.ops import components_fused as cf
    from cp_pfdr_graph_d1_tpu_torch.ops import mincut_fused as mf
    from cp_pfdr_graph_d1_tpu_torch.solvers import \
        cut_pursuit_simplex_device as csd
    g, q, opt = cp_simplex_setup(torch.float32, device)
    record = []
    csd.cp_loss_d1_simplex_device(g, q, al=1.0, opt=opt, record=record)
    it_c, n_c = 2, 2
    calls = [a for tag, *key, a in record if tag == "cut"
             and key == [it_c, n_c]]
    masks = [a for tag, *key, a in record if tag == "components"
             and key == [it_c]]
    check(len(calls) >= 1 and len(masks) == 1, "cp-simplex record lacks "
          f"cut {n_c} or the components of CP iteration {it_c + 1}")
    del record
    kw = dict(shifts=g.shifts, check_every=min(250, opt.cut_it_max))
    eu, ev, _ = g.host_coo()
    shape = (f"{SIDE_262K}x{SIDE_262K} F=2, expansion cut {n_c} of CP "
             f"iteration {it_c + 1}")
    out = dict(shape=shape, calls=[])
    for i, args32 in enumerate(calls):
        it_max = opt.cut_it_max * (1 if i == 0 else csd.CONTINUE_FACTOR)
        call = dict(it_max=it_max, tol=float(args32[6]))
        for name, args in (("float32", args32),
                           ("float64", tuple(a.double() for a in args32))):
            res, ms = [], []
            for fn in (mf.fused_pdhg_min_cut, mf.pdhg_min_cut_plain):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*args, it_max, **kw)
                float(r[2])
                ms.append((time.perf_counter() - t0) * 1e3)
                res.append(r)
            tol = float(args[6])
            cert = [float(r[2]) <= tol for r in res]
            steps = [int(r[4]) for r in res]
            sides = [(r[0] > r[3]).reshape(-1) for r in res]
            apart = int((sides[0] != sides[1]).sum())
            err = max(max_err(res[0][0], res[1][0]),
                      max_err(res[0][1], res[1][1]))
            w = args[0].reshape(-1).cpu().numpy()
            c = args[1].reshape(-1).cpu().numpy()
            vals = [cut_value(eu, ev, w, c, sd.cpu().numpy())
                    for sd in sides]
            row = dict(steps=steps, gap=[float(r[2]) for r in res],
                       certified=cert, sides_apart=apart, max_abs_err=err,
                       cut_values=vals, ms=ms[0], plain_ms=ms[1])
            line = (f"[cp-simplex cut] {shape}, call {i + 1} (cap {it_max} "
                    f"steps), {name}: kernel {steps[0]} steps gap "
                    f"{row['gap'][0]:.6g}, plain {steps[1]} steps gap "
                    f"{row['gap'][1]:.6g} (certificate {tol:.6g}); sides "
                    f"apart {apart}, cut values {vals[0]:.9g} vs "
                    f"{vals[1]:.9g}, x/z max|kernel-plain| {err:.3e}; "
                    f"{ms[0]:.1f} ms, plain {ms[1]:.1f} ms")
            if name == "float32":
                w64, c64 = args[0].double(), args[1].double()
                g64 = [float(mf.certificate_plain(
                    w64, c64, r[0].double(), r[1].double(),
                    shifts=g.shifts)[0]) for r in res]
                row["gap_summed_in_float64"] = g64
                line += ("; the same iterates' certificate summed in "
                         f"float64: kernel {g64[0]:.6g}, plain {g64[1]:.6g}")
            print(line, flush=True)
            check(cert[0] == cert[1], f"mincut_fused on the cp-simplex cut: "
                  f"certificate outcomes differ: {line}")
            if name == "float64":
                check(steps[0] == steps[1] and apart == 0, f"mincut_fused on "
                      f"the cp-simplex cut: {line}")
            elif all(cert):
                check(abs(vals[0] - vals[1]) <= 2 * tol, line)
            call[name] = row
        out["calls"].append(call)

    mask = (~masks[0] & (g.la_d1 > 0)).reshape(
        len(g.shifts), SIDE_262K, SIDE_262K).contiguous()
    ckw = dict(shifts=g.shifts, it_max=SIDE_262K * SIDE_262K)
    lab_k, rounds_k = cf.fused_components(mask, **ckw)
    lab_p, rounds_p = cf.components_plain(mask, **ckw)
    n_comp = int((lab_k.reshape(-1) == torch.arange(
        mask[0].numel(), device=device)).sum())
    check(bool((lab_k == lab_p).all()), "components_fused on the cp-simplex "
          "path: labels differ from the plain version's")
    t = components_call_times(lambda: cf.fused_components(mask, **ckw))
    comp = dict(shape=f"{SIDE_262K}x{SIDE_262K} F=2, components of CP "
                      f"iteration {it_c + 1}",
                passes=int(rounds_k), plain_rounds=int(rounds_p),
                components=n_comp, labels_equal=True, ms=t["ms"],
                device_us=t["device_us"], host_us=t["host_us"],
                plain_ms=cuda_ms(lambda: cf.components_plain(mask, **ckw),
                                 2))
    print(f"[cp-simplex components] {comp['shape']}: {n_comp} components, "
          f"labels equal to the plain version's; {comp['passes']} passes "
          f"(plain {comp['plain_rounds']} rounds); {t['device_us']:.2f} us "
          f"of device time, {comp['ms'] * 1e3:.2f} us per call (CUDA "
          f"events), {t['host_us']:.2f} us of host time; plain "
          f"{comp['plain_ms']:.2f} ms", flush=True)
    return out, comp


def phase_cp_simplex(ref, device="cuda"):
    """Main path: ``cp_loss_d1_simplex`` on ``bench_cut_pursuit_simplex``'s
    problem through ``cut="device"``, float32: one cold run (printing its
    per-iteration record), then the min of two warm runs; held against the
    float64 solve on the card: ML labels at most 2 % apart and objective
    within 1e-3 relative."""
    import torch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runs = [run_cp_simplex(torch.float32, device, verbose=1)]
    record = [ln for ln in buf.getvalue().splitlines()
              if ln.startswith("CP-simplex it")]
    runs += [run_cp_simplex(torch.float32, device),
             run_cp_simplex(torch.float32, device)]
    t_best = min(r[0] for r in runs[1:])
    _, res, g, q = runs[-1]
    p = res.rp[res.cv]
    check(np.all(np.isfinite(p)) and p.shape == (SIDE_262K ** 2, K_SIMPLEX),
          "multi-label cut-pursuit result not finite or of the wrong shape")
    dis = float(np.mean(p.argmax(1) != ref["ml"]))
    obj = simplex_objective(res, g, q)
    rel = abs(obj - ref["obj"]) / abs(ref["obj"])
    _, truth = cp_simplex_problem()
    acc = float(np.mean(p.argmax(1) == truth))
    print(f"[cp-simplex] float32 on the card, {SIDE_262K}x{SIDE_262K} "
          f"K={K_SIMPLEX}, cut='device': min of two warm runs "
          f"{t_best * 1e3:.1f} ms (cold {runs[0][0] * 1e3:.1f} ms); {res.it} "
          f"CP iterations, {len(res.rp)} components; ML labels apart from "
          f"float64 on the card {dis:.4%} (tol 2%), objective {obj:.9g} vs "
          f"{ref['obj']:.9g} (rel {rel:.2e}, tol 1e-3; float64 "
          f"{ref['seconds'] * 1e3:.1f} ms, {ref['it']} CP iterations, "
          f"{ref['comps']} components); accuracy against the clean labels "
          f"{acc:.4f}", flush=True)
    for ln in record:
        print(f"[cp-simplex] {ln}", flush=True)
    check(dis <= 0.02, f"multi-label CP labels {dis:.3%} apart from float64")
    check(rel <= 1e-3, f"multi-label CP objective {obj} vs float64 "
          f"{ref['obj']}: {rel:.3g} relative")
    return t_best


COMPONENTS_KERNEL = re.compile(r"cp_pfdr::comp\w*_kernel")


def print_components_share(name, per, counts):
    """The summed device time and launches of ``components_fused``'s
    kernels (the parent's ``components_kernel`` included) in one profiled
    run (``device_profile``'s per-kernel dict)."""
    keys = [k for k in per if COMPONENTS_KERNEL.search(k)]
    print(f"[profile] {name} run: components_fused "
          f"{sum(per[k] for k in keys):.2f} us of device time in "
          f"{sum(counts.get(k, 0) for k in keys)} kernel launches ("
          + "; ".join(f"{k[:40]} {per[k]:.2f} us x {counts.get(k, 0)}"
                      for k in keys) + ")", flush=True)


def phase_profile(device="cuda"):
    """Where the time goes, after the counted run: device time by kernel
    over 200 PFDR iterations against the host clock, and the cut-pursuit
    stage breakdown (``CP_PROFILE``) with its device busy time."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (DenseOp, PFDROptions,
                                            StencilGraphD1, VertexProx,
                                            pfdr_quadratic_d1)
    a, y = build_grid_problem()
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=torch.float32, device=device)
    op = DenseOp(torch.as_tensor(a, device=device))
    obs = torch.as_tensor(y, device=device)
    la_l1 = torch.full((g.num_vertices,), LA_L1, device=device)
    short = 200

    def solve():
        return pfdr_quadratic_d1(
            op, obs, g, la_l1=la_l1,
            vprox=VertexProx(kind="l1", positivity=True), lipsch=lip,
            opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=short))

    dev, per, wall = device_profile(solve, 1)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
    print(f"[profile] pfdr {short} iterations: device busy "
          f"{dev / short:.2f} us/iteration of {wall / short:.1f} us on the "
          f"host clock (idle share {1 - dev / wall:.3f}); top kernels: "
          + "; ".join(f"{k[:48]} {v / short:.2f} us" for k, v in top))

    os.environ["CP_PROFILE"] = "1"
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            dev, per, wall = device_profile(
                lambda: run_cp(g, a, y, np.float32, device), 1)
    finally:
        del os.environ["CP_PROFILE"]
    top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
    print(f"[profile] cp run: device busy {dev / 1e3:.1f} ms of "
          f"{wall / 1e3:.1f} ms on the host clock (idle share "
          f"{1 - dev / wall:.3f}); top kernels: "
          + "; ".join(f"{k[:48]} {v / 1e3:.2f} ms" for k, v in top))
    stages = [ln.split("]", 1)[1].strip() for ln in err.getvalue().splitlines()
              if ln.startswith("[CP_PROFILE]")]
    # the profiled call runs the solve twice (warm-up, then profiled)
    print("[profile] cp stages (last run): "
          + " | ".join(stages[len(stages) // 2:]), flush=True)

    # the chained EEG run, with the time of its warm partition apart
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, IdentityOp,
                                            StencilGraphD1 as Stencil)
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_chain as chn
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1
    warm, warm_s = chn._warm_partition, []

    def timed_warm(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = warm(*args)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
        return out

    chn._warm_partition = timed_warm
    counts = {}
    try:
        dev, per, wall = device_profile(lambda: cp_quadratic_d1(
            op, obs, g, la_l1=np.full(a.shape[1], LA_L1, np.float32),
            positivity=True, opt=chain_options()), 1, counts)
    finally:
        chn._warm_partition = warm
    print_components_share("cp-chain", per, counts)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] cp-chain run: device busy {dev / 1e3:.1f} ms of "
          f"{wall / 1e3:.1f} ms on the host clock (idle share "
          f"{1 - dev / wall:.3f}), of which the warm partition (3000 PFDR "
          f"iterations) {warm_s[-1] * 1e3:.1f} ms; top kernels: "
          + "; ".join(f"{k[:40]} {v / 1e3:.2f} ms" for k, v in top),
          flush=True)

    g5 = Stencil.create((SIDE_524K, SIDE_524K), {(0, 1): 0.35, (1, 0): 0.35},
                        dtype=torch.float32, device=device)
    y5 = torch.as_tensor(denoise_problem(), device=device)
    opt5 = CPOptions(dif_tol=1e-4, it_max=4,
                     pfdr=PFDROptions(rho=1.8, dif_tol=1e-5, it_max=2000),
                     cut="device", chain="off", cut_tol=1e-5,
                     cut_it_max=50_000)
    counts = {}
    dev, per, wall = device_profile(
        lambda: cp_quadratic_d1(IdentityOp(), y5, g5, opt=opt5), 1, counts)
    print_components_share("cp-device 524k", per, counts)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] cp-device 524k run: device busy {dev / 1e3:.1f} ms of "
          f"{wall / 1e3:.1f} ms on the host clock (idle share "
          f"{1 - dev / wall:.3f}); top kernels: "
          + "; ".join(f"{k[:40]} {v / 1e3:.2f} ms" for k, v in top),
          flush=True)

    dev, per, wall = device_profile(
        lambda: pfdr_simplex_solve(torch.float32, device, short), 1)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    print(f"[profile] pfdr-simplex {short} iterations: device busy "
          f"{dev / short:.2f} us/iteration of {wall / short:.1f} us on the "
          f"host clock (idle share {1 - dev / wall:.3f}); top kernels: "
          + "; ".join(f"{k[:48]} {v / short:.2f} us" for k, v in top),
          flush=True)
    profile_cp_simplex(device)


def profile_cp_simplex(device="cuda"):
    """Device busy share of one multi-label cut-pursuit run, with the host
    time of its cuts and of its reduced solves from the loop's own
    per-iteration record."""
    import torch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dev, per, wall = device_profile(
            lambda: run_cp_simplex(torch.float32, device, verbose=1), 1)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("CP-simplex it")]
    lines = lines[len(lines) // 2:]  # the profiled run, after the warm-up
    stages = [re.search(r"cuts continued (\[.*?\]).*cuts ([0-9.]+) "
                        r"ms, reduced solve ([0-9.]+) ms", ln).groups()
              for ln in lines]
    cut_ms = sum(float(c) for _, c, _ in stages)
    red_ms = sum(float(r) for _, _, r in stages)
    continued = [r for r, _, _ in stages]
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] cp-simplex run: device busy {dev / 1e3:.1f} ms of "
          f"{wall / 1e3:.1f} ms on the host clock (idle share "
          f"{1 - dev / wall:.3f}), of which the cuts {cut_ms:.1f} ms (cuts "
          f"continued per CP iteration: {', '.join(continued)}) and "
          f"the {len(stages)} reduced solves {red_ms:.1f} ms; top kernels: "
          + "; ".join(f"{k[:40]} {v / 1e3:.2f} ms" for k, v in top),
          flush=True)


# ---------------------------------------------------------------------------
# slice 4: unstructured meshes (banded and circulant containers)
# ---------------------------------------------------------------------------

MESH_SEED = 3     # bench.py:build_mesh_problem
LA_SIMPLEX = 0.5  # bench.py:bench_unstructured_simplex's edge weights
MESH_SIMPLEX_CASES = (("al=0", 0.0, None, False),
                      ("al=1 la_f", 1.0, 0.8, False),
                      ("al=0.2", 0.2, None, False),
                      ("al=0.2 labels", 0.2, None, True))
# per slot of a stage kernel: two forward values (6), the pair prox and its
# relaxation (20), the two weighted terms of the averages (4)
OPS_PER_SLOT = 30


@functools.lru_cache(maxsize=None)
def build_mesh_problem():
    """``bench.py:build_mesh_problem``: a Delaunay mesh of 19,600 random
    points in the unit square relabelled by ``strip_order`` (the port's),
    a dense A with N = 91 rows and 400 unit sources (seed 3), float32.
    Returns ``(eu, ev, a, y)``."""
    from scipy.spatial import Delaunay
    from cp_pfdr_graph_d1_tpu_torch import strip_order
    v = V_SIDE * V_SIDE
    r = np.random.default_rng(MESH_SEED)
    pts = r.random((v, 2))
    edges = set()
    for s in Delaunay(pts).simplices:
        for i in range(3):
            a_, b_ = int(s[i]), int(s[(i + 1) % 3])
            edges.add((min(a_, b_), max(a_, b_)))
    eu = np.fromiter((e[0] for e in edges), np.int32, len(edges))
    ev = np.fromiter((e[1] for e in edges), np.int32, len(edges))
    inv = np.empty(v, np.int64)
    inv[strip_order(pts)] = np.arange(v)
    eu, ev = inv[eu].astype(np.int32), inv[ev].astype(np.int32)
    a = (r.standard_normal((N_OBS, v)) / np.sqrt(N_OBS)).astype(np.float32)
    x_true = np.zeros(v, np.float32)
    x_true[r.integers(0, v, 400)] = 1.0
    y = (a @ x_true + 0.01 * r.standard_normal(N_OBS)).astype(np.float32)
    return eu, ev, a, y


def grid_edges():
    """The 140 x 140 grid's edges in row-major order (``bench.py``)."""
    idx = np.arange(V_SIDE * V_SIDE).reshape(V_SIDE, V_SIDE)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return eu.astype(np.int32), ev.astype(np.int32)


def mesh_graph(kind, dtype, device, la=LA_D1):
    """The mesh as a ``BandedGraphD1`` or a ``CirculantGraphD1`` (default
    options: 64 families at most)."""
    from cp_pfdr_graph_d1_tpu_torch import BandedGraphD1, CirculantGraphD1
    eu, ev, _, _ = build_mesh_problem()
    cls = BandedGraphD1 if kind == "banded" else CirculantGraphD1
    return cls.create(eu, ev, la, num_vertices=V_SIDE * V_SIDE, dtype=dtype,
                      device=device)


def quadratic_setup(g, a, y, dtype, device):
    """Operator, observation, l1 weights and Lipschitz bound of the
    quadratic problem ``(a, y)`` (positivity, ``la_l1 = 2e-3``)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import DenseOp
    op = DenseOp(torch.as_tensor(a, dtype=dtype, device=device))
    obs = torch.as_tensor(y, dtype=dtype, device=device)
    la_l1 = torch.full((g.num_vertices,), LA_L1, dtype=dtype, device=device)
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    return op, obs, la_l1, lip


def stage_args(g, a, y, dtype, device):
    """Arguments of one quadratic PFDR stage on the container ``g``: the
    problem's preconditioner and a seeded random iterate and auxiliary
    pairs, as the stage kernels take them (``(graph, x, grad, ga, th_l1,
    zu, zv, wu, wv, w_d1u, w_d1v, th_d1)``)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
    from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import \
        initial_precondition
    op, obs, la_l1, lip = quadratic_setup(g, a, y, dtype, device)
    pre = initial_precondition(op, obs, g, la_l1, 1.5, lip, Lipsch.SCAL)
    r = np.random.default_rng(11)
    t = lambda z: torch.as_tensor(z, dtype=dtype, device=device)  # noqa
    x = t(np.abs(r.normal(size=g.num_vertices)) * 0.5)
    zu = t(r.normal(size=g.num_edges) * 0.5)
    zv = t(r.normal(size=g.num_edges) * 0.5)
    return (g, x, op.grad(x, obs), pre.ga, pre.th_l1, zu, zv, pre.wu, pre.wv,
            pre.w_d1u, pre.w_d1v, pre.th_d1)


def check_stage(name, kern, plain, args, dtype, device):
    """A quadratic stage kernel against its plain version for the four
    vertex proxes: x and the sums everywhere, zu and zv on the real slots
    (the z values of a circulant container's virtual slots depend on the
    path and are never consumed), and a second call on the same inputs
    bit-equal to the first (the sums do not depend on the blocks' order).
    Returns the largest absolute error of the fields."""
    import torch
    real = args[0].la_d1 != 0
    tol = F64_TOL if dtype == torch.float64 else F32_TOL
    worst = 0.0
    for vp in vertex_proxes():
        kw = dict(rho=1.5, vkind=vp.kind, positivity=vp.positivity,
                  lo=float(vp.lo), hi=float(vp.hi))
        out_k = kern(*args, **kw)
        out_p = plain(*args, **kw)
        if device == "cuda":
            check(out_k[0].is_cuda, f"{name}: kernel output not on the card")
        again = kern(*args, **kw)
        check(all(bool(torch.equal(a, b)) for a, b in zip(out_k, again)),
              f"{name} {dtype}: two calls on the same inputs differ")
        err = max(max_err(out_k[0], out_p[0]),
                  max_err(out_k[1][real], out_p[1][real]),
                  max_err(out_k[2][real], out_p[2][real]))
        rel = max(max_err(k, p) / max(1.0, float(p.abs()))
                  for k, p in zip(out_k[3:], out_p[3:]))
        worst = max(worst, err)
        label = f"{vp.kind}{'+pos' if vp.positivity else ''}"
        check(err <= tol and rel <= tol, f"{name} {dtype} {label}: x/zu/zv "
              f"err {err:.3g}, sums rel err {rel:.3g} (tol {tol})")
        print(f"[{name}] {str(dtype)[6:]} {vp.kind:6s} pos="
              f"{int(vp.positivity)} x/zu/zv max|kernel-plain| = {err:.3e},"
              f" num/den rel err {rel:.3e} (tol {tol:g}); a second call "
              f"bit-equal", flush=True)
    return worst


def time_pair(kern, plain, reps=200, plain_reps=50):
    """``dict(ms, plain_ms, device_us)``: CUDA-event milliseconds per call
    of a kernel's wrapper and of its plain version, and the wrapper's
    device microseconds per call (torch.profiler)."""
    return dict(ms=cuda_ms(kern, reps), plain_ms=cuda_ms(plain, plain_reps),
                device_us=device_profile(kern, reps)[0])


def host_us(fn, n=10_000):
    """Host microseconds per call of ``fn`` over ``n`` calls
    (``time.perf_counter_ns``), after one call; the card is synchronised
    before and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / n / 1e3


def banded_host_costs(g, x, vu, vv):
    """``[banded-host]``: host microseconds per call of each step of the
    banded wrappers' launch path, on the mesh's float32 [V] field: the
    steps of the former launch path (checks, ``edge_index()``,
    ``_lib()``, two allocations, a device context with a new stream object,
    ``contiguous()``) and the steps it takes now (the plan's key and
    lookup, one allocation split in two rows, the raw stream, the
    four-argument call through ``ctypes.PyDLL`` with its launch), then
    whole calls beside ``index_select`` and two ``index_add_``.  The
    ctypes call of eleven arguments that the old path made is gone and is
    not timed here."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import _build
    from cp_pfdr_graph_d1_tpu_torch.ops import banded
    idx = g.edge_index()
    both = torch.cat([idx.eu, idx.ev]).to(torch.int64)
    shape = (g.num_edges,)
    dev = x.get_device()
    fn, plan, out_shape, index, _ = g._banded_plans[
        ("gather", x.dtype, x.shape, dev)]
    out = x.new_empty(out_shape)
    _build.cuda_kernels()._cp_banded_probe = True  # the old _lib()'s flag

    def old_context():
        with torch.cuda.device(x.device):
            return torch.cuda.current_stream().cuda_stream

    steps = {
        "old: _check_float": lambda: banded._check_float("x", x, x),
        "old: graph.edge_index()": g.edge_index,
        "old: _lib() (library lookup, getattr and flag)": lambda: getattr(
            _build.cuda_kernels(), "_cp_banded_probe", False),
        "old: two new_empty": lambda: (x.new_empty(shape),
                                       x.new_empty(shape)),
        "old: device context + current_stream()": old_context,
        "old: x.contiguous()": x.contiguous,
        "new: plan key + lookup": lambda: g._banded_plans.get(
            ("gather", x.dtype, x.shape, x.get_device())),
        "new: x.is_contiguous()": x.is_contiguous,
        "new: x.new_empty [2, E] + unbind": lambda: x.new_empty(
            out_shape).unbind(),
        "new: raw stream": lambda: banded._raw_stream(index),
        "new: ctypes call (PyDLL) + launch": lambda: fn(
            plan, x.data_ptr(), out.data_ptr(), banded._raw_stream(index)),
        "banded_gather": lambda: banded.banded_gather(g, x),
        "graph.gather_endpoints": lambda: g.gather_endpoints(x),
        "index_select": lambda: x.index_select(0, both),
        "banded_scatter": lambda: banded.banded_scatter(g, vu, vv),
        "graph.edge_to_vertex_sum": lambda: g.edge_to_vertex_sum(vu, vv),
        "index_add_ x2": lambda: torch.zeros_like(x).index_add_(
            0, g.eu, vu).index_add_(0, g.ev, vv),
    }
    costs = {name: host_us(f) for name, f in steps.items()}
    print("[banded-host] host us per call, 10,000 calls each, mesh float32 "
          "[V]: " + "; ".join(f"{k} {v:.2f}" for k, v in costs.items()),
          flush=True)
    return costs


def phase_banded_transfers(device="cuda"):
    """``banded_gather`` and ``banded_scatter`` against their plain versions
    on the mesh's banded container and on a star graph (vertex 0 joined to
    4,095 leaves: a hub row of 4,095 slots), for [V] and [V, 4] fields, in
    float64 (1e-12) and float32 (F32_TOL relative to the largest value);
    float32 [V] times beside ``torch.index_select`` (the gather in one
    call on the concatenated endpoints) and two ``index_add_`` calls into
    zeros (the scatter; its float atomics make it nondeterministic)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import BandedGraphD1
    from cp_pfdr_graph_d1_tpu_torch.ops import banded
    star_v = 4096
    leaves = np.arange(1, star_v, dtype=np.int32)
    out = {}
    for dtype in (torch.float64, torch.float32):
        graphs = {
            "mesh": mesh_graph("banded", dtype, device),
            "star": BandedGraphD1.create(np.zeros(star_v - 1, np.int32),
                                         leaves, 0.5, num_vertices=star_v,
                                         dtype=dtype, device=device)}
        tol = 1e-12 if dtype == torch.float64 else F32_TOL
        for gname, g in graphs.items():
            r = np.random.default_rng(5)
            for k in (None, K_SIMPLEX):
                shape = (g.num_vertices,) + (() if k is None else (k,))
                eshape = (g.num_edges,) + shape[1:]
                x = torch.as_tensor(r.normal(size=shape), dtype=dtype,
                                    device=device)
                vu = torch.as_tensor(r.normal(size=eshape), dtype=dtype,
                                     device=device)
                vv = torch.as_tensor(r.normal(size=eshape), dtype=dtype,
                                     device=device)
                gk = banded.banded_gather(g, x)
                gp = banded.banded_gather_plain(g, x)
                sk = banded.banded_scatter(g, vu, vv)
                sp = banded.banded_scatter_plain(g, vu, vv)
                if device == "cuda":
                    check(gk[0].is_cuda and sk.is_cuda,
                          "banded kernel output not on the card")
                g_err = max(max_err(gk[0], gp[0]), max_err(gk[1], gp[1]))
                s_err = max_err(sk, sp) / max(1.0, float(sp.abs().max()))
                check(g_err == 0.0, f"banded_gather {gname} {dtype}: err "
                      f"{g_err:.3g}")
                check(s_err <= tol, f"banded_scatter {gname} {dtype}: rel "
                      f"err {s_err:.3g} > {tol}")
                sk2 = banded.banded_scatter(g, vu, vv)
                check(bool(torch.equal(sk, sk2)), f"banded_scatter {gname} "
                      f"{dtype}: two calls differ")
                line = (f"[banded] {str(dtype)[6:]} {gname} V={g.num_vertices}"
                        f" E={g.num_edges} K={k or 1}: gather "
                        f"max|kernel-plain| {g_err:.3e}, scatter "
                        f"max|kernel-plain|/max(1,max|plain|) {s_err:.3e} "
                        f"(tol {tol:g}), repeat bit-equal")
                if dtype == torch.float32 and k is None and device == "cuda":
                    idx = g.edge_index()
                    both = torch.cat([idx.eu, idx.ev]).to(torch.int64)
                    eu64, ev64 = g.eu, g.ev
                    t_g = time_pair(lambda: banded.banded_gather(g, x),
                                    lambda: banded.banded_gather_plain(g, x))
                    t_s = time_pair(
                        lambda: banded.banded_scatter(g, vu, vv),
                        lambda: banded.banded_scatter_plain(g, vu, vv))
                    t_g["library_ms"] = cuda_ms(
                        lambda: x.index_select(0, both), 200)
                    t_s["library_ms"] = cuda_ms(
                        lambda: torch.zeros_like(x).index_add_(
                            0, eu64, vu).index_add_(0, ev64, vv), 200)
                    out[gname] = dict(
                        v=g.num_vertices, e=g.num_edges,
                        long_rows=int(idx.long_rows.numel()),
                        gather=t_g, scatter=t_s)
                    if gname == "mesh":
                        out["host"] = banded_host_costs(g, x, vu, vv)
                    line += "; float32 per call:"
                    for kname, t, lib in (("gather", t_g, "index_select"),
                                          ("scatter", t_s, "index_add_ x2")):
                        line += (f" {kname} {t['ms'] * 1e3:.2f} us "
                                 f"({t['device_us']:.2f} us of device time;"
                                 f" plain {t['plain_ms'] * 1e3:.2f}, {lib} "
                                 f"{t['library_ms'] * 1e3:.2f});")
                    line += (f" rows of more than {banded.LONG_ROW} slots: "
                             f"{int(idx.long_rows.numel())}")
                errs = out.setdefault("err", {})
                for kern, e in (("gather", g_err), ("scatter", s_err)):
                    key = (kern, gname, dtype)
                    errs[key] = max(errs.get(key, 0.0), e)
                print(line, flush=True)
    return out


def phase_banded_fused(device="cuda"):
    """``banded_fused`` against its plain version on the mesh's banded
    container, one stage from a random state, for the four vertex proxes,
    float64 and float32; float32 times per call (CUDA events, device time,
    host time)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import banded_fused as bf
    _, _, a, y = build_mesh_problem()
    errs, times = {}, {}
    for dtype in (torch.float64, torch.float32):
        args = stage_args(mesh_graph("banded", dtype, device), a, y, dtype,
                          device)
        errs[dtype] = check_stage("banded_fused", bf.fused_banded_iteration,
                                  bf.banded_fused_plain, args, dtype, device)
        if dtype == torch.float32 and device == "cuda":
            kw = dict(rho=1.5, vkind="l1", positivity=True, lo=-np.inf,
                      hi=np.inf)
            step = lambda: bf.fused_banded_iteration(*args, **kw)  # noqa
            times = time_pair(step,
                              lambda: bf.banded_fused_plain(*args, **kw))
            times.update(e=args[0].num_edges, host_us=host_us(step))
            print(f"[banded_fused] float32 mesh V={args[0].num_vertices} "
                  f"E={times['e']} (banded order, padded) l1+pos, per call: "
                  f"kernel {times['ms'] * 1e3:.2f} us "
                  f"({times['device_us']:.2f} us of device time, "
                  f"{times['host_us']:.2f} us of host time over 10,000 "
                  f"calls), plain {times['plain_ms'] * 1e3:.2f} us",
                  flush=True)
    return errs, times


def phase_circulant_fused(device="cuda"):
    """``circulant_fused`` against its plain version, one stage from a random
    state, for the four vertex proxes, float64 and float32: on the mesh's
    circulant container (64 families and a banded remainder) and on the
    140 x 140 grid built as a circulant container (2 families, no
    remainder); float32 times per call on the mesh (CUDA events, device
    time, host time)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import CirculantGraphD1
    from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused as cf
    _, _, a_m, y_m = build_mesh_problem()
    a_g, y_g = build_grid_problem()
    geu, gev = grid_edges()
    errs, times = {}, {}
    for dtype in (torch.float64, torch.float32):
        cases = (("mesh", mesh_graph("circulant", dtype, device), a_m, y_m),
                 ("grid", CirculantGraphD1.create(
                     geu, gev, LA_D1, num_vertices=V_SIDE * V_SIDE,
                     dtype=dtype, device=device), a_g, y_g))
        for gname, g, a, y in cases:
            print(f"[circulant_fused] {gname}: {len(g.offsets)} families of "
                  f"{g.vv} slots, {g.num_rem} remainder slots", flush=True)
            check((g.num_rem > 0) == (gname == "mesh"),
                  f"circulant {gname}: {g.num_rem} remainder slots")
            args = stage_args(g, a, y, dtype, device)
            errs[(gname, dtype)] = check_stage(
                f"circulant_fused {gname}", cf.fused_circulant_iteration,
                cf.circulant_fused_plain, args, dtype, device)
            if dtype == torch.float32 and gname == "mesh" and \
                    device == "cuda":
                kw = dict(rho=1.5, vkind="l1", positivity=True, lo=-np.inf,
                          hi=np.inf)
                step = lambda: cf.fused_circulant_iteration(  # noqa
                    *args, **kw)
                times = time_pair(
                    step, lambda: cf.circulant_fused_plain(*args, **kw))
                times.update(f=len(g.offsets), vv=g.vv, rem=g.num_rem,
                             host_us=host_us(step))
                print(f"[circulant_fused] float32 mesh l1+pos, per call: "
                      f"kernel {times['ms'] * 1e3:.2f} us "
                      f"({times['device_us']:.2f} us of device time, "
                      f"{times['host_us']:.2f} us of host time over 10,000 "
                      f"calls), plain {times['plain_ms'] * 1e3:.2f} us",
                      flush=True)
    return errs, times


def mesh_simplex_q():
    """``bench_unstructured_simplex``'s observations: Dirichlet(0.7) rows of
    K = 4 labels on the mesh (seed 13)."""
    r = np.random.default_rng(13)
    return r.dirichlet(np.full(K_SIMPLEX, 0.7),
                       size=V_SIDE * V_SIDE).astype(np.float32)


def mesh_simplex_problem(dtype, device, la_f):
    import torch
    g = mesh_graph("circulant", dtype, device, la=LA_SIMPLEX)
    q = torch.as_tensor(mesh_simplex_q(), dtype=dtype, device=device)
    laf = (torch.full((g.num_vertices,), la_f, dtype=dtype, device=device)
           if la_f is not None else None)
    return g, q, laf


def mesh_simplex_planes(dtype, device, al, la_f, label_mode, seed=3):
    """Kernel inputs of one multi-label iteration on the mesh's circulant
    container: the problem's preconditioner, a seeded random iterate on
    the simplex and random auxiliary pairs, as ``[K, V]`` and ``[K, E]``
    planes."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_simplex as ps
    g, q, laf = mesh_simplex_problem(dtype, device, la_f)
    t = lambda z: torch.as_tensor(z, dtype=dtype, device=device)  # noqa
    r = np.random.default_rng(seed)
    p = t(r.dirichlet(np.ones(K_SIMPLEX), size=g.num_vertices))
    pre = ps.initial_precondition_simplex(al, laf, g, q, p, 1.5)
    zu0, zv0 = g.gather_endpoints(p)
    zu = zu0 + t(0.05 * r.standard_normal(zu0.shape))
    zv = zv0 + t(0.05 * r.standard_normal(zv0.shape))
    tv = g.vertex_planes
    laf3 = tv(laf[:, None] if laf is not None
              else torch.zeros((g.num_vertices, 1), dtype=dtype,
                               device=device))
    prev = (tv(torch.argmax(p, dim=1).to(dtype)[:, None]) if label_mode
            else tv(p))
    args = ((g, tv(p), tv(q), laf3, tv(pre.ga), tv(pre.ga_proj), prev)
            + tuple(tv(z) for z in (zu, zv, pre.wu, pre.wv, pre.w_d1u,
                                    pre.w_d1v, pre.th_d1)))
    kw = dict(rho=1.5, al=al, has_laf=la_f is not None,
              label_mode=label_mode)
    return args, kw


def mesh_simplex_loop(dtype, device, al, la_f, label_mode, plain):
    """400 iterations of the solver's kernel loop on the mesh's circulant
    container from the uniform start, each iteration the kernel's wrapper
    or, with ``plain``, its plain version, both on the card."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions
    from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused_simplex as cfs
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_simplex as ps
    g, q, laf = mesh_simplex_problem(dtype, device, la_f)
    p0 = torch.full_like(q, 1.0 / K_SIMPLEX)
    pre = ps.initial_precondition_simplex(al, laf, g, q, p0, 1.5)
    opt = PFDROptions(rho=1.5, dif_tol=1.0 if label_mode else 1e-9,
                      it_max=400)
    step = functools.partial(cfs.circulant_simplex_plain, g) if plain else None
    res = ps._simplex_fused_loop(g, q, p0, laf, pre, al=al, opt=opt,
                                 has_laf=laf is not None,
                                 label_mode=label_mode, step=step)
    return res.p, res.it


def phase_circulant_simplex(device="cuda"):
    """``circulant_fused_simplex`` against its plain version on the mesh,
    K = 4, for four losses: one iteration (float64 within F64_TOL, float32
    within F32_TOL on p and the real slots' zu, zv, the evolution sum
    relative to max(1, |plain|); in label mode equal labels and counts in
    float64, at most 0.1 % of the vertices apart in float32), then a
    400-iteration float64 loop of each with equal iteration counts.
    float32 times per call for the main path's case (al = 1, no la_f)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused_simplex as cfs
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    v = V_SIDE * V_SIDE
    for dtype in (torch.float64, torch.float32):
        tol = F64_TOL if dtype == torch.float64 else F32_TOL
        for name, al, la_f, label_mode in MESH_SIMPLEX_CASES:
            args, kw = mesh_simplex_planes(dtype, device, al, la_f,
                                           label_mode)
            real = args[0].la_d1 != 0
            out_k = cfs.fused_circulant_simplex_iteration(*args, **kw)
            out_p = cfs.circulant_simplex_plain(*args, **kw)
            if device == "cuda":
                check(out_k[0].is_cuda, "kernel output not on the card")
            err = max(max_err(out_k[0], out_p[0]),
                      max_err(out_k[2][:, real], out_p[2][:, real]),
                      max_err(out_k[3][:, real], out_p[3][:, real]))
            if label_mode:
                n_lab = int((out_k[1] != out_p[1]).sum())
                d_cnt = abs(float(out_k[4]) - float(out_p[4]))
                allowed = 0 if dtype == torch.float64 else v // 1000
                check(n_lab <= allowed and d_cnt <= allowed,
                      f"circulant_fused_simplex {dtype} {name}: {n_lab} "
                      f"labels and count {d_cnt} apart (allowed {allowed})")
                extra = (f"labels apart {n_lab}, counts {float(out_k[4]):.0f}"
                         f" vs {float(out_p[4]):.0f}")
            else:
                err = max(err, max_err(out_k[1], out_p[1]))
                rel = (max_err(out_k[4], out_p[4])
                       / max(1.0, abs(float(out_p[4]))))
                check(rel <= tol, f"circulant_fused_simplex {dtype} {name}: "
                      f"sum rel err {rel:.3g} > {tol}")
                extra = f"evolution sum rel err {rel:.3e}"
            check(err <= tol, f"circulant_fused_simplex {dtype} {name}: "
                  f"p/zu/zv err {err:.3g} > {tol}")
            errs[dtype] = max(errs[dtype], err)
            line = (f"[circulant_fused_simplex] {str(dtype)[6:]} {name:13s} "
                    f"one iteration: p/zu/zv max|kernel-plain| = {err:.3e} "
                    f"(tol {tol:g}); {extra}")
            if dtype == torch.float64:
                pk, itk = mesh_simplex_loop(dtype, device, al, la_f,
                                            label_mode, plain=False)
                pp, itp = mesh_simplex_loop(dtype, device, al, la_f,
                                            label_mode, plain=True)
                lerr = max_err(pk, pp)
                check(itk == itp and lerr <= F64_TOL,
                      f"circulant_fused_simplex {name}: loop of {itk} "
                      f"iterations vs plain {itp}, p err {lerr:.3g}")
                line += (f"; 400-iteration loop: {itk} iterations (plain "
                         f"{itp}), p max|kernel-plain| {lerr:.3e}")
            print(line, flush=True)
    times = {}
    if device == "cuda":
        args, kw = mesh_simplex_planes(torch.float32, device, 1.0, None,
                                       False)
        times = time_pair(
            lambda: cfs.fused_circulant_simplex_iteration(*args, **kw),
            lambda: cfs.circulant_simplex_plain(*args, **kw))
        g = args[0]
        times.update(f=len(g.offsets), vv=g.vv, rem=g.num_rem)
        print(f"[circulant_fused_simplex] float32 mesh K={K_SIMPLEX} al=1, "
              f"per call: kernel {times['ms'] * 1e3:.2f} us "
              f"({times['device_us']:.2f} us of device time), plain "
              f"{times['plain_ms'] * 1e3:.2f} us", flush=True)
    return errs, times


def mesh_pfdr(dtype, device, container, iters=3000, monitor=False):
    """``bench_unstructured``'s solve (l1 with positivity, rho = 1.5,
    dif_tol = 0): through ``api.pfdr_quadratic_d1_l1`` for the "auto",
    "circulant" and "coo" containers, through ``pfdr_quadratic_d1`` on a
    ``BandedGraphD1`` for "banded".  Returns ``(x on the host, iterations,
    seconds)``."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (PFDROptions, VertexProx, api,
                                            pfdr_quadratic_d1)
    eu, ev, a, y = build_mesh_problem()
    v = a.shape[1]
    npd = np.float64 if dtype == torch.float64 else np.float32
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    if container == "banded":
        g = mesh_graph("banded", dtype, device)
        op, obs, la_l1, _ = quadratic_setup(g, a, y, dtype, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if container == "banded":
        res = pfdr_quadratic_d1(
            op, obs, g, la_l1=la_l1,
            vprox=VertexProx(kind="l1", positivity=True), lipsch=lip,
            opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=iters),
            monitor=monitor)
        x, it = res.x.cpu(), res.it
    else:
        out = api.pfdr_quadratic_d1_l1(
            y.astype(npd), a.astype(npd), eu, ev, LA_D1,
            La_l1=np.full(v, LA_L1, npd), positivity=True, L=lip,
            PFDR_rho=1.5, PFDR_difTol=0.0, PFDR_itMax=iters, monitor=monitor,
            container=container, device=device)
        x, it = out.X.cpu(), out.it
    return x, it, time.perf_counter() - t0


def mesh_reference(device="cuda"):
    """The float64 solve on the card that the mesh paths are held against
    (run before the paths' counted windows)."""
    import torch
    x, it, dt = mesh_pfdr(torch.float64, device, "auto")
    print(f"[pfdr-mesh] float64 reference on the card: {it} iterations, "
          f"{dt:.2f} s", flush=True)
    return x


def phase_pfdr_mesh(x64, device="cuda", iters=3000):
    """Main path: ``api.pfdr_quadratic_d1_l1(..., container="auto")`` on
    ``bench_unstructured``'s problem, float32, through
    ``circulant_fused``; max |x - x64| <= 1e-3.  Then the same solve
    through the staged loop on a COO ``GraphD1`` on the card, for
    scale."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import CirculantGraphD1, api
    from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused as cf
    eu, ev, a, _ = build_mesh_problem()
    g = api._graph(eu, ev, LA_D1, a.shape[1], torch.float32, device, "auto")
    check(isinstance(g, CirculantGraphD1), f"container='auto' chose "
          f"{type(g).__name__} for the mesh")
    before = cf.fused_circulant_iteration.launches
    x, it, dt = mesh_pfdr(torch.float32, device, "auto", iters)
    grew = cf.fused_circulant_iteration.launches - before
    check(grew == iters and it == iters, f"circulant_fused launched {grew} "
          f"times in a {it}-iteration solve")
    check(bool(torch.isfinite(x).all()) and x.shape == (a.shape[1],),
          "mesh PFDR result not finite or misshapen")
    err = max_err(x, x64)
    n_edges = len(eu)
    print(f"[pfdr-mesh] float32 mesh V={a.shape[1]} E={n_edges} N={N_OBS}, "
          f"container='auto' -> CirculantGraphD1 ({len(g.offsets)} families "
          f"of {g.vv} slots, {g.num_rem} remainder slots), {iters} "
          f"iterations through circulant_fused: {dt * 1e6 / iters:.2f} "
          f"us/iteration, {n_edges * iters / dt:.4g} edge-updates/s "
          f"(launches +{grew}); max|x - x float64 on the card| {err:.3e} "
          f"(tol 1e-3)", flush=True)
    check(err <= 1e-3, f"mesh PFDR float32 vs float64: {err:.3g}")
    short = 300
    _, _, dt_coo = mesh_pfdr(torch.float32, device, "coo", short)
    print(f"[pfdr-mesh] the same solve through the staged loop on a COO "
          f"GraphD1 on the card, {short} iterations: "
          f"{dt_coo * 1e6 / short:.2f} us/iteration, "
          f"{n_edges * short / dt_coo:.4g} edge-updates/s; the circulant "
          f"layout moves {len(g.offsets) * g.vv + g.num_rem} slots for "
          f"{n_edges} edges", flush=True)
    return dt * 1e6 / iters


def phase_pfdr_mesh_banded(x64, device="cuda", iters=3000):
    """Main path: ``pfdr_quadratic_d1`` on the mesh's ``BandedGraphD1``,
    float32: monitored (the ``banded_fused`` loop, with ``banded_gather``
    and ``banded_scatter`` in the preconditioner and the objective), then
    unmonitored (one ``solve_fused`` launch); each held against x64 at
    1e-3."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import banded_fused as bf
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused as sfu
    out = {}
    for monitor in (True, False):
        before = (bf.fused_banded_iteration.launches,
                  sfu.fused_pfdr_solve.launches)
        x, it, dt = mesh_pfdr(torch.float32, device, "banded", iters,
                              monitor=monitor)
        grew = (bf.fused_banded_iteration.launches - before[0],
                sfu.fused_pfdr_solve.launches - before[1])
        want = (iters, 0) if monitor else (0, 1)
        check(grew == want and it == iters, f"banded solve (monitor="
              f"{monitor}): launches (banded_fused, solve_fused) +{grew}, "
              f"expected +{want}, {it} iterations")
        check(bool(torch.isfinite(x).all()), "banded result not finite")
        err = max_err(x, x64)
        route = "banded_fused loop" if monitor else "solve_fused whole solve"
        print(f"[pfdr-mesh-banded] float32 BandedGraphD1, monitor="
              f"{int(monitor)}, {iters} iterations through the {route}: "
              f"{dt * 1e6 / iters:.2f} us/iteration (launches +{grew}); "
              f"max|x - x float64 on the card| {err:.3e} (tol 1e-3)",
              flush=True)
        check(err <= 1e-3, f"banded PFDR float32 vs float64: {err:.3g}")
        out["monitor" if monitor else "whole"] = dt * 1e6 / iters
    return out


def mesh_simplex_solve(dtype, device, iters, fused="auto"):
    """``bench_unstructured_simplex``'s solve: al = 1, rho = 1.5,
    dif_tol = 0, on the mesh's circulant container."""
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions, pfdr_loss_d1_simplex
    g, q, _ = mesh_simplex_problem(dtype, device, None)
    return pfdr_loss_d1_simplex(
        g, q, al=1.0, opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=iters,
                                      fused=fused))


def phase_pfdr_mesh_simplex(p64, device="cuda", iters=3000):
    """Main path: ``pfdr_loss_d1_simplex`` on the mesh's
    ``CirculantGraphD1`` (``bench_unstructured_simplex``), float32, through
    ``circulant_fused_simplex``; max |p - p64| <= 1e-3."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused_simplex as cfs
    before = cfs.fused_circulant_simplex_iteration.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mesh_simplex_solve(torch.float32, device, iters)
    p = res.p.cpu()
    dt = time.perf_counter() - t0
    grew = cfs.fused_circulant_simplex_iteration.launches - before
    check(grew == iters and res.it == iters, f"circulant_fused_simplex "
          f"launched {grew} times in a {res.it}-iteration solve")
    check(bool(torch.isfinite(p).all())
          and p.shape == (V_SIDE * V_SIDE, K_SIMPLEX),
          "mesh multi-label result not finite or misshapen")
    err = max_err(p, p64)
    n_edges = len(build_mesh_problem()[0])
    print(f"[pfdr-mesh-simplex] float32 mesh K={K_SIMPLEX}, {iters} "
          f"iterations through circulant_fused_simplex: "
          f"{dt * 1e6 / iters:.2f} us/iteration, "
          f"{n_edges * iters / dt:.4g} edge-updates/s (launches +{grew}); "
          f"max|p - p float64 on the card| {err:.3e} (tol 1e-3); row sums "
          f"within {float((p.double().sum(1) - 1).abs().max()):.2e} of 1",
          flush=True)
    check(err <= 1e-3, f"mesh multi-label PFDR float32 vs float64: "
          f"{err:.3g}")
    return dt * 1e6 / iters


def profile_mesh(device="cuda"):
    """Device busy share and top device items per iteration of the three
    mesh paths (the banded path monitored and whole), from the difference
    of a 100- and an 1100-iteration solve (each the quicker of two runs on
    the host clock), so that the set-up (the container's upload and build,
    the preconditioner) falls out; then the set-up's own device time and
    top items.  A copy made as often in both solves is set-up: a pageable
    upload's device time waits on the host's staging and varies by
    milliseconds between runs, which the difference would spread over the
    iterations."""
    import torch

    def quicker(n):
        runs_n = []
        for _ in range(2):
            cnt = {}
            runs_n.append(device_profile(lambda: fn(n), 1, cnt) + (cnt,))
        return min(runs_n, key=lambda r: r[2])
    runs = (("pfdr-mesh", lambda n: mesh_pfdr(torch.float32, device, "auto",
                                              n)),
            ("pfdr-mesh-banded monitored",
             lambda n: mesh_pfdr(torch.float32, device, "banded", n,
                                 monitor=True)),
            ("pfdr-mesh-banded whole",
             lambda n: mesh_pfdr(torch.float32, device, "banded", n)),
            ("pfdr-mesh-simplex",
             lambda n: mesh_simplex_solve(torch.float32, device, n).p.cpu()))
    lo, hi = 100, 1100
    for name, fn in runs:
        (_, per_lo, wall_lo, cnt_lo), (_, per_hi, wall_hi, cnt_hi) = (
            quicker(lo), quicker(hi))
        n = hi - lo
        per = {k: (v - per_lo.get(k, 0.0)) / n for k, v in per_hi.items()
               if not (k.startswith("Memcpy")
                       and cnt_hi.get(k) == cnt_lo.get(k))}
        setup = {k: v - lo * per.get(k, 0.0) for k, v in per_lo.items()}
        dev, wall = sum(per.values()), (wall_hi - wall_lo) / n
        top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
        top_setup = sorted(setup.items(), key=lambda kv: -kv[1])[:3]
        print(f"[profile] {name}, per iteration ({hi} - {lo} iterations): "
              f"device busy {dev:.2f} us of {wall:.1f} us on the host clock "
              f"(idle share {1 - dev / wall:.3f}); top items: "
              + "; ".join(f"{k[:48]} {v:.2f} us" for k, v in top)
              + f"; set-up outside the iterations {sum(setup.values()):.1f} "
              f"us of device time: "
              + "; ".join(f"{k[:48]} {v:.1f} us" for k, v in top_setup),
              flush=True)
        print(f"[profile] {name}, copies of the {lo}-iteration solve: "
              + "; ".join(f"{k} x{cnt_lo[k]} {v:.1f} us"
                          for k, v in per_lo.items()
                          if k.startswith("Memcpy")), flush=True)


# ---------------------------------------------------------------------------
# slice 5: distribution — the row-sharded (halo) stencil PFDR and its kernel
# ---------------------------------------------------------------------------

HALO_SIDE = 2048          # 2048 x 2048 field: V = 4,194,304
HALO_SHARDS = (1, 2, 4)
HALO_FAMILIES = {1: {(0, 1): 0.35, (1, 0): 0.35},
                 2: {(0, 1): 0.1, (1, 0): 0.12, (2, 0): 0.05, (1, -1): 0.07}}
HALO_ITERS = 500
HALO_SEED = 5
# halo kernel against plain, relative to the field's largest magnitude: one
# stage, differing by FMA contraction and summation order only
HALO_F64_TOL = 1e-12
HALO_F32_TOL = 1e-5


def halo_stage_fields(side, shifts, dtype, device, seed=HALO_SEED):
    """Inputs of one quadratic PFDR stage on a whole side x side field:
    ``(x, grad, ga, th_l1)`` [H, W] and the seven [F, H, W] edge fields
    (zu, zv, wu, wv, w_d1u, w_d1v, th_d1), from a seeded generator on the
    card, in the value ranges a solve gives them."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    f = len(shifts)

    def rnd(*shape, lo=-1.0, hi=1.0):
        u = torch.rand(*shape, generator=gen, device=device,
                       dtype=torch.float64)
        return (lo + (hi - lo) * u).to(dtype)

    vert = (rnd(side, side), rnd(side, side), rnd(side, side, lo=0.05),
            rnd(side, side, lo=0.0, hi=0.1))
    w_d1u = rnd(f, side, side, lo=0.0)
    edges = (rnd(f, side, side), rnd(f, side, side),
             rnd(f, side, side, lo=0.0, hi=0.5),
             rnd(f, side, side, lo=0.0, hi=0.5), w_d1u, 1.0 - w_d1u,
             rnd(f, side, side, lo=0.0, hi=0.3))
    return vert + edges


def phase_halo_fused(device="cuda"):
    """``halo_fused`` against its plain version: one rank's iteration on a
    row block of the 2048 x 2048 field (P = 4 blocks of 512 rows), the
    neighbours' strips of both exchange rounds cut from the plain iteration
    of the whole field's blocks (``ops.halo_fused.ring_iteration_plain``),
    so no processes are needed.  float64 and float32, halo depth 1 and 2,
    the first, a middle and the last block; the four vertex proxes on the
    hd = 2 float64 case.  The new iterate, zu, zv and the two contribution
    strips sent are held against the plain block iteration, and the block's
    rows of the whole-field plain stencil iteration, relative to the
    field's largest magnitude."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import halo_fused as hf
    from cp_pfdr_graph_d1_tpu_torch.ops.stencil_fused import \
        stencil_iteration_plain
    p_n = 4
    hb = HALO_SIDE // p_n
    errs, errs_abs = {}, {}
    timing = {}
    for dtype in (torch.float64, torch.float32):
        tol = HALO_F64_TOL if dtype == torch.float64 else HALO_F32_TOL
        for hd, sw in HALO_FAMILIES.items():
            shifts = tuple(sw)
            fields = halo_stage_fields(HALO_SIDE, shifts, dtype, device)
            proxes = (vertex_proxes() if (dtype, hd) == (torch.float64, 2)
                      else vertex_proxes()[:1])
            for vp in proxes:
                kw = dict(shifts=shifts, rho=1.5, vkind=vp.kind,
                          positivity=vp.positivity, lo=float(vp.lo),
                          hi=float(vp.hi))
                ring = hf.ring_iteration_plain(*fields, num_shards=p_n, **kw)
                whole = stencil_iteration_plain(*fields, **kw)
                worst = {}
                for b in (0, 1, p_n - 1):
                    rows = slice(b * hb, (b + 1) * hb)
                    blk = [a[..., rows, :].contiguous() for a in fields]
                    ex = hf.ScriptedExchange(ring[b][1])
                    before = hf.halo_fused_iteration.launches
                    out = hf.halo_fused_iteration(*blk, hd=hd, exchange=ex,
                                                  **kw)
                    check(device == "cpu"
                          or hf.halo_fused_iteration.launches - before == 5,
                          "halo_fused: not five launches per iteration")
                    check(device == "cpu" or out[0].is_cuda,
                          "halo_fused output not on the card")
                    plain = ring[b][0]
                    # the strips this block sent in round 2, as its
                    # neighbours received them
                    ctr_plain = (ring[(b + 1) % p_n][1][1][0],
                                 ring[(b - 1) % p_n][1][1][1])
                    pairs = {"x": [(out[0], plain[0])],
                             "zu": [(out[1], plain[1])],
                             "zv": [(out[2], plain[2])],
                             "strips": [(ex.sent[1][0], ctr_plain[0]),
                                        (ex.sent[1][1], ctr_plain[1])],
                             "sums": list(zip(out[3:], plain[3:])),
                             "whole-field": [(out[0], whole[0][rows]),
                                             (out[1], whole[1][:, rows]),
                                             (out[2], whole[2][:, rows])]}
                    for key, prs in pairs.items():
                        for k, p in prs:
                            e = max_err(k, p)
                            if key != "sums":
                                errs_abs[dtype] = max(errs_abs.get(dtype, 0.0),
                                                      e)
                            e /= max(float(p.abs().max()), 1e-30)
                            worst[key] = max(worst.get(key, 0.0), e)
                name = f"{vp.kind}{'+pos' if vp.positivity else ''}"
                top = max(worst.values())
                errs[(dtype, hd)] = max(errs.get((dtype, hd), 0.0), top)
                check(top <= tol, f"halo_fused {dtype} hd={hd} {name}: "
                      f"rel errs {worst} > {tol}")
                print(f"[halo_fused] {str(dtype)[6:]} hd={hd} F={len(shifts)}"
                      f" {name:7s} blocks 0, 1, {p_n - 1} of {p_n} "
                      f"({hb}x{HALO_SIDE}), max|kernel-plain|/max|plain|: "
                      + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                      + f" (tol {tol:g}; whole-field: against the block's "
                      f"rows of the whole-field plain stencil iteration)",
                      flush=True)
            if dtype == torch.float32 and device == "cuda":
                b = 1
                rows = slice(b * hb, (b + 1) * hb)
                blk = [a[..., rows, :].contiguous() for a in fields]
                kw = dict(shifts=shifts, rho=1.5, vkind="l1",
                          positivity=True, lo=-np.inf, hi=np.inf)
                ring = hf.ring_iteration_plain(*fields, num_shards=p_n, **kw)
                replay = hf.ScriptedExchange(ring[b][1], cycle=True)

                def kern():
                    return hf.halo_fused_iteration(*blk, hd=hd,
                                                   exchange=replay, **kw)

                def plain():
                    return hf.halo_iteration_plain(*blk, hd=hd,
                                                   exchange=replay, **kw)

                t = dict(ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 50))
                t["device_us"], per, _ = device_profile(kern, 100)
                t["plain_device_us"] = device_profile(plain, 20)[0]
                t["f"] = len(shifts)
                per = {k.split("(")[0].split("::")[-1].split("<")[0]: v
                       for k, v in per.items()}
                t["kernels"] = {k: round(v, 3) for k, v in per.items()}
                timing[hd] = t
                print(f"[halo_fused] float32 hd={hd} F={len(shifts)} block "
                      f"{hb}x{HALO_SIDE} l1+pos, per iteration (exchanges "
                      f"replayed, no processes): kernels {t['ms'] * 1e3:.2f}"
                      f" us between CUDA events ({t['device_us']:.2f} us of "
                      f"device time: "
                      + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
                      + f"), plain {t['plain_ms'] * 1e3:.2f} us "
                      f"({t['plain_device_us']:.2f} us of device time)",
                      flush=True)
            del fields, ring
    return errs, errs_abs, timing


N_HALO = N_OBS            # the EEG operator's 91 rows over the whole field
LA_L1_HALO = 1e-3


def halo_problem(side, dtype, num_shards, device="cuda"):
    """The image-scale halo problem: a ``side`` x ``side`` field under the
    EEG operator (N = 91 rows, standard normal over sqrt(N), made on the
    card from a seeded generator, so every process makes the same one),
    four constant blobs, families (0, 1) and (1, 0) of weight 0.35.
    Returns ``(graph, a, y, lip, problem)``: the single-card
    ``StencilGraphD1``, A [N, V] and y on the card, the Lipschitz bound,
    and the ``HaloShardedProblem`` of ``num_shards`` row blocks (its A a
    view of ``a``)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    from cp_pfdr_graph_d1_tpu_torch.parallel import shard_stencil_problem
    v = side * side
    gen = torch.Generator(device=device).manual_seed(HALO_SEED)
    a = (torch.randn(N_HALO, v, generator=gen, device=device,
                     dtype=torch.float32) / np.sqrt(N_HALO)).to(dtype)
    x_true = torch.zeros(side, side, dtype=torch.float64, device=device)
    for k in range(4):
        i0, j0 = (side * (1 + 2 * (k // 2))) // 4, (side * (1 + 2 * (k % 2))) // 4
        x_true[i0 - side // 16:i0 + side // 16,
               j0 - side // 16:j0 + side // 16] = 0.5 + 0.4 * k
    noise = torch.randn(N_HALO, generator=gen, device=device,
                        dtype=torch.float32).double()
    y = (a.double() @ x_true.reshape(-1) + 0.01 * noise).to(dtype)
    aa = a.double() @ a.double().T
    lip = float(torch.linalg.eigvalsh(aa)[-1])
    del aa
    g = StencilGraphD1.create((side, side), HALO_FAMILIES[1], dtype=dtype,
                              device=device)
    return g, a, y, lip, shard_stencil_problem(a, y.cpu().numpy(), g,
                                               num_shards)


def halo_options(iters):
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions, VertexProx
    return VertexProx(kind="l1"), PFDROptions(rho=1.5, dif_tol=0.0,
                                              it_max=iters)


def busy_share(fn, device="cuda"):
    """Device busy share of one call of ``fn``: the device time of its
    kernels and copies (torch.profiler) over its host-clock time (None on
    the CPU)."""
    if device == "cpu":
        return None
    dev_us, _, wall_us = device_profile(fn, 1)
    return dev_us / wall_us


def sync(device):
    import torch
    if device != "cpu":
        torch.cuda.synchronize()


def halo_busy(mesh, side, iters, device="cuda"):
    """This rank's device busy share of an ``iters``-iteration
    ``pfdr_quadratic_d1_halo`` solve per dtype (None on the CPU)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.parallel import pfdr_quadratic_d1_halo
    busy = {}
    for dtype in (torch.float32, torch.float64):
        _, _, _, lip, prob = halo_problem(side, dtype, mesh.size, device)
        vp, opt = halo_options(iters)
        busy[str(dtype)[6:]] = busy_share(lambda: pfdr_quadratic_d1_halo(
            prob, mesh, opt=opt, device=device, la_l1=LA_L1_HALO, vprox=vp,
            lipsch=lip), device)
        del prob
    return busy


def halo_solves(mesh, side, iters, profile_iters=0, device="cuda"):
    """This rank's ``pfdr_quadratic_d1_halo`` solves in float32 and float64
    (``halo_problem``, ``iters`` iterations at dif_tol = 0): per dtype the
    iteration count, us per iteration, the halo kernels' launches in the
    solve, and (on rank 0) the gathered x; then, with ``profile_iters``,
    the device busy share of a ``profile_iters``-iteration solve
    (``halo_busy``; None without)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import halo_fused as hf
    from cp_pfdr_graph_d1_tpu_torch.parallel import pfdr_quadratic_d1_halo
    out = dict(backend=mesh.backend, size=mesh.size,
               staged=mesh.staged(torch.empty(1, device=device)))
    for dtype in (torch.float32, torch.float64):
        _, _, _, lip, prob = halo_problem(side, dtype, mesh.size, device)
        vp, opt = halo_options(iters)
        launches0 = hf.halo_fused_iteration.launches
        sync(device)
        t0 = time.perf_counter()
        res = pfdr_quadratic_d1_halo(prob, mesh, opt=opt, device=device,
                                     la_l1=LA_L1_HALO, vprox=vp, lipsch=lip)
        sync(device)
        secs = time.perf_counter() - t0
        out[str(dtype)[6:]] = dict(
            it=res.it, us_per_it=secs * 1e6 / max(res.it, 1), busy=None,
            launches=hf.halo_fused_iteration.launches - launches0,
            x=res.x.cpu().numpy() if mesh.rank == 0 else None)
        del prob, res
    if profile_iters:
        for dt, b in halo_busy(mesh, side, profile_iters, device).items():
            out[dt]["busy"] = b
    return out


def shared_card_ranks(mesh, side, iters, profile_iters, device, sizes,
                      with_p2):
    """The work of the ranks that share one card: the halo solves at each
    ring size of ``sizes`` (the first n ranks as a group, largest first;
    the others wait), then, with ``with_p2``, the P = 2 runs of the other
    distributed entries (``p2_paths``)."""
    from cp_pfdr_graph_d1_tpu_torch.parallel import make_mesh
    out = {}
    for n in sorted(sizes, reverse=True):
        sub = mesh if n == mesh.size else make_mesh(n)
        if sub is not None:
            out[n] = halo_solves(sub, side, iters, profile_iters, device)
    if with_p2:
        sub = mesh if P2_SHARDS == mesh.size else make_mesh(P2_SHARDS)
        if sub is not None:
            out["p2"] = p2_paths(sub, device)
    return out


def halo_references(side=HALO_SIDE, iters=HALO_ITERS, device="cuda"):
    """The single-card solves ``[pfdr-halo]`` is held against:
    ``pfdr_quadratic_d1`` on the whole field's ``StencilGraphD1`` (the
    ``stencil_fused`` kernel), ``iters`` iterations at dif_tol = 0, float32
    and float64.  Returns ``{dtype: (iterations, x)}``."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import DenseOp, pfdr_quadratic_d1
    ref = {}
    for dtype in (torch.float32, torch.float64):
        g, a, y, lip, _ = halo_problem(side, dtype, 1, device)
        vp, opt = halo_options(iters)
        la_l1 = torch.full((side * side,), LA_L1_HALO, dtype=dtype,
                           device=device)
        op = DenseOp(a)
        sync(device)
        t0 = time.perf_counter()
        res = pfdr_quadratic_d1(op, y, g, opt=opt, la_l1=la_l1, vprox=vp,
                                lipsch=lip)
        sync(device)
        secs = time.perf_counter() - t0
        x = res.x.cpu().numpy()
        check(np.all(np.isfinite(x)), "single-card halo reference not finite")
        ref[dtype] = (res.it, x)
        print(f"[pfdr-halo] single card, {side}x{side} N={N_HALO} F=2, "
              f"{str(dtype)[6:]}: {res.it} iterations of stencil_fused, "
              f"{secs * 1e6 / res.it:.1f} us/iteration, max|x| "
              f"{np.abs(x).max():.4g}", flush=True)
        del g, a, y, op, res
    return ref


def in_process_group(fn, *args, device="cuda"):
    """``fn(mesh, *args)`` in this process, in a group of size 1 (NCCL on
    the card: its sums go through NCCL; the ring is a local copy); returns
    ``(result, backend)``."""
    import torch.distributed as dist
    from cp_pfdr_graph_d1_tpu_torch.parallel import (initialize_distributed,
                                                     make_mesh)
    from cp_pfdr_graph_d1_tpu_torch.parallel.mesh import free_port
    backend = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device)
    try:
        return fn(make_mesh(), *args), backend
    finally:
        dist.destroy_process_group()


HALO_PROFILE_ITERS = 20


def phase_pfdr_halo(ref, p2_ref=None, f_ref=None, side=HALO_SIDE,
                    iters=HALO_ITERS, shards=HALO_SHARDS, device="cuda"):
    """``parallel.pfdr_quadratic_d1_halo`` against the single-card solves
    ``ref`` (``halo_references``), ``iters`` iterations at dif_tol = 0,
    float32 and float64.  P = 1 runs in this process in an NCCL group of
    size 1 (``in_process_group``); P > 1 runs as spawned ranks that share
    the card over gloo, the strips and partial sums staged through pinned
    host memory, each rank then profiling its busy share; with two cards
    or more, P = the card count (at most 4) runs once more with one NCCL
    rank per card.  Not a scaling measurement: ranks that share one card
    share its time.  With ``p2_ref`` (``p2_references``) the spawned ranks
    then run the other distributed entries at P = 2 (``report_p2``;
    ``f_ref``: the float64 EEG host cut's objective that ``cp-dist-device``
    is held to).  This
    process launches only the P = 1 solves' kernels: its busy share is
    profiled after the counted run (``halo_busy_p1``).  Returns the max
    |dx| per ring size and dtype, and the P = 2 entries' objective
    gaps."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.parallel import spawn_ranks
    with_p2 = p2_ref is not None
    runs = []
    if 1 in shards:
        out, backend = in_process_group(halo_solves, side, iters, 0, device,
                                        device=device)
        runs.append((out, f"in this process, {backend} group of size 1 "
                          f"(self ring: local copy)"))
    sizes = tuple(n for n in shards if n > 1)
    shared = []
    if sizes or with_p2:
        if device == "cuda":
            # the spawned ranks share the card: leave them what this
            # process holds cached and does not use
            torch.cuda.empty_cache()
        shared = spawn_ranks(shared_card_ranks, max(sizes + (P2_SHARDS,)),
                             side, iters, HALO_PROFILE_ITERS, device, sizes,
                             with_p2, device=device)
    for p_n in sorted(sizes):
        runs.append(([o[p_n] for o in shared if p_n in o],
                     f"{p_n} spawned ranks sharing one card"))
    if device == "cpu":
        pass
    elif torch.cuda.device_count() >= 2:
        p_n = min(torch.cuda.device_count(), 4)
        outs = spawn_ranks(halo_solves, p_n, side, iters, HALO_PROFILE_ITERS,
                           device, device=device)
        runs.append((outs, f"{p_n} spawned ranks, one card each"))
    else:
        print(f"[pfdr-halo] one rank per card over NCCL: not run, this "
              f"machine has {torch.cuda.device_count()} card (NCCL refuses "
              f"two ranks on one device)", flush=True)
    worst = {}
    for outs, how in runs:
        outs = outs if isinstance(outs, list) else [outs]
        r0 = outs[0]
        p_n = r0["size"]
        staging = ("strips and partial sums staged through pinned host "
                   "memory" if r0["staged"] else "CUDA tensors passed to "
                   "the backend")
        for dt in ("float32", "float64"):
            it_ref, x_ref = ref[getattr(torch, dt)]
            d = r0[dt]
            err = float(np.abs(d["x"] - x_ref).max())
            tol = 1e-10 if dt == "float64" else 1e-4
            worst[(p_n, dt)] = err
            check(d["it"] == it_ref, f"halo P={p_n} {dt}: {d['it']} "
                  f"iterations, single card {it_ref}")
            check(device == "cpu"
                  or all(o[dt]["launches"] == 5 * d["it"] for o in outs),
                  f"halo P={p_n} {dt}: not 5 kernel launches per iteration "
                  f"in every rank: {[o[dt]['launches'] for o in outs]}")
            check(err <= tol, f"halo P={p_n} {dt}: max|dx| {err:.3g} > "
                  f"{tol}")
            print(f"[pfdr-halo] P={p_n} {r0['backend']} ({how}; {staging}) "
                  f"{dt}: {d['it']} iterations, "
                  + ", ".join(f"rank {r}: {o[dt]['us_per_it']:.1f} us/it"
                              + ("" if o[dt]["busy"] is None else
                                 f", busy {o[dt]['busy']}")
                              for r, o in enumerate(outs))
                  + f"; max|x - x_single_card| = {err:.3e} (tol {tol:g});"
                  f" halo_fused launches per rank {d['launches']}",
                  flush=True)
    gaps = None
    if with_p2:
        gaps = report_p2([o["p2"] for o in shared if "p2" in o], *p2_ref,
                         f_ref)
    return worst, gaps


def halo_busy_p1(side=HALO_SIDE, device="cuda"):
    """The P = 1 halo solve's device busy share, profiled outside the
    counted run, in an NCCL group of size 1 in this process."""
    busy, backend = in_process_group(halo_busy, side, HALO_PROFILE_ITERS,
                                     device, device=device)
    print(f"[pfdr-halo] P=1 {backend} (in this process), device busy share "
          f"of a {HALO_PROFILE_ITERS}-iteration solve: "
          + ", ".join(f"{dt} {b}" for dt, b in busy.items()), flush=True)
    return busy


# the other ported distributed entries, once each at P = 2 on the card
P2_SHARDS = 2
# the kernels cp_quadratic_d1_dist with cut="device" launches in each rank
# on the EEG stencil: the chained loop all four, the per-iteration device
# loop all but stencil_fused (the chain's warm partition)
DIST_DEVICE_KERNELS = ("stencil_fused", "mincut_fused", "components_fused",
                       "solve_small")
P2_SIMPLEX_ITERS = 200    # [pfdr-halo-simplex]: PFDR iterations at dif_tol 0
P2_DP_ITERS = 300         # [pfdr-dp]
P2_CP_IT = 4              # [cp-dist]: cut-pursuit iterations
P2_CROP = 128             # [cp-sharded]: side of the crop of the problem
P2_SIMPLEX_CROP = 96      # [cp-sharded-simplex]: side of its crop
P2_SHARDED_IT = 3         # [cp-sharded]: cut-pursuit iterations
P2_SIMPLEX_IT = 2         # [cp-sharded-simplex]: cut-pursuit iterations


def p2_cuts():
    """What the P = 2 phases cut of the problems they take, for the
    printed lines."""
    return {
        "pfdr-halo-simplex": f"{P2_SIMPLEX_ITERS} iterations at dif_tol 0",
        "pfdr-dp": f"{P2_DP_ITERS} iterations at dif_tol 0",
        "cp-dist": f"it_max {P2_CP_IT} (bench.py: 15), float64",
        "cp-dist-device": "none (the EEG problem on its 140 x 140 stencil, "
                          "float32, chain_options: the chained loop)",
        "cp-dist-device-off": "none (as cp-dist-device, chain='off': the "
                              "per-iteration device loop)",
        "example-distributed": "none (examples/torch_example_distributed"
                               ".py's 32 x 32 problem)",
        "cp-sharded": f"a {P2_CROP} x {P2_CROP} crop of the 724 x 724 "
                      f"field (the window of the largest spread), it_max "
                      f"{P2_SHARDED_IT} (bench.py: 4)",
        "cp-sharded-simplex": f"the central {P2_SIMPLEX_CROP} x "
                              f"{P2_SIMPLEX_CROP} crop of the 512 x 512 "
                              f"field (all four labels), it_max "
                              f"{P2_SIMPLEX_IT} (bench.py: 10)"}


def denoise_crop():
    """The P2_CROP x P2_CROP window of ``denoise_problem``'s field (on a
    grid of windows) whose values spread the most: it holds rectangles."""
    y = denoise_problem().reshape(SIDE_524K, SIDE_524K)
    n = SIDE_524K // P2_CROP
    wins = [(i * P2_CROP, j * P2_CROP) for i in range(n) for j in range(n)]
    i, j = max(wins, key=lambda ij: float(
        y[ij[0]:ij[0] + P2_CROP, ij[1]:ij[1] + P2_CROP].std()))
    return y[i:i + P2_CROP, j:j + P2_CROP].ravel().copy()


def p2_inputs():
    """Host problems of the P = 2 phases (every process makes the same)."""
    q, _ = cp_simplex_problem()
    c0 = (SIDE_262K - P2_SIMPLEX_CROP) // 2
    c1 = c0 + P2_SIMPLEX_CROP
    q_crop = q.reshape(SIDE_262K, SIDE_262K, K_SIMPLEX)[
        c0:c1, c0:c1].reshape(-1, K_SIMPLEX).copy()
    y_den = denoise_crop()
    a, y = build_grid_problem()
    eu, ev = grid_edges()
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    return dict(q=q, q_crop=q_crop, y_den=y_den, a=a, y=y, eu=eu, ev=ev,
                lip=lip)


def p2_options():
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, PFDROptions,
                                            VertexProx)
    return dict(
        simplex=PFDROptions(rho=1.5, dif_tol=0.0, it_max=P2_SIMPLEX_ITERS),
        dp=PFDROptions(rho=1.5, dif_tol=0.0, it_max=P2_DP_ITERS),
        dp_vprox=VertexProx(kind="l1", positivity=True),
        cp=CPOptions(dif_tol=1e-4, it_max=P2_CP_IT,
                     pfdr=PFDROptions(rho=1.5, dif_tol=1e-7, it_max=10_000)),
        sharded=CPOptions(dif_tol=1e-4, it_max=P2_SHARDED_IT,
                          pfdr=PFDROptions(rho=1.8, dif_tol=1e-5,
                                           it_max=2000),
                          cut_tol=1e-5, cut_it_max=50_000),
        sharded_simplex=CPOptions(dif_tol=1e-3, it_max=P2_SIMPLEX_IT,
                                  pfdr=PFDROptions(rho=1.5, dif_tol=1e-6,
                                                   it_max=3000),
                                  cut_tol=1e-5, cut_it_max=50_000))


def p2_graphs(pb, device):
    import torch
    from cp_pfdr_graph_d1_tpu_torch import GraphD1, StencilGraphD1
    f32 = torch.float32
    return dict(
        simplex=StencilGraphD1.create((SIDE_262K, SIDE_262K),
                                      {(0, 1): 0.4, (1, 0): 0.4}, dtype=f32,
                                      device=device),
        dp=GraphD1.create(pb["eu"], pb["ev"], LA_D1, dtype=f32,
                          device=device),
        cp=GraphD1.create(pb["eu"], pb["ev"], LA_D1, dtype=torch.float64,
                          device=device),
        cp_device=StencilGraphD1.create((V_SIDE, V_SIDE),
                                        {(0, 1): LA_D1, (1, 0): LA_D1},
                                        dtype=f32, device=device),
        sharded=StencilGraphD1.create((P2_CROP, P2_CROP),
                                      {(0, 1): 0.35, (1, 0): 0.35},
                                      dtype=f32, device=device),
        sharded_simplex=StencilGraphD1.create(
            (P2_SIMPLEX_CROP, P2_SIMPLEX_CROP), {(0, 1): 0.4, (1, 0): 0.4},
            dtype=f32, device=device))


def p2_paths(mesh, device="cuda"):
    """This rank's runs of the five entries (rank 0 returns the results),
    then (slice 12) ``cp_quadratic_d1_dist`` with ``cut="device"`` on the
    chained and the per-iteration device loop and the distributed
    example's four paths (every rank returns these results); each
    ``(seconds, result, kernel launches in this rank)``."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import DenseOp
    from cp_pfdr_graph_d1_tpu_torch import parallel as par
    from examples import torch_example_distributed
    pb = p2_inputs()
    opts = p2_options()
    gs = p2_graphs(pb, device)
    out = dict(backend=mesh.backend,
               staged=mesh.staged(torch.empty(1, device=device)))

    def run(name, fn, every_rank=False):
        reset_counts()
        sync(device)
        t0 = time.perf_counter()
        res = fn()
        sync(device)
        counts = {k: v for k, v in read_counts().items() if v}
        keep = every_rank or mesh.rank == 0
        out[name] = (time.perf_counter() - t0, res if keep else None, counts)

    prob = par.shard_stencil_simplex_problem(pb["q"], gs["simplex"],
                                             mesh.size)
    run("pfdr-halo-simplex", lambda: par.pfdr_loss_d1_simplex_halo(
        prob, mesh, al=1.0, opt=opts["simplex"], device=device).p.cpu()
        .numpy())
    dprob = par.shard_quadratic_problem(pb["a"], pb["y"], pb["eu"], pb["ev"],
                                        LA_D1, mesh.size)
    run("pfdr-dp", lambda: par.pfdr_quadratic_d1_sharded(
        dprob, mesh, la_l1=LA_L1, vprox=opts["dp_vprox"], lipsch=pb["lip"],
        opt=opts["dp"], device=device).x.cpu().numpy())
    a64 = torch.as_tensor(pb["a"], dtype=torch.float64)

    def cp_dist():
        res = par.cp_quadratic_d1_dist(
            DenseOp(a64), torch.as_tensor(pb["y"], dtype=torch.float64),
            gs["cp"], mesh, la_l1=LA_L1, positivity=True, opt=opts["cp"],
            device=device)
        return res.cv, res.rx, res.it

    run("cp-dist", cp_dist)

    def sharded():
        res = par.cp_quadratic_d1_sharded(pb["y_den"], gs["sharded"], mesh,
                                          opt=opts["sharded"], device=device)
        return res.cv, res.rx, res.it

    run("cp-sharded", sharded)

    def sharded_simplex():
        res = par.cp_loss_d1_simplex_sharded(
            pb["q_crop"], gs["sharded_simplex"], mesh, al=1.0,
            opt=opts["sharded_simplex"], device=device)
        return res.cv, res.rp, res.it

    run("cp-sharded-simplex", sharded_simplex)

    def cp_dist_device(chain):
        res = par.cp_quadratic_d1_dist(
            DenseOp(torch.as_tensor(pb["a"])), torch.as_tensor(pb["y"]),
            gs["cp_device"], mesh, la_l1=np.full(pb["a"].shape[1], LA_L1,
                                                  np.float32),
            positivity=True, opt=dataclasses.replace(chain_options(),
                                                     chain=chain),
            device=device)
        return res.cv, res.rx, res.it

    # every rank keeps these: the ranks must hold the same partition
    run("cp-dist-device", functools.partial(cp_dist_device, "auto"),
        every_rank=True)
    run("cp-dist-device-off", functools.partial(cp_dist_device, "off"),
        every_rank=True)
    run("example-distributed", functools.partial(
        torch_example_distributed.paths, mesh, device), every_rank=True)
    return out


def tv_objective(x, y, side, la):
    x = np.asarray(x, np.float64).reshape(side, side)
    return (0.5 * np.sum((x.ravel() - y.astype(np.float64)) ** 2)
            + la * np.sum(np.abs(x[:, 1:] - x[:, :-1]))
            + la * np.sum(np.abs(x[1:] - x[:-1])))


def simplex_objective_np(p, q, side, la):
    """Quadratic-loss (al = 1) multi-label objective on a side x side
    4-neighbour grid, float64 on the host."""
    p = np.asarray(p, np.float64).reshape(side, side, -1)
    q = np.asarray(q, np.float64).reshape(side, side, -1)
    return (0.5 * np.sum((p - q) ** 2)
            + la * np.sum(np.abs(p[:, 1:] - p[:, :-1]))
            + la * np.sum(np.abs(p[1:] - p[:-1])))


def p2_references(device="cuda"):
    """The single-card counterparts of the five entries, in this process."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (DenseOp, IdentityOp,
                                            cp_loss_d1_simplex,
                                            pfdr_loss_d1_simplex,
                                            pfdr_quadratic_d1)
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1
    pb = p2_inputs()
    opts = p2_options()
    gs = p2_graphs(pb, device)
    ref = {}

    def run(name, fn):
        sync(device)
        t0 = time.perf_counter()
        res = fn()
        sync(device)
        ref[name] = (time.perf_counter() - t0, res)

    run("pfdr-halo-simplex", lambda: pfdr_loss_d1_simplex(
        gs["simplex"], torch.as_tensor(pb["q"], device=device), al=1.0,
        opt=opts["simplex"]).p.cpu().numpy())
    run("pfdr-dp", lambda: pfdr_quadratic_d1(
        DenseOp(torch.as_tensor(pb["a"], device=device)),
        torch.as_tensor(pb["y"], device=device), gs["dp"],
        la_l1=torch.full((V_SIDE * V_SIDE,), LA_L1, device=device),
        vprox=opts["dp_vprox"], lipsch=pb["lip"],
        opt=opts["dp"]).x.cpu().numpy())

    def cp():
        res = cp_quadratic_d1(
            DenseOp(torch.as_tensor(pb["a"], dtype=torch.float64,
                                    device=device)),
            torch.as_tensor(pb["y"], dtype=torch.float64, device=device),
            gs["cp"], la_l1=np.full(V_SIDE * V_SIDE, LA_L1),
            positivity=True, opt=dataclasses.replace(opts["cp"],
                                                     host_small="off"))
        return res.cv, res.rx, res.it

    run("cp-dist", cp)

    def sharded():
        res = cp_quadratic_d1(
            IdentityOp(), torch.as_tensor(pb["y_den"], device=device),
            gs["sharded"], opt=dataclasses.replace(
                opts["sharded"], cut="device", chain="off"))
        return res.cv, res.rx, res.it

    run("cp-sharded", sharded)

    def sharded_simplex():
        res = cp_loss_d1_simplex(
            gs["sharded_simplex"], torch.as_tensor(pb["q_crop"],
                                                   device=device),
            al=1.0, opt=dataclasses.replace(opts["sharded_simplex"],
                                            cut="device"))
        return res.cv, res.rp, res.it

    run("cp-sharded-simplex", sharded_simplex)

    def sharded_simplex_f64():
        res = cp_loss_d1_simplex(
            gs["sharded_simplex"], torch.as_tensor(pb["q_crop"],
                                                   device=device),
            al=1.0, opt=dataclasses.replace(opts["sharded_simplex"],
                                            cut="host", host_small="on"))
        return res.cv, res.rp, res.it

    # the sharded loop solves its reduced problems in float64 (native
    # C++); the single-card device loop above in float32, which can tip a
    # knife-edge expansion cut of the next iteration: the host loop with
    # the same float64 reduced solves is the second witness
    run("cp-sharded-simplex-f64", sharded_simplex_f64)

    def cp_device(chain):
        res = cp_quadratic_d1(
            DenseOp(torch.as_tensor(pb["a"], device=device)),
            torch.as_tensor(pb["y"], device=device), gs["cp_device"],
            la_l1=np.full(pb["a"].shape[1], LA_L1, np.float32),
            positivity=True, opt=dataclasses.replace(chain_options(),
                                                     chain=chain))
        return res.cv, res.rx, res.it

    # one card's cut="device" solves beside the ranks' (one run each)
    run("cp-dist-device", functools.partial(cp_device, "auto"))
    run("cp-dist-device-off", functools.partial(cp_device, "off"))
    return ref, pb


def report_p2(outs, ref, pb, f_ref):
    """``pfdr_loss_d1_simplex_halo``, ``pfdr_quadratic_d1_sharded``,
    ``cp_quadratic_d1_dist``, ``cp_quadratic_d1_sharded`` and
    ``cp_loss_d1_simplex_sharded``, run once each at P = 2 (``p2_paths``,
    two ranks sharing the card over gloo; ``outs`` per rank), against their
    single-card counterparts in the port on the same problems (``ref``,
    ``p2_references``): ``bench.py:425-486``'s 512 x 512 K = 4 multi-label
    problem (al = 1), the EEG problem on its COO graph
    (``bench.py:65-82``) and ``bench.py:366-386``'s 724 x 724 denoising,
    cut as ``p2_cuts`` says.  Prints the objective gap, max |difference|
    and the equality of the partitions; holds each to its tolerance.  Then
    (slice 12) ``cp-dist-device``: the EEG problem through
    ``cp_quadratic_d1_dist`` with ``cut="device"`` on the chained and the
    per-iteration device loop, the same partition and values on every rank
    and the objective within 1e-3 relative of the float64 host cut
    ``f_ref`` (``bench.py:331-347``'s rule), beside one card's solve; and
    the distributed example's four paths, held to its own bars."""
    r0 = outs[0]
    how = (f"P={P2_SHARDS} {r0['backend']}, "
           + ("strips and sums staged through pinned host memory"
              if r0["staged"] else "tensors passed to the backend"))
    cuts = p2_cuts()
    gaps = {}

    def line(name, msg):
        secs = max(o[name][0] for o in outs)
        counts = [o[name][2] for o in outs]
        single = (f" (single card {ref[name][0]:.2f} s)" if name in ref
                  else "")
        print(f"[{name}] {how}; cut: {cuts[name]}; {secs:.2f} s{single}; "
              f"{msg}; kernel launches per rank {counts}", flush=True)

    # multi-label halo PFDR against stencil_fused_simplex on one card
    p_h, p_1 = r0["pfdr-halo-simplex"][1], ref["pfdr-halo-simplex"][1]
    f_h = simplex_objective_np(p_h, pb["q"], SIDE_262K, 0.4)
    f_1 = simplex_objective_np(p_1, pb["q"], SIDE_262K, 0.4)
    err = float(np.abs(p_h - p_1).max())
    gaps["pfdr-halo-simplex"] = (f_h - f_1) / abs(f_1)
    line("pfdr-halo-simplex", f"objective {f_h:.9g} vs {f_1:.9g} (rel gap "
         f"{gaps['pfdr-halo-simplex']:.2e}), max|dp| {err:.2e}")
    check(np.all(np.isfinite(p_h)) and err <= 1e-3,
          f"pfdr-halo-simplex: max|dp| {err}")

    # edge-sharded PFDR against the COO staged loop on one card
    x_d, x_1 = r0["pfdr-dp"][1], ref["pfdr-dp"][1]
    eu, ev = pb["eu"], pb["ev"]
    f_d = objective(x_d, pb["a"], pb["y"], eu, ev, np.full(len(eu), LA_D1))
    f_1 = objective(x_1, pb["a"], pb["y"], eu, ev, np.full(len(eu), LA_D1))
    err = float(np.abs(x_d - x_1).max())
    gaps["pfdr-dp"] = (f_d - f_1) / abs(f_1)
    line("pfdr-dp", f"objective {f_d:.9g} vs {f_1:.9g} (rel gap "
         f"{gaps['pfdr-dp']:.2e}), max|dx| {err:.2e}")
    check(np.all(np.isfinite(x_d)) and err <= 1e-3, f"pfdr-dp: max|dx| {err}")

    # distributed cut-pursuit (float64) against the single-card host cut
    (cv_d, rx_d, it_d), (cv_1, rx_1, it_1) = (r0["cp-dist"][1],
                                              ref["cp-dist"][1])
    same = bool(np.array_equal(cv_d, cv_1))
    f_d = objective(rx_d[cv_d], pb["a"], pb["y"], eu, ev,
                    np.full(len(eu), LA_D1))
    f_1 = objective(rx_1[cv_1], pb["a"], pb["y"], eu, ev,
                    np.full(len(eu), LA_D1))
    gaps["cp-dist"] = (f_d - f_1) / abs(f_1)
    rx_err = (float(np.abs(rx_d - rx_1).max() / np.abs(rx_1).max())
              if same else float("nan"))
    line("cp-dist", f"{it_d} vs {it_1} iterations, {len(rx_d)} vs "
         f"{len(rx_1)} components, cv equal: {same}, max|drx|/max|rx| "
         f"{rx_err:.2e}, objective rel gap {gaps['cp-dist']:.2e}")
    check(same and rx_err <= 1e-9, "cp-dist: the float64 partition or "
          "values differ from the single-card run")

    # sharded-graph cut-pursuit against the single-card device loop
    (cv_s, rx_s, it_s), (cv_1, rx_1, it_1) = (r0["cp-sharded"][1],
                                              ref["cp-sharded"][1])
    f_s = tv_objective(rx_s[cv_s], pb["y_den"], P2_CROP, 0.35)
    f_1 = tv_objective(rx_1[cv_1], pb["y_den"], P2_CROP, 0.35)
    gaps["cp-sharded"] = (f_s - f_1) / abs(f_1)
    line("cp-sharded", f"{it_s} vs {it_1} iterations, {len(rx_s)} vs "
         f"{len(rx_1)} components, cv equal: "
         f"{bool(np.array_equal(cv_s, cv_1))}, objective {f_s:.9g} vs "
         f"{f_1:.9g} (rel gap {gaps['cp-sharded']:.2e})")
    check(np.all(np.isfinite(rx_s)) and gaps["cp-sharded"] <= 1e-3,
          f"cp-sharded: objective {f_s} vs {f_1}")

    # sharded multi-label cut-pursuit against the single-card device loop
    # (float32 reduced solves) and the host loop with the sharded loop's
    # float64 native reduced solves; the iteration counts must equal the
    # latter's
    cv_s, rp_s, it_s = r0["cp-sharded-simplex"][1]
    f_s = simplex_objective_np(rp_s[cv_s], pb["q_crop"], P2_SIMPLEX_CROP,
                               0.4)
    check(np.all(np.isfinite(rp_s)), "cp-sharded-simplex: not finite")
    msgs = []
    for key, what in (("cp-sharded-simplex", "device loop, float32 reduced "
                       "solves"), ("cp-sharded-simplex-f64", "host loop, "
                                   "float64 native reduced solves")):
        cv_1, rp_1, it_1 = ref[key][1]
        f_1 = simplex_objective_np(rp_1[cv_1], pb["q_crop"], P2_SIMPLEX_CROP,
                                   0.4)
        agree = float(np.mean(rp_s[cv_s].argmax(1) == rp_1[cv_1].argmax(1)))
        gap = (f_s - f_1) / abs(f_1)
        gaps[key] = gap
        msgs.append(f"against the single-card {what} ({ref[key][0]:.2f} s): "
                    f"{it_s} vs {it_1} iterations, {len(rp_s)} vs "
                    f"{len(rp_1)} components, labels agree on {agree:.4f} "
                    f"of the vertices, objective {f_s:.9g} vs {f_1:.9g} "
                    f"(rel gap {gap:.2e})")
        check(gap <= 1e-3 and agree >= 0.98, f"{key}: objective {f_s} vs "
              f"{f_1}, labels agree on {agree}")
        if key.endswith("f64"):
            check(it_s == it_1, f"cp-sharded-simplex: {it_s} iterations, "
                  f"the float64 witness {it_1}")
    line("cp-sharded-simplex", "; ".join(msgs))
    if r0["staged"] or r0["backend"] == "nccl":  # ranks on the card
        check(all(sum(o["cp-dist"][2].get(k, 0)
                      for k in ("solve_small", "solve_fused")) > 0
                  for o in outs), "cp-dist: a rank solved its reduced "
              "problems without the solve_small / solve_fused kernels")

    # cut="device" with the operator sharded over the ranks (slice 12)
    la = np.full(len(eu), LA_D1)
    for name, needs in (("cp-dist-device", DIST_DEVICE_KERNELS),
                        ("cp-dist-device-off", DIST_DEVICE_KERNELS[1:])):
        cv_d, rx_d, it_d = r0[name][1]
        same = all(np.array_equal(o[name][1][0], cv_d)
                   and np.array_equal(o[name][1][1], rx_d) for o in outs)
        f_d = objective(rx_d[cv_d], pb["a"], pb["y"], eu, ev, la)
        gaps[name] = (f_d - f_ref) / abs(f_ref)
        cv_1, rx_1, it_1 = ref[name][1]
        line(name, f"{CARD}: {it_d} CP iterations, {len(rx_d)} components, "
             f"cv and rx equal on every rank: {same}; objective {f_d:.9g} "
             f"against the float64 host cut's {f_ref:.9g} (rel "
             f"{gaps[name]:.2e}, tol 1e-3); one card's cp_quadratic_d1 "
             f"{it_1} CP iterations, {len(rx_1)} components, objective "
             f"{objective(rx_1[cv_1], pb['a'], pb['y'], eu, ev, la):.9g}")
        check(np.all(np.isfinite(rx_d)) and cv_d.shape == (V_SIDE * V_SIDE,),
              f"{name}: result not finite or misshapen")
        check(same, f"{name}: the ranks' partitions or values differ")
        check(abs(gaps[name]) <= 1e-3, f"{name}: objective {f_d} vs the "
              f"float64 host cut's {f_ref}")
        if r0["staged"] or r0["backend"] == "nccl":  # ranks on the card
            check(all(o[name][2].get(k, 0) > 0 for o in outs for k in needs),
                  f"{name}: a rank ran without one of {needs}: "
                  f"{[o[name][2] for o in outs]}")

    # the distributed example's four paths in the same ranks
    from examples import torch_example_distributed
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            torch_example_distributed.report(
                [o["example-distributed"][1] for o in outs])
    finally:
        for ln in buf.getvalue().splitlines():
            print(f"[example-distributed] {ln}", flush=True)
    line("example-distributed", f"{CARD}: the example's assertions hold")
    return gaps


# ---------------------------------------------------------------------------
# slice 11: the plain device cut on every container, the routes of inputs
# the kernels do not take, the duplex device cut, checkpoints
# ---------------------------------------------------------------------------

# 17 shift families, one more than the stencil kernels take: the
# neighbourhood of radius 3 (the cells (dy, dx) with dy > 0, or dy = 0 and
# dx > 0, up to 17 of them)
SHIFTS_17 = ((0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0), (2, 1),
             (1, 2), (2, -1), (1, -2), (2, 2), (2, -2), (0, 3), (3, 0),
             (3, 1), (1, 3), (3, -1))
# the denoising cut-pursuit's TV weight per vertex (4 edges of 0.35)
# spread over the 34 edges of the 17 families
ROUTE_TV = 0.35 * 2 / 17
K_ROUTE = 33          # one more label than the multi-label kernels take
ROUTE_ITERS = 1000    # PFDR iterations of the F = 17 solve
ROUTE_SIMPLEX_ITERS = 300
# the kernels the route-fallback path must not launch
ROUTE_AVOIDS = ("stencil_fused", "mincut_fused", "components_fused",
                "stencil_fused_simplex", "circulant_fused_simplex")


class CutRecorder:
    """Within a ``with`` block, records the PDHG steps and host-clock
    milliseconds of each plain device cut (``steps``, ``cut_ms``: the
    undirected and duplex loops of ``maxflow.device``) and the rounds and
    milliseconds of each plain components call (``rounds``, ``comp_ms``:
    one ``edge_to_vertex_min`` a round) that the device loop of
    ``solvers.cut_pursuit_device`` makes; each call is timed between two
    synchronisations of the card."""

    NAMES = ("_pdhg_min_cut", "_pdhg_min_cut_duplex",
             "connected_components_device")

    def __enter__(self):
        import torch
        from cp_pfdr_graph_d1_tpu_torch.solvers import \
            cut_pursuit_device as cpd
        self.steps, self.rounds, self.cut_ms, self.comp_ms = [], [], [], []
        self._cpd = cpd
        self._saved = {n: getattr(cpd, n) for n in self.NAMES}

        def timed(ms, fn, *args):
            if args[1].is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            if args[1].is_cuda:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def cut(fn):
            def recording(*args):
                out = timed(self.cut_ms, fn, *args)
                self.steps.append(int(out[2]))
                return out
            return recording

        def components(graph, mask, it_max=None):
            calls = []
            reduce_min = graph.edge_to_vertex_min

            def counting(*args):
                calls.append(1)
                return reduce_min(*args)

            graph.edge_to_vertex_min = counting
            try:
                return timed(self.comp_ms,
                             self._saved["connected_components_device"],
                             graph, mask, it_max)
            finally:
                del graph.edge_to_vertex_min
                self.rounds.append(len(calls))

        cpd._pdhg_min_cut = cut(self._saved["_pdhg_min_cut"])
        cpd._pdhg_min_cut_duplex = cut(self._saved["_pdhg_min_cut_duplex"])
        cpd.connected_components_device = components
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._cpd, name, fn)

    def summary(self):
        steps = self.steps or [0]
        rounds = self.rounds or [0]
        cut_ms, comp_ms = sum(self.cut_ms), sum(self.comp_ms)
        return (f"{len(self.steps)} plain cuts of {np.mean(steps):.0f} PDHG "
                f"steps on average (most {max(steps)}), {cut_ms:.1f} ms in "
                f"all, {cut_ms / max(len(self.steps), 1):.2f} ms a cut, "
                f"{cut_ms * 1e3 / max(sum(self.steps), 1):.1f} us a step; "
                f"{len(self.rounds)} plain components calls of "
                f"{np.mean(rounds):.1f} rounds on average (most "
                f"{max(rounds)}), {comp_ms:.1f} ms in all")


def lasso_cp(graph, a, y, dtype, device="cuda", **opt):
    """The EEG problem's cut-pursuit (``chain_options``, l1 with
    positivity) of ``(a, y)`` on ``graph``, with ``opt`` replacing options
    (``cut``, ``chain``, ``it_max``) and ``duplex`` or ``state`` passed
    through: ``(seconds, result)``."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import DenseOp
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1
    kw = {k: opt.pop(k) for k in ("duplex", "state") if k in opt}
    npd = np.float64 if dtype == torch.float64 else np.float32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cp_quadratic_d1(
        DenseOp(torch.as_tensor(a.astype(npd), device=device)),
        torch.as_tensor(y.astype(npd), device=device), graph,
        la_l1=np.full(a.shape[1], LA_L1, npd), positivity=True,
        opt=dataclasses.replace(chain_options(), **opt), **kw)
    return time.perf_counter() - t0, res


def cp_objective(res, a, y, graph):
    eu, ev, la = graph.host_coo()
    return objective(res.rx[res.cv], a, y, eu, ev, la.astype(np.float64))


def mesh_coo(dtype, device):
    """The mesh as a COO ``GraphD1``."""
    from cp_pfdr_graph_d1_tpu_torch import GraphD1
    eu, ev, _, _ = build_mesh_problem()
    return GraphD1.create(eu, ev, LA_D1, num_vertices=V_SIDE * V_SIDE,
                          dtype=dtype, device=device)


def mesh_cp_reference(device="cuda"):
    """The float64 host-cut solve of the mesh cut-pursuit on the card that
    ``cp-device-mesh`` is held against (outside the counted windows):
    ``(objective, seconds)``."""
    import torch
    _, _, a, y = build_mesh_problem()
    g = mesh_coo(torch.float64, device)
    t, res = lasso_cp(g, a, y, torch.float64, device, cut="host")
    f = cp_objective(res, a, y, g)
    print(f"[cp-device-mesh] float64 host-cut reference on the card: "
          f"{res.it} CP iterations, {len(res.rx)} components, objective "
          f"{f:.9g} ({t * 1e3:.1f} ms)", flush=True)
    return f


def phase_cp_device_mesh(f64, device="cuda"):
    """Main path: the device cut-pursuit (``cut="device"``, the chained
    loop's options; ``chain="auto"`` takes the per-iteration loop off a
    stencil) on ``bench.py``'s 19,600-point Delaunay mesh, float32, on a
    COO ``GraphD1`` (the plain cut and components on the card) and on a
    ``BandedGraphD1`` (the same loops, their float gathers and sums through
    ``banded_gather`` / ``banded_scatter``); each at most 1e-3 above the
    float64 host cut, beside the float32 host cut on the same mesh."""
    import torch
    eu, ev, a, y = build_mesh_problem()
    f32 = torch.float32
    g = mesh_coo(f32, device)
    t_host, res_host = lasso_cp(g, a, y, f32, device, cut="host")
    f_host = cp_objective(res_host, a, y, g)
    print(f"[cp-device-mesh] float32 host cut on the card, COO GraphD1: "
          f"{t_host * 1e3:.1f} ms, {res_host.it} CP iterations, "
          f"{len(res_host.rx)} components, objective {f_host:.9g}",
          flush=True)
    out = {"host_ms": t_host * 1e3}
    for kind in ("coo", "banded"):
        g = mesh_coo(f32, device) if kind == "coo" else mesh_graph(
            "banded", f32, device)
        before = read_counts()
        with CutRecorder() as rec:
            t, res = lasso_cp(g, a, y, f32, device, cut="device")
        grew = {k: v - before[k] for k, v in read_counts().items()}
        f = cp_objective(res, a, y, g)
        check(np.all(np.isfinite(res.rx)) and res.cv.shape == (a.shape[1],),
              f"cp-device-mesh {kind}: result not finite or misshapen")
        cuts = len(rec.steps)
        print(f"[cp-device-mesh] float32 {type(g).__name__}, cut='device' "
              f"chain='auto' (per-iteration loop): {t * 1e3:.1f} ms, "
              f"{res.it} CP iterations, {t * 1e3 / max(res.it, 1):.1f} ms "
              f"per CP iteration, {len(res.rx)} components; "
              f"{rec.summary()}; {sum(rec.steps)} PDHG steps in all; "
              f"objective {f:.9g} against float64 {f64:.9g} (rel "
              f"{(f - f64) / abs(f64):.2e}); launches +{grew}", flush=True)
        check(f <= f64 * (1 + 1e-3), f"cp-device-mesh {kind}: objective {f} "
              f"more than 1e-3 above the float64 host cut's {f64}")
        check(cuts > 0 and rec.rounds, f"cp-device-mesh {kind}: the plain "
              f"cut or components did not run")
        check(grew["mincut_fused"] == 0 and grew["components_fused"] == 0,
              f"cp-device-mesh {kind}: a stencil kernel ran on the mesh")
        if kind == "banded":
            check(grew["banded_gather"] > 0 and grew["banded_scatter"] > 0,
                  f"cp-device-mesh: the banded transfers were not launched: "
                  f"{grew}")
        out[kind] = dict(ms=t * 1e3, it=res.it, cuts=cuts,
                         steps=sum(rec.steps), rounds=rec.rounds,
                         launches=grew)
    return out


def route_stencil(dtype, device, weight=LA_D1):
    """The 140 x 140 stencil of 17 shift families."""
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    return StencilGraphD1.create((V_SIDE, V_SIDE),
                                 {s: weight for s in SHIFTS_17}, dtype=dtype,
                                 device=device)


def route_cp(dtype, device):
    """TV denoising (``denoise_problem`` at 140 x 140, ``IdentityOp``; the
    ``cp-device`` path's options) on the 17-family stencil of weight
    ``ROUTE_TV``, through ``cut="device"`` with ``chain="auto"``:
    ``(seconds, result, objective, graph)``.  (The EEG problem on 17
    families of ``LA_D1`` oscillates between partitions for all of its 15
    CP iterations, and float32 and float64 part by 6e-3 after 6 of them.)"""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import CPOptions, IdentityOp, PFDROptions
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1
    y = denoise_problem(V_SIDE)
    g = route_stencil(dtype, device, ROUTE_TV)
    opt = CPOptions(dif_tol=1e-4, it_max=4,
                    pfdr=PFDROptions(rho=1.8, dif_tol=1e-5, it_max=2000),
                    cut="device", chain="auto", cut_tol=1e-5,
                    cut_it_max=50_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cp_quadratic_d1(IdentityOp(), torch.as_tensor(
        y, dtype=dtype, device=device), g, opt=opt)
    t = time.perf_counter() - t0
    x = res.rx[res.cv].astype(np.float64)
    eu, ev, la = g.host_coo()
    f = 0.5 * np.sum((x - y) ** 2) + np.sum(la * np.abs(x[eu] - x[ev]))
    return t, res, float(f), g


def route_pfdr(dtype, device, iters=ROUTE_ITERS, fused="auto"):
    """The EEG problem's PFDR on the 17-family stencil (l1 with
    positivity, rho = 1.5, dif_tol = 0)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (DenseOp, PFDROptions,
                                            VertexProx, pfdr_quadratic_d1)
    a, y = build_grid_problem()
    npd = np.float64 if dtype == torch.float64 else np.float32
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    return pfdr_quadratic_d1(
        DenseOp(torch.as_tensor(a.astype(npd), device=device)),
        torch.as_tensor(y.astype(npd), device=device),
        route_stencil(dtype, device),
        la_l1=torch.full((a.shape[1],), LA_L1, dtype=dtype, device=device),
        vprox=VertexProx(kind="l1", positivity=True), lipsch=lip,
        opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=iters, fused=fused))


def route_simplex(kind, dtype, device, iters=ROUTE_SIMPLEX_ITERS,
                  fused="auto"):
    """K = 33 multi-label PFDR (al = 1, rho = 1.5, dif_tol = 0) on the
    140 x 140 F = 2 stencil or on the mesh's ``CirculantGraphD1`` (edge
    weights ``LA_SIMPLEX``), observations Dirichlet(0.5) from seed 11."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (PFDROptions, StencilGraphD1,
                                            pfdr_loss_d1_simplex)
    if kind == "stencil":
        g = StencilGraphD1.create(
            (V_SIDE, V_SIDE), {(0, 1): LA_SIMPLEX, (1, 0): LA_SIMPLEX},
            dtype=dtype, device=device)
    else:
        g = mesh_graph("circulant", dtype, device, la=LA_SIMPLEX)
    q = np.random.default_rng(11).dirichlet(np.full(K_ROUTE, 0.5),
                                            size=V_SIDE * V_SIDE)
    return pfdr_loss_d1_simplex(
        g, torch.as_tensor(q, dtype=dtype, device=device), al=1.0,
        opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=iters, fused=fused))


def route_references(device="cuda"):
    """The float64 solves on the card that ``route-fallback`` is held
    against (outside the counted windows), each through the float32
    solve's own route: the F = 17 PFDR iterate and the K = 33 label fields
    of the staged loops, and the objective of the F = 17 cut-pursuit's
    per-iteration device loop (which stops at ``it_max`` before it
    converges, so a host-cut solve is no reference: another cut order
    stops elsewhere)."""
    import torch
    f64 = torch.float64
    t0 = time.perf_counter()
    x64 = route_pfdr(f64, device).x.cpu()
    p64 = {kind: route_simplex(kind, f64, device).p.cpu()
           for kind in ("stencil", "mesh")}
    _, res, f_cp, _ = route_cp(f64, device)
    print(f"[route-fallback] float64 references on the card "
          f"({time.perf_counter() - t0:.1f} s): the F=17 cut-pursuit's device "
          f"loop {res.it} CP iterations, {len(res.rx)} components, objective "
          f"{f_cp:.9g}", flush=True)
    return x64, p64, f_cp


def phase_route_fallback(refs, device="cuda"):
    """Main path: inputs the kernels do not take, on the default options,
    float32 on the card: PFDR (the EEG problem) and ``cut="device"``
    cut-pursuit (``chain="auto"``, :func:`route_cp`) on a 140 x 140 stencil
    of 17 shift families, K = 33
    multi-label PFDR on the 140 x 140 stencil and on the mesh's
    ``CirculantGraphD1``.  Each takes the staged loop or the plain cut and
    components, launches none of ``ROUTE_AVOIDS``, and is held against
    float64 on the card (PFDR max |x - x64| <= 1e-3; cut-pursuit objective
    within 1e-3 relative); ``fused="on"`` raises ``ValueError`` on each of
    the three PFDR inputs."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import IdentityOp
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_chain import \
        chain_admissible
    x64, p64, f_cp64 = refs
    f32 = torch.float32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = route_pfdr(f32, device)
    x = res.x.cpu()
    t = time.perf_counter() - t0
    err = max_err(x, x64)
    print(f"[route-fallback] float32 PFDR, {V_SIDE}x{V_SIDE} stencil F=17, "
          f"fused='auto' (staged loop): {res.it} iterations, "
          f"{t * 1e6 / res.it:.2f} us/iteration; max|x - x float64| "
          f"{err:.3e} (tol 1e-3)", flush=True)
    check(res.it == ROUTE_ITERS and bool(torch.isfinite(x).all()),
          "route-fallback: F=17 PFDR short or not finite")
    check(err <= 1e-3, f"route-fallback: F=17 PFDR float32 vs float64 "
          f"{err:.3g}")

    with CutRecorder() as rec:
        t, res, f, g = route_cp(f32, device)
    check(not chain_admissible(IdentityOp(), g, chain_options(), False,
                               False, torch.zeros(1, device=device)),
          "route-fallback: chain='auto' admits the F=17 stencil")
    print(f"[route-fallback] float32 TV denoising cut-pursuit, F=17 stencil,"
          f" cut='device' chain='auto' (per-iteration loop, plain cut and "
          f"components): "
          f"{t * 1e3:.1f} ms, {res.it} CP iterations, {len(res.rx)} "
          f"components; {rec.summary()}; objective {f:.9g} against "
          f"float64's {f_cp64:.9g} (rel "
          f"{(f - f_cp64) / abs(f_cp64):.2e}, tol 1e-3)", flush=True)
    check(rec.steps and rec.rounds, "route-fallback: the F=17 cut-pursuit "
          "did not run the plain cut and components")
    check(abs(f - f_cp64) <= 1e-3 * abs(f_cp64), f"route-fallback: F=17 "
          f"cut-pursuit objective {f} vs float64 {f_cp64}")

    for kind in ("stencil", "mesh"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = route_simplex(kind, f32, device)
        p = res.p.cpu()
        t = time.perf_counter() - t0
        err = max_err(p, p64[kind])
        where = (f"{V_SIDE}x{V_SIDE} stencil" if kind == "stencil"
                 else "mesh's CirculantGraphD1")
        print(f"[route-fallback] float32 K={K_ROUTE} multi-label PFDR on the "
              f"{where}, fused='auto' (staged loop): {res.it} iterations, "
              f"{t * 1e6 / res.it:.2f} us/iteration; max|p - p float64| "
              f"{err:.3e} (tol 1e-3)", flush=True)
        check(res.it == ROUTE_SIMPLEX_ITERS and bool(torch.isfinite(p).all())
              and p.shape == (V_SIDE * V_SIDE, K_ROUTE),
              f"route-fallback: K={K_ROUTE} {kind} result short, not finite "
              f"or misshapen")
        check(err <= 1e-3, f"route-fallback: K={K_ROUTE} {kind} float32 vs "
              f"float64 {err:.3g}")

    for what, solve in (
            ("F=17 PFDR", lambda: route_pfdr(f32, device, 2, fused="on")),
            (f"K={K_ROUTE} stencil", lambda: route_simplex(
                "stencil", f32, device, 2, fused="on")),
            (f"K={K_ROUTE} mesh", lambda: route_simplex(
                "mesh", f32, device, 2, fused="on"))):
        try:
            solve()
        except ValueError as e:
            print(f"[route-fallback] {what} with fused='on' raises "
                  f"ValueError: {e}", flush=True)
        else:
            check(False, f"route-fallback: {what} with fused='on' did not "
                  f"raise")


def phase_cp_duplex_device(device="cuda"):
    """Main path: the EEG problem through the duplex device loop
    (``cut="device", duplex=True``: the plain two-layer PDHG cut,
    ``components_fused`` for the components), float32, against the host
    duplex cut (``cut="host", duplex=True``) at 1e-3 relative; then the
    per-iteration device loop without duplex (``chain="off"``) timed once
    on the same problem, beside the chained loop of ``cp-chain``."""
    import torch
    g, a, y = eeg_host_cut(device)
    f32 = torch.float32
    t_h, res_h = lasso_cp(g, a, y, f32, device, cut="host", duplex=True)
    f_h = cp_objective(res_h, a, y, g)
    before = read_counts()
    with CutRecorder() as rec:
        t_d, res_d = lasso_cp(g, a, y, f32, device, cut="device",
                              duplex=True)
    grew = {k: v - before[k] for k, v in read_counts().items()}
    f_d = cp_objective(res_d, a, y, g)
    print(f"[cp-duplex-device] float32 {V_SIDE}x{V_SIDE} EEG, cut='device' "
          f"duplex=True: {t_d * 1e3:.1f} ms, {res_d.it} CP iterations, "
          f"{len(res_d.rx)} components; {rec.summary()}; objective "
          f"{f_d:.9g} against the host duplex cut's {f_h:.9g} ({t_h * 1e3:.1f}"
          f" ms, {res_h.it} CP iterations; rel {(f_d - f_h) / abs(f_h):.2e}, "
          f"tol 1e-3); launches +{grew}", flush=True)
    check(np.all(np.isfinite(res_d.rx)) and res_d.cv.shape == (a.shape[1],),
          "cp-duplex-device: result not finite or misshapen")
    check(grew["components_fused"] > 0 and grew["mincut_fused"] == 0,
          f"cp-duplex-device: components_fused not launched, or a "
          f"mincut_fused launch in the duplex loop: {grew}")
    check(rec.steps and not rec.rounds, "cp-duplex-device: the plain duplex "
          "cut did not run, or the components left the kernel")
    check(abs(f_d - f_h) <= 1e-3 * abs(f_h), f"cp-duplex-device: objective "
          f"{f_d} vs the host duplex cut's {f_h}")
    t_off, res_off = lasso_cp(g, a, y, f32, device, cut="device",
                              chain="off")
    f_off = cp_objective(res_off, a, y, g)
    print(f"[cp-duplex-device] the same problem without duplex through the "
          f"per-iteration device loop (cut='device' chain='off'): "
          f"{t_off * 1e3:.1f} ms, {res_off.it} CP iterations, objective "
          f"{f_off:.9g}", flush=True)
    return dict(ms=t_d * 1e3, host_ms=t_h * 1e3, off_ms=t_off * 1e3,
                steps=rec.steps)


def phase_checkpoint(device="cuda"):
    """Main path: checkpoints on the card.  A float64 PFDR on the EEG
    stencil (``stencil_fused``) stopped at iteration 500, saved with
    ``utils.save_state``, loaded onto the card with ``utils.load_state``
    and resumed to 1000 equals the uninterrupted 1000 bit for bit.  The EEG
    host-cut cut-pursuit's ``CPState`` after 3 CP iterations, saved and
    loaded, resumes exactly as from the state in memory, and that resume
    over the remaining CP iterations reaches the uninterrupted solve's
    objective within 1e-4 relative (the state holds no reduced-solve
    history, so the trajectories differ by rounding, as in the JAX
    package).  ``utils.profile`` around one PFDR
    call leaves a trace file."""
    import tempfile
    import torch
    from cp_pfdr_graph_d1_tpu_torch import (DenseOp, PFDROptions,
                                            StencilGraphD1, VertexProx,
                                            pfdr_quadratic_d1)
    from cp_pfdr_graph_d1_tpu_torch.utils import (load_state, profile,
                                                  save_state)
    a, y = build_grid_problem()
    f64 = torch.float64
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=f64, device=device)
    lip = float(np.linalg.eigvalsh((a @ a.T).astype(np.float64))[-1])
    op = DenseOp(torch.as_tensor(a.astype(np.float64), device=device))
    obs = torch.as_tensor(y.astype(np.float64), device=device)
    la_l1 = torch.full((g.num_vertices,), LA_L1, dtype=f64, device=device)

    def solve(it_max, **kw):
        return pfdr_quadratic_d1(
            op, obs, g, la_l1=la_l1,
            vprox=VertexProx(kind="l1", positivity=True), lipsch=lip,
            opt=PFDROptions(rho=1.5, dif_tol=0.0, it_max=it_max), **kw)

    with tempfile.TemporaryDirectory() as tmp:
        full = solve(1000)
        _, mid = solve(500, return_state=True)
        path = os.path.join(tmp, "pfdr.npz")
        save_state(path, mid)
        loaded = load_state(path, device=device)
        check(loaded.it == 500 and loaded.x.is_cuda and loaded.pre.ga.is_cuda,
              "checkpoint: the loaded PFDR state is not on the card")
        rest = solve(1000, state0=loaded)
        same = rest.it == full.it == 1000 and torch.equal(rest.x, full.x)
        print(f"[checkpoint] float64 PFDR on the EEG stencil: 500 + 500 "
              f"iterations through an .npz ({os.path.getsize(path)} bytes) "
              f"{'equal' if same else 'differ from'} the uninterrupted 1000 "
              f"bit for bit (max|diff| {max_err(rest.x, full.x):.3e})",
              flush=True)
        check(same, "checkpoint: the resumed PFDR differs from the "
              "uninterrupted solve")

        ge, _, _ = eeg_host_cut(device)
        f32 = torch.float32
        _, uninterrupted = lasso_cp(ge, a, y, f32, device, cut="host")
        _, first = lasso_cp(ge, a, y, f32, device, cut="host", it_max=3)
        cp_path = os.path.join(tmp, "cp.npz")
        save_state(cp_path, first.state)
        state = load_state(cp_path)
        # the rest of the uninterrupted solve's CP iterations
        more = dict(cut="host", it_max=uninterrupted.it - first.it)
        _, from_file = lasso_cp(ge, a, y, f32, device, state=state, **more)
        _, from_memory = lasso_cp(ge, a, y, f32, device, state=first.state,
                                  **more)
        f_full = cp_objective(uninterrupted, a, y, ge)
        f_res = cp_objective(from_file, a, y, ge)
        exact = (np.array_equal(from_file.cv, from_memory.cv)
                 and np.array_equal(from_file.rx, from_memory.rx))
        print(f"[checkpoint] EEG host-cut cut-pursuit: 3 CP iterations, "
              f"CPState through an .npz, then {from_file.it} more: "
              f"{'equal to' if exact else 'differs from'} the resume from "
              f"memory; objective {f_res:.9g} against the uninterrupted "
              f"{f_full:.9g} ({uninterrupted.it} CP iterations; rel "
              f"{(f_res - f_full) / abs(f_full):.2e}, tol 1e-4)", flush=True)
        check(exact and all(np.array_equal(getattr(state, k),
                                           getattr(first.state, k))
                            for k in ("active", "cv", "rx")),
              "checkpoint: the CPState from the file resumes otherwise than "
              "the state in memory")
        check(abs(f_res - f_full) <= 1e-4 * abs(f_full), f"checkpoint: the "
              f"resumed cut-pursuit's objective {f_res} vs {f_full}")

        trace_dir = os.path.join(tmp, "trace")
        with profile(trace_dir):
            solve(100)
        files = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
        print(f"[checkpoint] utils.profile around a 100-iteration PFDR "
              f"wrote {files} ({sum(os.path.getsize(os.path.join(trace_dir, n)) for n in files)} bytes)",
              flush=True)
        check(len(files) > 0, "checkpoint: profile() left no trace file")


# the quality bars of tests/test_examples.py, by example
EXAMPLE_BARS = {
    "EEG": ("raw and cleaned Dice", "dsa >= 0.6, ds >= 0.4",
            lambda ds, dsa: dsa >= 0.6 and ds >= 0.4),
    "labeling": ("accuracy of the observations and of the labeling",
                 "acc_out >= acc_in + 0.2, acc_out >= 0.85",
                 lambda acc_in, acc_out: (acc_out >= acc_in + 0.2
                                          and acc_out >= 0.85))}


def phase_examples(device="cuda"):
    """Main path (slice 12): the port's EEG and labeling examples
    (``examples/torch_example_EEG_CP.py``, ``torch_example_labeling_CP.py``,
    their ``main``) on the card, each held to the bars of
    ``tests/test_examples.py``; prints the scores, the wall time (problem
    made on the host included) and the kernel launches of each."""
    from examples import torch_example_EEG_CP, torch_example_labeling_CP
    out = {}
    for name, mod in (("EEG", torch_example_EEG_CP),
                      ("labeling", torch_example_labeling_CP)):
        what, bars, holds = EXAMPLE_BARS[name]
        before = read_counts()
        buf = io.StringIO()
        sync(device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            scores = mod.main(device)
        sync(device)
        secs = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in read_counts().items()
                if v != before[k]}
        printed = "; ".join(buf.getvalue().splitlines())
        print(f"[examples] {name} ({CARD}): {secs:.2f} s; {what} "
              f"{scores[0]:.4f}, {scores[1]:.4f} (bars {bars}); the "
              f"example printed: {printed}; launches {grew}", flush=True)
        check(holds(*scores), f"examples: the {name} example misses its "
              f"bars ({bars}): {scores}")
        out[name] = dict(seconds=secs, scores=scores, launches=grew)
    return out


def bound(nbytes, flops):
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory
    rate and the float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reduced_solve_work(rv_cap, ne, n_rows, iters, itemsize=4):
    """Bytes (inputs read once, outputs written once) and operations of a
    whole reduced PFDR solve: per iteration the dense gradient's 4 N rv_cap
    (or one product per vertex), about 24 per edge (pair prox, relaxation,
    weighting, the incidence sum) and 10 per vertex (forward step, prox,
    evolution)."""
    op_vals = n_rows * rv_cap if n_rows else rv_cap
    nbytes = (itemsize * (op_vals + 4 * rv_cap + 7 * ne + rv_cap + 2 * ne)
              + 4 * (2 * ne + rv_cap + 1 + 2 * ne))
    per_it = (4 * n_rows * rv_cap if n_rows else rv_cap) + 24 * ne \
        + 10 * rv_cap
    return nbytes, per_it * iters


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_main = time.monotonic()
    phase_env()
    import torch
    phase_build()
    st_err, st_rel, st_t = phase_stencil()
    ss_err, ss_t = phase_solve_small()
    mc_err, mc_t = phase_mincut()
    cc_t = phase_components()
    sf_err, sfm = phase_solve_fused()
    sf_err[torch.float64] = max(sf_err[torch.float64],
                                phase_solve_fused_large())
    xover = crossover()
    sx_err, sx_t = phase_stencil_simplex()
    cps_cut, cps_comp = phase_cp_simplex_kernels()
    bt = phase_banded_transfers()
    bf_err, bf_t = phase_banded_fused()
    cf_err, cf_t = phase_circulant_fused()
    cs_err, cs_t = phase_circulant_simplex()
    t_halo = time.monotonic()
    hf_err, hf_abs, hf_t = phase_halo_fused()
    print(f"[halo_fused] phase {time.monotonic() - t_halo:.1f} s",
          flush=True)
    # the float64 solves the multi-label and mesh paths are held against,
    # outside the paths' counted windows
    p64 = simplex_reference()
    cp_ref = cp_simplex_reference()
    x_mesh64 = mesh_reference()
    p_mesh64 = mesh_simplex_solve(torch.float64, "cuda", 3000).p.cpu()
    # and the single-card solves the distributed paths are held against
    halo_ref = halo_references()
    p2_ref = p2_references()
    # and the float64 solves of slice 11's paths
    mesh_cp64 = mesh_cp_reference()
    route_ref = route_references()

    # the main paths: each with the counts set to 0 just before it and read
    # just after; each must have launched the kernels it runs
    launches = dict.fromkeys(counters(), 0)
    paths = (("pfdr", phase_pfdr, (), ("stencil_fused",)),
             ("cp-host", phase_cp, (), ("solve_small",)),
             ("cp-chain", phase_cp_chain, lambda f: (f,),
              ("mincut_fused", "components_fused", "stencil_fused",
               "solve_small")),
             ("cp-device", phase_cp_device, (),
              ("mincut_fused", "components_fused")),
             ("pfdr-simplex", phase_pfdr_simplex, (p64,),
              ("stencil_fused_simplex",)),
             ("cp-simplex", phase_cp_simplex, (cp_ref,),
              ("mincut_fused", "components_fused")),
             ("pfdr-mesh", phase_pfdr_mesh, (x_mesh64,),
              ("circulant_fused",)),
             ("pfdr-mesh-banded", phase_pfdr_mesh_banded, (x_mesh64,),
              ("banded_fused", "banded_gather", "banded_scatter",
               "solve_fused")),
             ("pfdr-mesh-simplex", phase_pfdr_mesh_simplex, (p_mesh64,),
              ("circulant_fused_simplex",)),
             ("pfdr-halo", phase_pfdr_halo, lambda f: (halo_ref, p2_ref, f),
              ("halo_fused",)),
             ("cp-device-mesh", phase_cp_device_mesh, (mesh_cp64,),
              ("banded_gather", "banded_scatter")),
             # launches none of the kernels its inputs are beyond
             ("route-fallback", phase_route_fallback, (route_ref,), (),
              ROUTE_AVOIDS),
             ("cp-duplex-device", phase_cp_duplex_device, (),
              ("components_fused",)),
             ("checkpoint", phase_checkpoint, (), ("stencil_fused",)),
             ("examples", phase_examples, (), ("solve_small",)))
    f_ref = None
    for name, fn, args, needs, *avoids in paths:
        reset_counts()
        t_path = time.monotonic()
        # a callable gives the arguments from cp-host's float64 objective
        out = fn(*(args(f_ref) if callable(args) else args))
        if name == "cp-host":
            f_ref = out[1]
        counts = read_counts()
        print(f"[{name}] kernel launches: {counts} "
              f"({time.monotonic() - t_path:.1f} s)", flush=True)
        check(all(counts[k] > 0 for k in needs),
              f"{name}: a kernel of the path was not launched: {counts}")
        check(not any(counts[k] for a in avoids for k in a),
              f"{name}: launched a kernel its inputs are beyond: {counts}")
        for k, v in counts.items():
            launches[k] += v
    check(all(v > 0 for v in launches.values()),
          f"a kernel was launched on no main path: {launches}")
    cp_rec = eeg_reduced_solves()
    phase_cp_reduced_options(f_ref)
    phase_profile()
    profile_mesh()
    halo_busy_p1()

    v_eeg, f2 = V_SIDE * V_SIDE, 2
    rv_big = max(ss_t["ms"])
    rv_cap, ne, n_rows = ss_t["dims"][rv_big]
    mc = mc_t[(SIDE_524K, torch.float32)]
    cc = cc_t[f"{SIDE_524K}x{SIDE_524K} 10%"]
    v5 = SIDE_524K * SIDE_524K
    work = {
        "stencil_fused": (4 * (5 * v_eeg + 9 * f2 * v_eeg + 2),
                          22 * f2 * v_eeg + 10 * v_eeg),
        "solve_small": reduced_solve_work(rv_cap, ne, n_rows, 300),
        "mincut_fused": (4 * (4 * v5 + 4 * f2 * v5),
                         mc["it"] * (10 * f2 * v5 + 6 * v5)
                         + mc["it"] // 250 * (15 * (2 * v5 + 3 * f2 * v5)
                                              + 4 * f2 * v5 + 3 * v5)),
        # the mask read once, the labels written once; about 4 integer
        # operations per edge end and 4 per cell in each pass
        "components_fused": (f2 * v5 + 4 * v5,
                             cc["passes"] * (4 * f2 + 4) * v5),
        "solve_fused": reduced_solve_work(sfm["mesh_args"][5].shape[0],
                                          sfm["mesh_args"][8].shape[0],
                                          sfm["mesh_args"][1].shape[0], 3000),
        # inputs p, q, ga, ga_proj, prev (K planes), la_f, 7 F K edge
        # planes; outputs p, prev, zu, zv.  Operations per (vertex, label):
        # 1 + 2F forward values (~6), 2F pair proxes (~16) and weighted
        # sums (2), K projection passes (4), the tail (6)
        "stencil_fused_simplex": (
            4 * v_eeg * (7 * K_SIMPLEX + 1 + 9 * f2 * K_SIMPLEX),
            v_eeg * K_SIMPLEX * ((1 + 2 * f2) * 6 + 2 * f2 * 18
                                 + 4 * K_SIMPLEX + 6)),
    }
    # slice 4, float32 on the mesh.  Index bytes of a banded edge list of
    # e edges: eu, ev, the incidence offsets and slots (int32).
    def index_bytes(e):
        return 4 * (2 * e + v_eeg + 1 + 2 * e)

    eb = bt["mesh"]["e"]
    slots = cf_t["f"] * cf_t["vv"] + cf_t["rem"]
    s_slots = cs_t["f"] * cs_t["vv"] + cs_t["rem"]
    k = K_SIMPLEX
    work.update({
        # gather: x, eu, ev read, two [E] outputs; scatter: two [E] inputs,
        # offsets and slots read, [V] written, one add per slot
        "banded_gather": (4 * (v_eeg + 2 * eb + 2 * eb), 0),
        "banded_scatter": (4 * (2 * eb + v_eeg + 1 + 2 * eb + v_eeg),
                           2 * eb),
        # 4 vertex inputs and x written, 7 edge inputs and zu, zv written
        "banded_fused": (4 * (5 * v_eeg + 9 * eb) + index_bytes(eb),
                         OPS_PER_SLOT * eb + 10 * v_eeg),
        # over the family slots and the remainder, plus the offsets: 5 edge
        # streams read (zu, zv, wu, w_d1u, th_d1; wv and w_d1v follow from
        # wu, w_d1u and Gamma, as the TPU kernel derives them) and 2 written
        "circulant_fused": (4 * (5 * v_eeg + 7 * slots + cf_t["f"])
                            + index_bytes(cf_t["rem"]),
                            OPS_PER_SLOT * slots + 10 * v_eeg),
        # p, q, ga, ga_proj, prev read and p, prev written (K planes each),
        # la_f; 5 K edge planes read (as above), 2 K written.  Per (vertex,
        # label): the forward value (6), K projection passes (4 K), the
        # tail (6)
        "circulant_fused_simplex": (
            4 * ((7 * k + 1) * v_eeg + 7 * k * s_slots + cs_t["f"])
            + index_bytes(cs_t["rem"]),
            k * (OPS_PER_SLOT * s_slots + (12 + 4 * k) * v_eeg)),
    })
    rows = [
        dict(name="stencil_fused", source="stencil_fused.cu",
             replaces="stencil_fused.py:105", max_abs_err=st_err[
                 torch.float32], max_abs_err_f64=st_err[torch.float64],
             sums_max_rel_err=st_rel[torch.float32],
             sums_max_rel_err_f64=st_rel[torch.float64], ms=st_t["ms"],
             plain_ms=st_t["plain_ms"], device_us=st_t["device_us"],
             plain_device_us=st_t["plain_device_us"],
             host_us_per_call=st_t["host_us"],
             shape=f"{V_SIDE}x{V_SIDE} F=2, one PFDR stage (one launch: "
                   f"a thread a vertex, the sums ended by the last block)"),
        dict(name="solve_small", source="solve_small.cu",
             replaces="solve_small.py:185", max_abs_err=ss_err[
                 torch.float32], max_abs_err_f64=ss_err[torch.float64],
             ms=ss_t["ms"][rv_big], plain_ms=ss_t["plain_ms"][rv_big],
             cluster=ss_t["cluster"][rv_big],
             partitions={str(rv): dict(ms=ss_t["ms"][rv],
                                       plain_ms=ss_t["plain_ms"][rv],
                                       cluster=ss_t["cluster"][rv])
                         for rv in ss_t["ms"]},
             eeg_host_cut=[{k: r[k] for k in ("kind", "rv", "rv_cap", "route",
                                              "cluster", "it", "call_ms")}
                           for r in cp_rec],
             crossover={f"{kind} rv_cap={rc}": {str(c): t
                                                for c, t in row.items()}
                        for (kind, rc), row in xover.items()},
             shape=f"dense, rv={rv_big} rv_cap={rv_cap}, 300 iterations"),
        dict(name="mincut_fused", source="mincut_fused.cu",
             replaces="mincut_fused.py:121",
             max_abs_err=mc_err[(SIDE_524K, torch.float32)],
             max_abs_err_f64=max(v for (_, d), v in mc_err.items()
                                 if d == torch.float64),
             ms=mc["ms"], plain_ms=mc["plain_ms"],
             schedule=mc["schedule"],
             stream_bound_ms_per_step=mc["stream_bound_us_per_step"] * 1e-3,
             per_step_us={f"{side}x{side} {str(d)[6:]}": {
                 k: v for k, v in t.items()
                 if k in ("schedule", "us_per_step", "stream_us_per_step",
                          "stream_bound_us_per_step", "it")}
                 for (side, d), t in mc_t.items()},
             shape=f"{SIDE_524K}x{SIDE_524K} F=2, one certified cut of "
                   f"{mc['it']} steps", cp_simplex_cut=cps_cut),
        dict(name="components_fused", source="components_fused.cu",
             replaces="components_fused.py:84", max_abs_err=0.0,
             ms=cc["ms"], plain_ms=cc["plain_ms"], device_us=cc["device_us"],
             host_us_per_call=cc["host_us"],
             shape=f"{SIDE_524K}x{SIDE_524K} F=2, 10% active, "
                   f"{cc['passes']} passes (union-find)",
             cases={name: {k: t[k] for k in ("device_us", "ms", "host_us",
                                             "passes", "plain_rounds",
                                             "components")}
                    for name, t in cc_t.items()},
             cp_simplex_components=cps_comp),
        dict(name="solve_fused", source="solve_fused.cu",
             replaces="solve_fused.py:300", max_abs_err=sf_err[
                 torch.float32], max_abs_err_f64=sf_err[torch.float64],
             eeg_dense_max_abs_err=sfm["err_float32"],
             eeg_dense_max_abs_err_f64=sfm["err_float64"],
             mesh_max_abs_err=sfm["mesh_err_float32"],
             mesh_max_abs_err_f64=sfm["mesh_err_float64"],
             mesh_iterations_f64=sfm["mesh_it_float64"],
             ms=sfm["mesh_ms"], plain_ms=sfm["mesh_plain_ms"],
             us_per_iteration=sfm["mesh_ms"] * 1e3 / 3000,
             plan_host_ms=sfm["mesh_plan_ms"],
             ms_300=sfm["mesh_ms_300"], plain_ms_300=sfm["mesh_plain_ms_300"],
             eeg_dense_ms=sfm["ms"], eeg_dense_plain_ms=sfm["plain_ms"],
             shape=f"mesh BandedGraphD1, V={sfm['mesh_args'][5].shape[0]} "
                   f"e={sfm['mesh_args'][8].shape[0]} N="
                   f"{sfm['mesh_args'][1].shape[0]} (the pfdr-mesh-banded "
                   f"path's call), 3000 iterations (the path's launch; "
                   f"ms_300: 300 iterations); eeg_dense_ms: dense, "
                   f"rv={sfm['rv']} rv_cap={sfm['args'][5].shape[0]} (the "
                   f"EEG host cut's first reduced problem, which the route "
                   f"now sends to solve_small)"),
        dict(name="stencil_fused_simplex", source="stencil_fused_simplex.cu",
             replaces="stencil_fused_simplex.py:111",
             max_abs_err=sx_err[torch.float32],
             max_abs_err_f64=sx_err[torch.float64], ms=sx_t["ms"],
             plain_ms=sx_t["plain_ms"], device_us=sx_t["device_us"],
             plain_device_us=sx_t["plain_device_us"],
             host_us_per_call=sx_t["host_us"],
             standalone_host_us_per_call=sx_t["standalone_host_us"],
             shape=f"{V_SIDE}x{V_SIDE} F=2 K={K_SIMPLEX}, one multi-label "
                   f"PFDR iteration (one launch, a thread a (cell, label), "
                   f"through the plan on the StencilGraphD1); checked at "
                   f"K={list(SIMPLEX_KS)}"),
    ]
    f32, f64 = torch.float32, torch.float64
    for kern in ("gather", "scatter"):
        mesh = bt["mesh"][kern]
        rows.append(dict(
            name=f"banded_{kern}", source="banded.cu",
            replaces=f"banded.py:{293 if kern == 'gather' else 312}",
            max_abs_err=max(bt["err"][(kern, gn, f32)]
                            for gn in ("mesh", "star")),
            max_abs_err_f64=max(bt["err"][(kern, gn, f64)]
                                for gn in ("mesh", "star")),
            ms=mesh["ms"], plain_ms=mesh["plain_ms"],
            device_us=mesh["device_us"], library_ms=mesh["library_ms"],
            library=("index_select on the concatenated endpoints"
                     if kern == "gather" else
                     "two index_add_ calls into zeros (float atomics: not "
                     "deterministic)"),
            host_us_per_call=bt["host"],
            star=dict(bt["star"][kern], v=bt["star"]["v"],
                      e=bt["star"]["e"], long_rows=bt["star"]["long_rows"]),
            shape=f"mesh V={v_eeg} E={eb} (banded order, padded), [V] "
                  f"float32"))
    rows += [
        dict(name="banded_fused", source="banded_fused.cu",
             replaces="banded_fused.py:165", max_abs_err=bf_err[f32],
             max_abs_err_f64=bf_err[f64], ms=bf_t["ms"],
             plain_ms=bf_t["plain_ms"], device_us=bf_t["device_us"],
             host_us_per_call=bf_t["host_us"],
             shape=f"mesh V={v_eeg} E={bf_t['e']} (banded order, padded), "
                   f"one PFDR stage: lanes per vertex, one launch"),
        dict(name="circulant_fused", source="circulant_fused.cu",
             replaces="circulant_fused.py:219",
             max_abs_err=max(cf_err[(gn, f32)] for gn in ("mesh", "grid")),
             max_abs_err_f64=max(cf_err[(gn, f64)]
                                 for gn in ("mesh", "grid")),
             ms=cf_t["ms"], plain_ms=cf_t["plain_ms"],
             device_us=cf_t["device_us"], host_us_per_call=cf_t["host_us"],
             shape=f"mesh F={cf_t['f']} VV={cf_t['vv']} + {cf_t['rem']} "
                   f"remainder slots, one PFDR stage (2 launches; the "
                   f"kernel moves the bound's 7 edge streams)"),
        dict(name="circulant_fused_simplex",
             source="circulant_fused_simplex.cu",
             replaces="circulant_fused_simplex.py:232",
             max_abs_err=cs_err[f32], max_abs_err_f64=cs_err[f64],
             ms=cs_t["ms"], plain_ms=cs_t["plain_ms"],
             device_us=cs_t["device_us"],
             shape=f"mesh F={cs_t['f']} VV={cs_t['vv']} + {cs_t['rem']} "
                   f"remainder slots, K={K_SIMPLEX}, one multi-label PFDR "
                   f"iteration"),
    ]
    # slice 5: one halo iteration on a 512 x 2048 row block (P = 4 of the
    # 2048 x 2048 field), F = 2: x, grad, Gamma, th_l1 and 7F edge fields
    # read, x and 2F edge fields written; per cell about 22 operations per
    # family and 10 for the vertex
    hb = HALO_SIDE // 4 * HALO_SIDE
    f_h = hf_t[1]["f"]
    work["halo_fused"] = (4 * (5 + 9 * f_h) * hb, (22 * f_h + 10) * hb)
    rows.append(dict(
        name="halo_fused", source="halo_fused.cu",
        replaces="halo_fused.py:222", max_abs_err=hf_abs[f32],
        max_abs_err_f64=hf_abs[f64],
        max_rel_err=max(v for (d, _), v in hf_err.items() if d == f32),
        max_rel_err_f64=max(v for (d, _), v in hf_err.items() if d == f64),
        ms=hf_t[1]["ms"], plain_ms=hf_t[1]["plain_ms"],
        device_us=hf_t[1]["device_us"],
        plain_device_us=hf_t[1]["plain_device_us"],
        hd2=dict(f=hf_t[2]["f"], ms=hf_t[2]["ms"],
                 plain_ms=hf_t[2]["plain_ms"],
                 device_us=hf_t[2]["device_us"],
                 bound_ms=bound(4 * (5 + 9 * hf_t[2]["f"]) * hb,
                                (22 * hf_t[2]["f"] + 10) * hb)[0]),
        shape=f"{HALO_SIDE // 4}x{HALO_SIDE} row block F={f_h} hd=1 (P=4 "
              f"of {HALO_SIDE}x{HALO_SIDE}), one halo PFDR iteration (5 "
              f"launches, exchanges replayed)"))
    kernels = []
    for row in rows:
        b_ms, b_by = bound(*work[row["name"]])
        kernels.append(dict(
            name=row["name"], route="cuda",
            source="cp_pfdr_graph_d1_tpu_torch/csrc/" + row.pop("source"),
            replaces="cp_pfdr_graph_d1_tpu/ops/" + row.pop("replaces"),
            launches=launches[row["name"]], bound_ms=b_ms, bound_by=b_by,
            library_ms=row.pop("library_ms", None),
            **{k: v for k, v in row.items() if k != "name"}))
    print(f"[total] {time.monotonic() - t_main:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def compare_timings(device="cuda"):
    """``python3 chip_smoke.py --compare``: timings that another checkout of
    the port can run with its own kernels (copy this script into its root
    and run it there), so that two versions are compared on one card in
    one call: first ``compare_simplex_components``, then
    ``circulant_fused_simplex`` per call on the mesh (K = 4,
    al = 1, float32; CUDA events over 200 calls, and device time),
    ``circulant_fused`` and ``banded_fused`` per call on the mesh (float32,
    l1 with positivity; CUDA events over 200 calls, device time, and the
    host clock over 10,000 calls), the ``[pfdr-mesh]`` and monitored
    ``[pfdr-mesh-banded]`` solves in microseconds per iteration (3000
    float32 iterations after a warm-up of 300),
    ``solve_small`` per 300 float32 iterations on phase_solve_small's two
    partitions (dense; the schedule the wrapper takes; 20 solves), the EEG
    host cut end to end (min of two warm runs, as ``[cp]``) with its
    reduced solves' calls summed by route (one more run), ``mincut_fused``
    microseconds per step at 140 x 140,
    512 x 512 and 724 x 724 in float64 and float32 (the schedule the
    kernel takes; phase_mincut's cuts), and ``banded_gather`` /
    ``banded_scatter`` per call on the mesh's float32 [V] field beside
    ``index_select`` and two ``index_add_`` calls, by CUDA events (200
    calls) and by the host clock (10,000 calls).  First:
    ``solve_fused``'s mesh call (float32, ms a launch and us an iteration
    at 300 and at the path's 3000 iterations, by CUDA events and as device
    time, and the host time of its launch plan), ``stencil_fused`` at 140 x
    140 (float32, l1 with positivity: device time, CUDA events over 500
    calls, host clock over 10,000 calls, standalone and through
    ``StencilGraphD1.fused_iteration``) and ``[pfdr]`` in us an iteration
    (3000 float32 iterations after a 300-iteration run)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_env()
    phase_build()
    import torch
    compare_simplex_components(device)
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused as sfu
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused as sf
    args, kw = mesh_whole_inputs(torch.float32, device, 0.0, 3000)
    plan = (f"{plan_ms(sfu, args):.3f} ms" if hasattr(sfu, "make_plan")
            else "not timed apart (built inside the call)")
    for it_max in (300, 3000):
        k = dict(kw, it_max=it_max)
        call = lambda: sfu.fused_pfdr_solve(*args, **k)  # noqa
        ms = cuda_ms(call, 3)
        dev = device_profile(call, 3)[0] / 1e3
        print(f"[compare] solve_fused float32 mesh call, {it_max} "
              f"iterations: {ms:.3f} ms a launch, {ms * 1e3 / it_max:.2f} "
              f"us an iteration (CUDA events, the launch plan included); "
              f"{dev:.3f} ms of device time ({dev * 1e3 / it_max:.2f} us "
              f"an iteration); launch plan {plan} of host time a call",
              flush=True)
    g, pre, x, grad, zu, zv = stencil_setup(torch.float32, device)
    h, w = g.field_shape
    f = len(g.shifts)
    sargs = (x.reshape(h, w), grad.reshape(h, w), pre.ga.reshape(h, w),
             pre.th_l1.reshape(h, w)) + tuple(
        a.reshape(f, h, w) for a in (zu, zv, pre.wu, pre.wv, pre.w_d1u,
                                     pre.w_d1v, pre.th_d1))
    skw = dict(shifts=g.shifts, rho=1.5, vkind="l1", positivity=True,
               lo=-np.inf, hi=np.inf)
    vp = vertex_proxes()[1]
    for name, step in (
            ("standalone", lambda: sf.fused_stencil_iteration(*sargs, **skw)),
            ("fused_iteration", lambda: g.fused_iteration(
                x, grad, pre, zu, zv, 1.5, vp))):
        counts = {}
        dev = device_profile(step, 200, counts)[0]
        print(f"[compare] stencil_fused float32 {h}x{w} F={f} l1+pos "
              f"({name}): {dev:.2f} us of device time ({counts}), "
              f"{cuda_ms(step, 500) * 1e3:.2f} us per call (CUDA events), "
              f"{host_us(step):.2f} us of host time per call (10,000 "
              f"calls)", flush=True)
    phase_pfdr(device, 300)
    us = phase_pfdr(device)
    print(f"[compare] pfdr float32: {us:.2f} us an iteration", flush=True)
    from cp_pfdr_graph_d1_tpu_torch.ops import banded
    from cp_pfdr_graph_d1_tpu_torch.ops import banded_fused as bf
    from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused as cf
    from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused_simplex as cfs
    from cp_pfdr_graph_d1_tpu_torch.ops import mincut_fused as mf
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    args, kw = mesh_simplex_planes(torch.float32, device, 1.0, None, False)
    step = lambda: cfs.fused_circulant_simplex_iteration(*args, **kw)  # noqa
    print(f"[compare] circulant_fused_simplex float32 mesh K={K_SIMPLEX} "
          f"al=1: {cuda_ms(step, 200) * 1e3:.2f} us per call, "
          f"{device_profile(step, 200)[0]:.2f} us of device time",
          flush=True)
    _, _, a, y = build_mesh_problem()
    kw = dict(rho=1.5, vkind="l1", positivity=True, lo=-np.inf, hi=np.inf)
    for kind, fn in (("circulant", cf.fused_circulant_iteration),
                     ("banded", bf.fused_banded_iteration)):
        args = stage_args(mesh_graph(kind, torch.float32, device), a, y,
                          torch.float32, device)
        step = lambda: fn(*args, **kw)  # noqa
        print(f"[compare] {kind}_fused float32 mesh l1+pos: "
              f"{cuda_ms(step, 200) * 1e3:.2f} us per call, "
              f"{device_profile(step, 200)[0]:.2f} us of device time, "
              f"{host_us(step):.2f} us of host time per call (10,000 "
              f"calls)", flush=True)
    for name, container, monitor in (("pfdr-mesh", "auto", False),
                                     ("pfdr-mesh-banded monitored", "banded",
                                      True)):
        mesh_pfdr(torch.float32, device, container, 300, monitor)
        _, it, dt = mesh_pfdr(torch.float32, device, container, 3000,
                              monitor)
        print(f"[compare] {name} float32: {dt * 1e6 / it:.2f} us per "
              f"iteration ({it} iterations, after a 300-iteration "
              f"warm-up)", flush=True)
    cv1, rg1, eu, ev, la = first_cut_partition()
    for cv, rg in ((cv1, rg1), block_partition(eu, ev, la)):
        args, rv = small_inputs("dense", cv, rg, torch.float32, device)
        kw = solve_kw(torch.float32, rv)
        ms = cuda_ms(lambda: ss.fused_pfdr_solve_small(*args, **kw), 20)
        print(f"[compare] solve_small float32 dense rv={rv} rv_cap="
              f"{args[5].shape[0]}: {ms:.3f} ms per 300 iterations",
              flush=True)
    g, a, y = eeg_host_cut(device)
    t_best, t_warm, out, _ = eeg_host_cut_runs(g, a, y, device)
    _, rec = record_reduced_solves(
        lambda: run_cp(g, a, y, np.float32, device))
    print(f"[compare] EEG host cut float32: min of two warm runs "
          f"{t_best * 1e3:.1f} ms (warm-up {t_warm * 1e3:.1f} ms), "
          f"{out.it} CP iterations, {len(out.rX)} components, objective "
          f"{objective(out.rX[out.Cv], a, y, *g.host_coo()):.7g}",
          flush=True)
    print_route_totals("[compare]", rec)
    for side in MINCUT_SIDES:
        for dtype in (torch.float64, torch.float32):
            g, active, r = masked_stencil(side, dtype, device, 0.1, 0)
            cost = torch.as_tensor(r.standard_normal(g.num_vertices),
                                   dtype=dtype, device=device)
            args, _ = mf.cut_problem(g, torch.where(active, 0.0, g.la_d1),
                                     cost, CUT_TOL)
            kw = dict(shifts=g.shifts, check_every=250)
            it = int(mf.fused_pdhg_min_cut(*args, 100_000, **kw)[4])
            ms = cuda_ms(lambda: mf.fused_pdhg_min_cut(*args, 100_000, **kw),
                         5)
            sched = getattr(mf.fused_pdhg_min_cut, "last_schedule", None)
            print(f"[compare] mincut_fused {str(dtype)[6:]} {side}x{side}: "
                  f"{it} steps, {ms:.4f} ms per cut, {ms * 1e3 / it:.3f} us "
                  f"per step (schedule {sched})", flush=True)
    g = mesh_graph("banded", torch.float32, device)
    r = np.random.default_rng(5)
    x, vu, vv = (torch.as_tensor(r.normal(size=n), dtype=torch.float32,
                                 device=device)
                 for n in (g.num_vertices, g.num_edges, g.num_edges))
    idx = g.edge_index()
    both = torch.cat([idx.eu, idx.ev]).to(torch.int64)
    calls = {"banded_gather": lambda: banded.banded_gather(g, x),
             "index_select": lambda: x.index_select(0, both),
             "banded_scatter": lambda: banded.banded_scatter(g, vu, vv),
             "index_add_ x2": lambda: torch.zeros_like(x).index_add_(
                 0, g.eu, vu).index_add_(0, g.ev, vv)}
    print("[compare] banded per call, mesh float32 [V], us (CUDA events, "
          "200 calls / host clock, 10,000 calls): " + "; ".join(
              f"{k} {cuda_ms(f, 200) * 1e3:.2f} / {host_us(f):.2f}"
              for k, f in calls.items()), flush=True)


def compare_simplex_components(device="cuda"):
    """The first timings of ``--compare``: ``stencil_fused_simplex``
    (``simplex_timings``: float32, 140 x 140, K = 4, al = 1), the
    ``[pfdr-simplex]`` solve in us an iteration (3000 float32 iterations
    after a 300-iteration run) and ``components_fused`` on every case of
    ``components_cases`` (``components_call_times``: each of the three
    kernels' device time is the split of the new schedule's passes)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import components_fused as cf
    args, kw, g = simplex_planes(torch.float32, device, 1.0, None, False)
    for name, t in simplex_timings(args, kw, g).items():
        print(f"[compare] stencil_fused_simplex float32 {V_SIDE}x{V_SIDE} "
              f"K={K_SIMPLEX} al=1 ({name}): {t['device_us']:.2f} us of "
              f"device time ({t['kernels']}), {t['ms'] * 1e3:.2f} us per "
              f"call (CUDA events), {t['host_us']:.2f} us of host time per "
              f"call (10,000 calls)", flush=True)
    pfdr_simplex_solve(torch.float32, device, 300).p.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pfdr_simplex_solve(torch.float32, device, 3000).p.cpu()
    dt = time.perf_counter() - t0
    print(f"[compare] pfdr-simplex float32: {dt * 1e6 / 3000:.2f} us an "
          f"iteration", flush=True)
    for name, mask, shifts in components_cases(device):
        kw = dict(shifts=shifts, it_max=mask[0].numel())
        t = components_call_times(lambda: cf.fused_components(mask, **kw))
        print(f"[compare] components_fused {name}: {t['device_us']:.2f} us "
              f"of device time ({t['kernels']}), {t['ms'] * 1e3:.2f} us per "
              f"call (CUDA events), {t['host_us']:.2f} us of host time per "
              f"call (200 calls)", flush=True)


def profile_only():
    """``python3 chip_smoke.py --profile-mesh``: the mesh paths' profile
    alone, in a fresh process."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_env()
    phase_build()
    profile_mesh()


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-mesh"]:
        profile_only()
    elif sys.argv[1:] == ["--compare"]:
        compare_timings()
    elif sys.argv[1:] == ["--reduced-options"]:
        reduced_options_only()
    else:
        main()
