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
   float64 and float32, with the time per launch of both;
4. ``solve_small`` against its plain version on reduced problems of that
   problem (its first steepest cut, about 2.6k components, and a 128-block
   partition), for the dense, Gram and diagonal operators;
5. ``mincut_fused`` against its plain version at 140 x 140 and 724 x 724
   (10 % of the edges masked, standard-normal costs), float64 and float32;
6. ``components_fused`` against its plain version at the same sizes, with
   10 % and 45 % of the edges masked;
7. ``solve_fused`` against its plain version on the reduced problem the
   host-cut main path gives it (the EEG problem's first steepest cut,
   dense, rv_cap 4096) and on reduced problems beyond ``solve_small``: a
   40,000-block partition of the 724 x 724 grid with the diagonal
   operator, and the EEG grid with every vertex its own component and the
   dense operator; then ``solve_small`` against ``solve_fused`` on the same
   reduced problems (the crossover behind ``SOLVE_FUSED_MIN_RV_CAP``);
8. ``stencil_fused_simplex`` against its plain version at 140 x 140,
   F = 2, K = 4 for four losses (one iteration in float64 and float32, a
   400-iteration float64 loop of the solver's kernel loop), the kernel loop
   with monitoring, progress lines and reconditioning against the staged
   loop, and the time per launch of both;
9. ``mincut_fused`` and ``components_fused`` against their plain versions
   on the inputs the multi-label cut-pursuit path gives them (the calls of
   an expansion cut and a components call recorded from its device loop
   at 512 x 512), the cut in float32 and float64;
10. on ``bench.py:build_mesh_problem``'s Delaunay mesh (19,600 vertices,
   strip-ordered by the port's ``strip_order``): ``banded_gather`` and
   ``banded_scatter`` (and on a 4,096-vertex star, a hub of 4,096 slots;
   ``index_select`` and ``index_add_`` timed beside them),
   ``banded_fused``, ``circulant_fused`` (64 families and a banded
   remainder; and the 140 x 140 grid as a circulant container, no
   remainder) and ``circulant_fused_simplex`` (K = 4, four losses, and
   400-iteration float64 loops) against their plain versions, float64 and
   float32, with the time per call of both;
11. the main paths, each with the launch counters set to 0 just before it
   and read just after: ``pfdr_quadratic_d1`` on the EEG-scale stencil
   problem (3000 iterations in float32); ``api.cp_quadratic_d1_l1`` on it
   (host cut) in float32, held against the port's own float64 run on the
   CPU; the same problem through ``cut="device"`` and the chained loop
   (``bench.py``'s options), held against the same float64 run; and the
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
12. where the time goes (``torch.profiler``).

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
            out_k = sf.fused_stencil_iteration(*args, **kw)
            out_p = sf.stencil_iteration_plain(*args, **kw)
            if device == "cuda":
                check(out_k[0].is_cuda, "kernel output not on the card")
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
            print(f"[stencil_fused] {str(dtype)[6:]} {vp.kind:6s} "
                  f"pos={int(vp.positivity)} x/zu/zv max|kernel-plain| = "
                  f"{err:.3e}, num/den max|kernel-plain|/max(1,|plain|) = "
                  f"{rel:.3e} (tol {tol:g})")
        if dtype == torch.float32 and device == "cuda":
            kw = dict(shifts=g.shifts, rho=1.5, vkind="l1", positivity=True,
                      lo=-np.inf, hi=np.inf)
            def kern():
                return sf.fused_stencil_iteration(*args, **kw)

            def plain():
                return sf.stencil_iteration_plain(*args, **kw)

            times["ms"] = cuda_ms(kern, 500)
            times["plain_ms"] = cuda_ms(plain, 200)
            dev_k, _, _ = device_profile(kern, 200)
            dev_p, per_p, _ = device_profile(plain, 200)
            times["device_us"], times["plain_device_us"] = dev_k, dev_p
            print(f"[stencil_fused] float32 {h}x{w} F={f} l1+pos, per call: "
                  f"kernel {times['ms'] * 1e3:.2f} us between CUDA events "
                  f"({dev_k:.2f} us of device time, 2 kernels), plain "
                  f"{times['plain_ms'] * 1e3:.2f} us ({dev_p:.2f} us of "
                  f"device time, {len(per_p)} distinct kernels)")
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


def phase_solve_small(device="cuda"):
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    cv1, rg1, eu, ev, la = first_cut_partition()
    cv2, rg2 = block_partition(eu, ev, la)
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    times = {}
    for dtype in (torch.float64, torch.float32):
        for (cv, rg) in ((cv1, rg1), (cv2, rg2)):
            for kind in ("dense", "gram", "diag"):
                args, rv = small_inputs(kind, cv, rg, dtype, device)
                kw = solve_kw(dtype, rv)
                xk, zk, itk, _ = ss.fused_pfdr_solve_small(*args, **kw)
                xp, zp, itp, _ = ss.solve_small_plain(*args, **kw)
                err = max(max_err(xk, xp), max_err(zk, zp))
                errs[dtype] = max(errs[dtype], err)
                tol = F64_TOL if dtype == torch.float64 else F32_TOL
                check(int(itk) == int(itp), f"solve_small {kind} rv={rv} "
                      f"{dtype}: it {int(itk)} vs plain {int(itp)}")
                check(err <= tol, f"solve_small {kind} rv={rv} {dtype}: "
                      f"err {err:.3g} > {tol}")
                line = (f"[solve_small] {str(dtype)[6:]} {kind:5s} rv={rv:5d}"
                        f" rv_cap={args[5].shape[0]} e={args[8].shape[0]} "
                        f"it={int(itk)} max|kernel-plain| = {err:.3e} "
                        f"(tol {tol:g})")
                if dtype == torch.float32 and kind == "dense" and \
                        device == "cuda":
                    ms = cuda_ms(lambda: ss.fused_pfdr_solve_small(
                        *args, **kw), 5)
                    plain_ms = cuda_ms(lambda: ss.solve_small_plain(
                        *args, **kw), 2)
                    times.setdefault("ms", {})[rv] = ms
                    times.setdefault("plain_ms", {})[rv] = plain_ms
                    times.setdefault("dims", {})[rv] = (
                        args[5].shape[0], args[8].shape[0], args[1].shape[0])
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


def phase_cp(device="cuda"):
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    a, y = build_grid_problem()
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): LA_D1, (1, 0): LA_D1},
                              dtype=torch.float32, device=device)
    before = ss.fused_pfdr_solve_small.launches
    runs = []
    for k in range(3):  # one warm-up (printing its progress), two timed
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
    grew = ss.fused_pfdr_solve_small.launches - before
    check(grew > 0, "solve_small was not launched by the cut-pursuit run")
    t_best = min(t for t, _ in runs[1:])
    out = runs[-1][1]
    x = out.rX[out.Cv]
    check(np.all(np.isfinite(x)) and x.shape == (V_SIDE * V_SIDE,),
          "cut-pursuit result not finite or of the wrong shape")
    print(f"[cp] float32 on the card: min of two warm runs "
          f"{t_best * 1e3:.1f} ms (warm-up {runs[0][0] * 1e3:.1f} ms); "
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
                                                mincut_fused, solve_fused,
                                                solve_small, stencil_fused,
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
                circulant_fused_simplex.fused_circulant_simplex_iteration}


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


def phase_mincut(device="cuda"):
    """``mincut_fused`` against its plain version on one steepest cut: 10 %
    of the edges active, standard-normal costs (seed 0).  Both runs must be
    certified and their cuts' values agree within twice the certificate
    (a min-cut need not be unique); in float64 the step counts are equal
    and the iterates agree to F64_TOL.  In float32 only the certificate and
    the cut value are held: the relaxed iterates drift by rounding over
    thousands of steps without changing the certified cut."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.maxflow.device import cut_value
    from cp_pfdr_graph_d1_tpu_torch.ops import mincut_fused as mf
    errs, out = {}, {}
    for side in (V_SIDE, SIDE_524K):
        for dtype in (torch.float64, torch.float32):
            g, active, r = masked_stencil(side, dtype, device, 0.1, 0)
            cost = torch.as_tensor(r.standard_normal(g.num_vertices),
                                   dtype=dtype, device=device)
            args, _ = mf.cut_problem(g, torch.where(active, 0.0, g.la_d1),
                                     cost, CUT_TOL)
            kw = dict(shifts=g.shifts, check_every=250)
            res_k = mf.fused_pdhg_min_cut(*args, 100_000, **kw)
            res_p = mf.pdhg_min_cut_plain(*args, 100_000, **kw)
            eu, ev, _ = g.host_coo()
            w = args[0].reshape(-1).cpu().numpy()
            c = args[1].reshape(-1).cpu().numpy()
            tol = float(args[6])
            vals, its = [], []
            for x, _, gap, t_best, it in (res_k, res_p):
                check(float(gap) <= tol, f"mincut {side} {dtype}: gap "
                      f"{float(gap):.4g} above the certificate {tol:.4g}")
                vals.append(cut_value(eu, ev, w, c, (x > t_best).reshape(-1)
                                      .cpu().numpy()))
                its.append(int(it))
            check(abs(vals[0] - vals[1]) <= 2 * tol, f"mincut {side} "
                  f"{dtype}: cut values {vals[0]} vs plain {vals[1]}")
            err = max(max_err(res_k[0], res_p[0]), max_err(res_k[1],
                                                           res_p[1]))
            if dtype == torch.float64:
                check(its[0] == its[1], f"mincut {side}: {its[0]} steps vs "
                      f"plain {its[1]}")
                check(err <= F64_TOL, f"mincut {side} float64: x/z err "
                      f"{err:.3g}")
            errs[(side, dtype)] = err
            ms = cuda_ms(lambda: mf.fused_pdhg_min_cut(*args, 100_000, **kw),
                         5)
            plain_ms = cuda_ms(
                lambda: mf.pdhg_min_cut_plain(*args, 100_000, **kw), 1)
            out[(side, dtype)] = dict(ms=ms, plain_ms=plain_ms, it=its[0],
                                      v=g.num_vertices, f=len(g.shifts))
            print(f"[mincut_fused] {str(dtype)[6:]} {side}x{side} F=2: "
                  f"certified cut in {its[0]} steps (plain {its[1]}), cut "
                  f"value {vals[0]:.9g} vs plain {vals[1]:.9g} (tol "
                  f"{2 * tol:.3g}), x/z max|kernel-plain| {err:.3e}; "
                  f"{ms:.3f} ms per cut ({ms * 1e3 / its[0]:.2f} us per "
                  f"step), plain {plain_ms:.1f} ms", flush=True)
    return errs, out


def phase_components(device="cuda"):
    """``components_fused`` against its plain version: labels and
    component counts equal bit for bit (the fixpoint is unique)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import components_fused as cf
    out = {}
    for side in (V_SIDE, SIDE_524K):
        for frac in (0.1, 0.45):
            g, active, _ = masked_stencil(side, torch.float32, device, frac,
                                          1)
            mask = (~active & (g.la_d1 > 0)).reshape(2, side,
                                                     side).contiguous()
            kw = dict(shifts=g.shifts, it_max=side * side)
            lab_k, rounds_k = cf.fused_components(mask, **kw)
            lab_p, rounds_p = cf.components_plain(mask, **kw)
            iota = torch.arange(side * side, device=device)
            n_k = int((lab_k.reshape(-1) == iota).sum())
            n_p = int((lab_p.reshape(-1) == iota).sum())
            check(bool((lab_k == lab_p).all()) and n_k == n_p,
                  f"components {side} {frac}: labels differ ({n_k} vs "
                  f"{n_p} components)")
            ms = cuda_ms(lambda: cf.fused_components(mask, **kw), 20)
            plain_ms = cuda_ms(lambda: cf.components_plain(mask, **kw), 2)
            out[(side, frac)] = dict(ms=ms, plain_ms=plain_ms,
                                     rounds=int(rounds_k), v=side * side)
            print(f"[components_fused] {side}x{side}, {frac:.0%} active: "
                  f"{n_k} components, labels equal to the plain version's; "
                  f"{int(rounds_k)} rounds (plain {int(rounds_p)}); "
                  f"{ms:.3f} ms, plain {plain_ms:.2f} ms", flush=True)
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


def phase_solve_fused(device="cuda"):
    """``solve_fused`` against its plain version: first on the reduced
    problem the host-cut main path gives it (the EEG problem's first
    steepest cut, dense, rv_cap 4096, prepared as ``_kernel_solve``
    prepares it, edges sorted), then on reduced problems that
    ``solve_small`` cannot hold.  float64: the evolution test stops both,
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
        xk, zk, itk, _ = sfu.fused_pfdr_solve(*args, **kw)
        xp, zp, itp, _ = sfu.solve_fused_plain(*args, **kw)
        err = max(max_err(xk, xp), max_err(zk, zp))
        errs[dtype] = max(errs[dtype], err)
        main["err_" + str(dtype)[6:]] = err
        tol = F64_TOL if dtype == torch.float64 else F32_TOL
        check(int(itk) == int(itp), f"solve_fused main-path shape {dtype}: "
              f"it {int(itk)} vs plain {int(itp)}")
        check(err <= tol, f"solve_fused main-path shape {dtype}: err "
              f"{err:.3g} > {tol}")
        line = (f"[solve_fused] {str(dtype)[6:]} dense rv={rv} rv_cap="
                f"{args[5].shape[0]} e={args[8].shape[0]} (host-cut main "
                f"path's first reduced problem) it={int(itk)} "
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
            xk, zk, itk, _ = sfu.fused_pfdr_solve(*args, **kw)
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
        xk, zk, itk, _ = sfu.fused_pfdr_solve(*args, **kw)
        xp, zp, itp, _ = sfu.solve_fused_plain(*args, **kw)
        err = max(max_err(xk, xp), max_err(zk, zp))
        errs[dtype] = max(errs[dtype], err)
        name = str(dtype)[6:]
        main[f"mesh_err_{name}"], main[f"mesh_it_{name}"] = err, int(itk)
        tol = F64_TOL if f64 else F32_TOL
        check(int(itk) == int(itp), f"solve_fused mesh {dtype}: it "
              f"{int(itk)} vs plain {int(itp)}")
        check(err <= tol, f"solve_fused mesh {dtype}: err {err:.3g}")
        print(f"[solve_fused] {name} mesh BandedGraphD1 (the pfdr-mesh-banded "
              f"path's call) rv={kw['rv']} e={args[8].shape[0]} it="
              f"{int(itk)} (plain {int(itp)}) max|kernel-plain| = "
              f"{err:.3e} (tol {tol:g})", flush=True)
    return errs, main


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
    """solve_small (one block) against solve_fused (the whole card) on the
    same reduced problems of the EEG host route, float32, 300 iterations:
    the measurement behind ``SOLVE_FUSED_MIN_RV_CAP`` in
    ``solvers/cut_pursuit.py``."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused as sfu
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    cv1, rg1, eu, ev, la = first_cut_partition()
    for cv, rg in ((cv1, rg1), block_partition(eu, ev, la, 8, 16),
                   block_partition(eu, ev, la, 16, 32),
                   block_partition(eu, ev, la, 32, 32),
                   block_partition(eu, ev, la, 32, 64)):
        for kind in ("dense", "diag"):
            args, rv = small_inputs(kind, cv, rg, torch.float32, device)
            kw = solve_kw(torch.float32, rv)
            t_s = cuda_ms(lambda: ss.fused_pfdr_solve_small(*args, **kw), 3)
            t_f = cuda_ms(lambda: sfu.fused_pfdr_solve(*args, **kw), 3)
            print(f"[crossover] {kind:5s} rv={rv} rv_cap={args[5].shape[0]}"
                  f": solve_small {t_s:.3f} ms, solve_fused {t_f:.3f} ms "
                  f"per 300 iterations", flush=True)


def denoise_problem():
    """The 524k-vertex TV denoising problem of ``bench.py:366-386``: twelve
    constant rectangles plus Gaussian noise (seed 5)."""
    side = SIDE_524K
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


def simplex_q():
    """``bench.py:bench_simplex``'s observations: Dirichlet(0.7) rows of
    K = 4 labels on the 140 x 140 grid (seed 11)."""
    r = np.random.default_rng(11)
    return r.dirichlet(np.full(K_SIMPLEX, 0.7),
                       size=V_SIDE * V_SIDE).astype(np.float32)


def simplex_problem(dtype, device, la_f):
    """``bench_simplex``'s stencil (140 x 140, F = 2, weights 0.5), its
    observations and the loss weights ``la_f`` (a constant, or None)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    g = StencilGraphD1.create((V_SIDE, V_SIDE), {(0, 1): 0.5, (1, 0): 0.5},
                              dtype=dtype, device=device)
    q = torch.as_tensor(simplex_q(), dtype=dtype, device=device)
    laf = (torch.full((g.num_vertices,), la_f, dtype=dtype, device=device)
           if la_f is not None else None)
    return g, q, laf


def simplex_planes(dtype, device, al, la_f, label_mode, seed=3):
    """Kernel inputs of one multi-label iteration on ``simplex_problem``:
    the preconditioner of the problem, a seeded random iterate on the
    simplex and random auxiliary pairs, as ``[K, H, W]`` and
    ``[F, K, H, W]`` planes."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_simplex as ps
    h = w = V_SIDE
    k = K_SIMPLEX
    g, q, laf = simplex_problem(dtype, device, la_f)
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
    return args, kw


def simplex_loop(dtype, device, al, la_f, label_mode, plain):
    """400 iterations of the solver's kernel loop
    (``pfdr_simplex._simplex_fused_loop``) on ``simplex_problem`` from the
    uniform start, each iteration the kernel's wrapper or, with ``plain``,
    its plain version, both on the card.  Returns ``(p, iterations)``."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused_simplex as sfs
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_simplex as ps
    g, q, laf = simplex_problem(dtype, device, la_f)
    p0 = torch.full_like(q, 1.0 / K_SIMPLEX)
    pre = ps.initial_precondition_simplex(al, laf, g, q, p0, 1.5)
    opt = PFDROptions(rho=1.5, dif_tol=1.0 if label_mode else 1e-9,
                      it_max=400)
    step = (functools.partial(sfs.stencil_simplex_iteration_plain,
                              shifts=g.shifts) if plain else None)
    res = ps._simplex_fused_loop(g, q, p0, laf, pre, al=al, opt=opt,
                                 has_laf=laf is not None,
                                 label_mode=label_mode, step=step)
    return res.p, res.it


def phase_stencil_simplex(device="cuda"):
    """``stencil_fused_simplex`` against its plain version on the card at
    140 x 140, F = 2, K = 4, for four losses: one iteration (float64 within
    1e-12, float32 within 1e-5 on p, zu, zv, and the evolution sum
    relative to max(1, |plain|); equal labels and counts in float64, at
    most 0.1 % of the vertices apart in float32, where FMA contraction may
    flip a near tie), then a 400-iteration float64 loop of each with equal
    iteration counts.  Times: CUDA events and torch.profiler device time
    per launch, float32, the main path's case (al = 1, no la_f)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused_simplex as sfs
    tols = {torch.float64: 1e-12, torch.float32: 1e-5}
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    v = V_SIDE * V_SIDE
    for dtype in (torch.float64, torch.float32):
        for name, al, la_f, label_mode in SIMPLEX_CASES:
            args, kw = simplex_planes(dtype, device, al, la_f, label_mode)
            out_k = sfs.fused_stencil_simplex_iteration(*args, **kw)
            out_p = sfs.stencil_simplex_iteration_plain(*args, **kw)
            if device == "cuda":
                check(out_k[0].is_cuda, "kernel output not on the card")
            err = max(max_err(out_k[i], out_p[i]) for i in (0, 2, 3))
            tol = tols[dtype]
            if label_mode:
                n_lab = int((out_k[1] != out_p[1]).sum())
                d_cnt = abs(float(out_k[4]) - float(out_p[4]))
                allowed = 0 if dtype == torch.float64 else v // 1000
                check(n_lab <= allowed and d_cnt <= allowed,
                      f"stencil_fused_simplex {dtype} {name}: {n_lab} "
                      f"labels and count {d_cnt} apart (allowed {allowed})")
                rel = d_cnt
                extra = (f"labels apart {n_lab}, counts {float(out_k[4]):.0f}"
                         f" vs {float(out_p[4]):.0f}")
            else:
                err = max(err, max_err(out_k[1], out_p[1]))
                rel = (max_err(out_k[4], out_p[4])
                       / max(1.0, abs(float(out_p[4]))))
                check(rel <= tol, f"stencil_fused_simplex {dtype} {name}: "
                      f"sum rel err {rel:.3g} > {tol}")
                extra = f"evolution sum rel err {rel:.3e}"
            check(err <= tol, f"stencil_fused_simplex {dtype} {name}: "
                  f"p/zu/zv err {err:.3g} > {tol}")
            errs[dtype] = max(errs[dtype], err)
            line = (f"[stencil_fused_simplex] {str(dtype)[6:]} {name:13s} "
                    f"one iteration: p/zu/zv max|kernel-plain| = {err:.3e} "
                    f"(tol {tol:g}); {extra}")
            if dtype == torch.float64:
                pk, itk = simplex_loop(dtype, device, al, la_f, label_mode,
                                       plain=False)
                pp, itp = simplex_loop(dtype, device, al, la_f, label_mode,
                                       plain=True)
                lerr = max_err(pk, pp)
                check(itk == itp, f"stencil_fused_simplex {name}: loop of "
                      f"{itk} iterations vs plain {itp}")
                line += (f"; 400-iteration loop: {itk} iterations (plain "
                         f"{itp}), p max|kernel-plain| {lerr:.3e}")
            print(line, flush=True)
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
        args, kw = simplex_planes(torch.float32, device, 1.0, None, False)

        def kern():
            return sfs.fused_stencil_simplex_iteration(*args, **kw)

        def plain():
            return sfs.stencil_simplex_iteration_plain(*args, **kw)

        times["ms"] = cuda_ms(kern, 500)
        times["plain_ms"] = cuda_ms(plain, 200)
        dev_k, _, _ = device_profile(kern, 200)
        dev_p, per_p, _ = device_profile(plain, 200)
        times["device_us"], times["plain_device_us"] = dev_k, dev_p
        print(f"[stencil_fused_simplex] float32 {V_SIDE}x{V_SIDE} F=2 "
              f"K={K_SIMPLEX} al=1, per call: kernel {times['ms'] * 1e3:.2f}"
              f" us between CUDA events ({dev_k:.2f} us of device time, 2 "
              f"kernels), plain {times['plain_ms'] * 1e3:.2f} us "
              f"({dev_p:.2f} us of device time, {len(per_p)} distinct "
              f"kernels)", flush=True)
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
    comp = dict(shape=f"{SIDE_262K}x{SIDE_262K} F=2, components of CP "
                      f"iteration {it_c + 1}",
                rounds=[int(rounds_k), int(rounds_p)], components=n_comp,
                labels_equal=True,
                ms=cuda_ms(lambda: cf.fused_components(mask, **ckw), 20),
                plain_ms=cuda_ms(lambda: cf.components_plain(mask, **ckw),
                                 2))
    print(f"[cp-simplex components] {comp['shape']}: {n_comp} components, "
          f"labels equal to the plain version's; rounds {comp['rounds']}; "
          f"{comp['ms']:.3f} ms, plain {comp['plain_ms']:.2f} ms", flush=True)
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
    try:
        dev, per, wall = device_profile(lambda: cp_quadratic_d1(
            op, obs, g, la_l1=np.full(a.shape[1], LA_L1, np.float32),
            positivity=True, opt=chain_options()), 1)
    finally:
        chn._warm_partition = warm
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
    dev, per, wall = device_profile(
        lambda: cp_quadratic_d1(IdentityOp(), y5, g5, opt=opt5), 1)
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
    path and are never consumed).  Returns the largest absolute error of
    the fields."""
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
              f" num/den rel err {rel:.3e} (tol {tol:g})", flush=True)
    return worst


def time_pair(kern, plain, reps=200, plain_reps=50):
    """``dict(ms, plain_ms, device_us)``: CUDA-event milliseconds per call
    of a kernel's wrapper and of its plain version, and the wrapper's
    device microseconds per call (torch.profiler)."""
    return dict(ms=cuda_ms(kern, reps), plain_ms=cuda_ms(plain, plain_reps),
                device_us=device_profile(kern, reps)[0])


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
    float64 and float32; float32 times per call."""
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
            times = time_pair(
                lambda: bf.fused_banded_iteration(*args, **kw),
                lambda: bf.banded_fused_plain(*args, **kw))
            times["e"] = args[0].num_edges
            print(f"[banded_fused] float32 mesh V={args[0].num_vertices} "
                  f"E={times['e']} (banded order, padded) l1+pos, per call: "
                  f"kernel {times['ms'] * 1e3:.2f} us "
                  f"({times['device_us']:.2f} us of device time), plain "
                  f"{times['plain_ms'] * 1e3:.2f} us", flush=True)
    return errs, times


def phase_circulant_fused(device="cuda"):
    """``circulant_fused`` against its plain version, one stage from a random
    state, for the four vertex proxes, float64 and float32: on the mesh's
    circulant container (64 families and a banded remainder) and on the
    140 x 140 grid built as a circulant container (2 families, no
    remainder); float32 times per call on the mesh."""
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
                times = time_pair(
                    lambda: cf.fused_circulant_iteration(*args, **kw),
                    lambda: cf.circulant_fused_plain(*args, **kw))
                times.update(f=len(g.offsets), vv=g.vv, rem=g.num_rem)
                print(f"[circulant_fused] float32 mesh l1+pos, per call: "
                      f"kernel {times['ms'] * 1e3:.2f} us "
                      f"({times['device_us']:.2f} us of device time), plain "
                      f"{times['plain_ms'] * 1e3:.2f} us", flush=True)
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
    phase_env()
    import torch
    phase_build()
    st_err, st_rel, st_t = phase_stencil()
    ss_err, ss_t = phase_solve_small()
    mc_err, mc_t = phase_mincut()
    cc_t = phase_components()
    sf_err, sfm = phase_solve_fused()
    crossover()
    sx_err, sx_t = phase_stencil_simplex()
    cps_cut, cps_comp = phase_cp_simplex_kernels()
    bt = phase_banded_transfers()
    bf_err, bf_t = phase_banded_fused()
    cf_err, cf_t = phase_circulant_fused()
    cs_err, cs_t = phase_circulant_simplex()
    # the float64 solves the multi-label and mesh paths are held against,
    # outside the paths' counted windows
    p64 = simplex_reference()
    cp_ref = cp_simplex_reference()
    x_mesh64 = mesh_reference()
    p_mesh64 = mesh_simplex_solve(torch.float64, "cuda", 3000).p.cpu()

    # the main paths: each with the counts set to 0 just before it and read
    # just after; each must have launched the kernels it runs
    launches = dict.fromkeys(counters(), 0)
    paths = (("pfdr", phase_pfdr, (), ("stencil_fused",)),
             ("cp-host", phase_cp, (), ("solve_small", "solve_fused")),
             ("cp-chain", phase_cp_chain, None,
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
              ("circulant_fused_simplex",)))
    f_ref = None
    for name, fn, args, needs in paths:
        reset_counts()
        out = fn(*(args if args is not None else (f_ref,)))
        if name == "cp-host":
            f_ref = out[1]
        counts = read_counts()
        print(f"[{name}] kernel launches: {counts}", flush=True)
        check(all(counts[k] > 0 for k in needs),
              f"{name}: a kernel of the path was not launched: {counts}")
        for k, v in counts.items():
            launches[k] += v
    check(all(v > 0 for v in launches.values()),
          f"a kernel was launched on no main path: {launches}")
    phase_profile()
    profile_mesh()

    v_eeg, f2 = V_SIDE * V_SIDE, 2
    rv_big = max(ss_t["ms"])
    rv_cap, ne, n_rows = ss_t["dims"][rv_big]
    mc = mc_t[(SIDE_524K, torch.float32)]
    cc = cc_t[(SIDE_524K, 0.1)]
    v5 = SIDE_524K * SIDE_524K
    work = {
        "stencil_fused": (4 * (5 * v_eeg + 9 * f2 * v_eeg + 2),
                          22 * f2 * v_eeg + 10 * v_eeg),
        "solve_small": reduced_solve_work(rv_cap, ne, n_rows, 300),
        "mincut_fused": (4 * (4 * v5 + 4 * f2 * v5),
                         mc["it"] * (10 * f2 * v5 + 6 * v5)
                         + mc["it"] // 250 * (15 * (2 * v5 + 3 * f2 * v5)
                                              + 4 * f2 * v5 + 3 * v5)),
        "components_fused": (f2 * v5 + 4 * v5,
                             cc["rounds"] * (4 * f2 + 4) * v5),
        "solve_fused": reduced_solve_work(sfm["args"][5].shape[0],
                                          sfm["args"][8].shape[0],
                                          sfm["args"][1].shape[0], 300),
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
             plain_ms=st_t["plain_ms"],
             shape=f"{V_SIDE}x{V_SIDE} F=2, one PFDR stage"),
        dict(name="solve_small", source="solve_small.cu",
             replaces="solve_small.py:185", max_abs_err=ss_err[
                 torch.float32], max_abs_err_f64=ss_err[torch.float64],
             ms=ss_t["ms"][rv_big], plain_ms=ss_t["plain_ms"][rv_big],
             shape=f"dense, rv={rv_big} rv_cap={rv_cap}, 300 iterations"),
        dict(name="mincut_fused", source="mincut_fused.cu",
             replaces="mincut_fused.py:121",
             max_abs_err=mc_err[(SIDE_524K, torch.float32)],
             max_abs_err_f64=max(v for (_, d), v in mc_err.items()
                                 if d == torch.float64),
             ms=mc["ms"], plain_ms=mc["plain_ms"],
             shape=f"{SIDE_524K}x{SIDE_524K} F=2, one certified cut of "
                   f"{mc['it']} steps", cp_simplex_cut=cps_cut),
        dict(name="components_fused", source="components_fused.cu",
             replaces="components_fused.py:84", max_abs_err=0.0,
             ms=cc["ms"], plain_ms=cc["plain_ms"],
             shape=f"{SIDE_524K}x{SIDE_524K} F=2, 10% active, "
                   f"{cc['rounds']} rounds", cp_simplex_components=cps_comp),
        dict(name="solve_fused", source="solve_fused.cu",
             replaces="solve_fused.py:300", max_abs_err=sf_err[
                 torch.float32], max_abs_err_f64=sf_err[torch.float64],
             main_path_max_abs_err=sfm["err_float32"],
             main_path_max_abs_err_f64=sfm["err_float64"],
             mesh_max_abs_err=sfm["mesh_err_float32"],
             mesh_max_abs_err_f64=sfm["mesh_err_float64"],
             mesh_iterations_f64=sfm["mesh_it_float64"],
             ms=sfm["ms"], plain_ms=sfm["plain_ms"],
             shape=f"dense, rv={sfm['rv']} "
                   f"rv_cap={sfm['args'][5].shape[0]} "
                   f"e={sfm['args'][8].shape[0]} (the host-cut path's first "
                   f"reduced problem), 300 iterations"),
        dict(name="stencil_fused_simplex", source="stencil_fused_simplex.cu",
             replaces="stencil_fused_simplex.py:111",
             max_abs_err=sx_err[torch.float32],
             max_abs_err_f64=sx_err[torch.float64], ms=sx_t["ms"],
             plain_ms=sx_t["plain_ms"], device_us=sx_t["device_us"],
             plain_device_us=sx_t["plain_device_us"],
             shape=f"{V_SIDE}x{V_SIDE} F=2 K={K_SIMPLEX}, one multi-label "
                   f"PFDR iteration"),
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
            star=dict(bt["star"][kern], v=bt["star"]["v"],
                      e=bt["star"]["e"], long_rows=bt["star"]["long_rows"]),
            shape=f"mesh V={v_eeg} E={eb} (banded order, padded), [V] "
                  f"float32"))
    rows += [
        dict(name="banded_fused", source="banded_fused.cu",
             replaces="banded_fused.py:165", max_abs_err=bf_err[f32],
             max_abs_err_f64=bf_err[f64], ms=bf_t["ms"],
             plain_ms=bf_t["plain_ms"], device_us=bf_t["device_us"],
             shape=f"mesh V={v_eeg} E={bf_t['e']} (banded order, padded), "
                   f"one PFDR stage"),
        dict(name="circulant_fused", source="circulant_fused.cu",
             replaces="circulant_fused.py:219",
             max_abs_err=max(cf_err[(gn, f32)] for gn in ("mesh", "grid")),
             max_abs_err_f64=max(cf_err[(gn, f64)]
                                 for gn in ("mesh", "grid")),
             ms=cf_t["ms"], plain_ms=cf_t["plain_ms"],
             device_us=cf_t["device_us"],
             shape=f"mesh F={cf_t['f']} VV={cf_t['vv']} + {cf_t['rem']} "
                   f"remainder slots, one PFDR stage"),
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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
    else:
        main()
