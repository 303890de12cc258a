#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage, from the root of the repository, on a machine with a CUDA device::

    python3 chip_smoke.py

It imports nothing of JAX.  Phases, one or more lines each:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build of the hand-written kernels (``csrc/``) and the host C++ from the
   repository's sources;
3. ``stencil_fused`` against its plain PyTorch version on the 140 x 140,
   F = 2 field of the EEG-scale problem, for the four vertex proxes, in
   float64 and float32, with the time per launch of both;
4. ``solve_small`` against its plain version on reduced problems of that
   problem (its first steepest cut, about 2.6k components, and a 128-block
   partition), for the dense, Gram and diagonal operators;
5. the main path, part 1: ``pfdr_quadratic_d1`` on the EEG-scale stencil
   problem, 3000 iterations in float32 on the card;
6. the main path, part 2: ``api.cp_quadratic_d1_l1`` on the same problem in
   float32 on the card, held against the port's own float64 run on the CPU.

The kernels' launch counters are set to 0 just before phase 5 and read
just after phase 6.  The line before the last is the JSON kernel report;
the last line is the JSON result.  Any failed check raises, and the script
then exits with a non-zero code before printing either.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

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


def device_profile(fn, reps):
    """Device time of ``reps`` calls of ``fn`` from torch.profiler's CUDA
    activity: ``(device us per call, {kernel name: us per call}, host-clock
    us per call of the profiled window)``."""
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
    return sum(per.values()), per, wall


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


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
    from cp_pfdr_graph_d1_tpu_torch import VertexProx
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused as sf
    vproxes = [VertexProx(kind="l1"), VertexProx(kind="l1", positivity=True),
               VertexProx(kind="bounds", lo=-0.5, hi=0.8), VertexProx()]
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
        for vp in vproxes:
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


def small_inputs(kind, cv, rg, dtype, device):
    """Kernel inputs of one reduced problem, prepared as the cut-pursuit
    route prepares them (``_reduce_solve_small``)."""
    import torch
    from cp_pfdr_graph_d1_tpu_torch import GraphD1
    from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
    from cp_pfdr_graph_d1_tpu_torch.operators import DenseOp, DiagOp, GramOp
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as cp
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import (
        bucket, pad_reduced_graph)
    from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import \
        initial_precondition
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
        r_op, op_kind, aty = DiagOp(mat), "diag", ry
    else:
        mat, ry, lip = cp._reduce_dense(t(a), t(y), cv_t, rv_cap,
                                        kind == "gram")
        if kind == "gram":
            r_op, op_kind, aty = GramOp(mat), "gram", ry
        else:
            r_op, op_kind = DenseOp(mat), "dense"
            aty = r_op.apply_t(ry)
    r_la_l1 = np.zeros(rv_cap)
    np.add.at(r_la_l1, cv, LA_L1)
    pre = initial_precondition(r_op, ry, g, t(r_la_l1), 1.5, lip,
                               Lipsch.DIAG)
    x0 = t(np.r_[np.full(num_comp, 0.01), np.zeros(rv_cap - num_comp)])
    z0 = torch.stack([x0[g.eu], x0[g.ev]])
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    return (op_kind, mat.contiguous(), aty, pre.ga, pre.th_l1, x0, z0, ec,
            g.eu, g.ev), num_comp


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
                # float64: early stop on the evolution test, iteration counts
                # compared exactly; float32: a fixed 300 iterations
                if dtype == torch.float64:
                    kw = dict(it_max=3000, dif_tol2=1e-14, eps=1e-7)
                else:
                    kw = dict(it_max=300, dif_tol2=0.0,
                              eps=float(np.finfo(np.float32).eps))
                kw.update(rv=rv, rho=1.5, vkind="l1", positivity=True,
                          lo=-np.inf, hi=np.inf)
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


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_env()
    import torch
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small as ss
    from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused as sf
    phase_build()
    st_err, st_rel, st_t = phase_stencil()
    ss_err, ss_t = phase_solve_small()

    sf.fused_stencil_iteration.launches = 0
    ss.fused_pfdr_solve_small.launches = 0
    phase_pfdr()
    phase_cp()
    launches = (sf.fused_stencil_iteration.launches,
                ss.fused_pfdr_solve_small.launches)
    check(all(n > 0 for n in launches),
          f"a kernel of the main path was not launched: {launches}")
    phase_profile()

    rv_big = max(ss_t["ms"])
    report = {"kernels": [
        {"name": "stencil_fused", "route": "cuda",
         "source": "cp_pfdr_graph_d1_tpu_torch/csrc/stencil_fused.cu",
         "replaces": "cp_pfdr_graph_d1_tpu/ops/stencil_fused.py:105",
         "launches": launches[0],
         "max_abs_err": st_err[torch.float32],
         "max_abs_err_f64": st_err[torch.float64],
         "sums_max_rel_err": st_rel[torch.float32],
         "sums_max_rel_err_f64": st_rel[torch.float64],
         "ms": st_t["ms"], "plain_ms": st_t["plain_ms"]},
        {"name": "solve_small", "route": "cuda",
         "source": "cp_pfdr_graph_d1_tpu_torch/csrc/solve_small.cu",
         "replaces": "cp_pfdr_graph_d1_tpu/ops/solve_small.py:185",
         "launches": launches[1],
         "max_abs_err": ss_err[torch.float32],
         "max_abs_err_f64": ss_err[torch.float64],
         "ms": ss_t["ms"][rv_big], "plain_ms": ss_t["plain_ms"][rv_big],
         "shape": f"dense, rv={rv_big}, 300 iterations"},
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
