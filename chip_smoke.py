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
8. the main paths, each with the launch counters set to 0 just before it
   and read just after: ``pfdr_quadratic_d1`` on the EEG-scale stencil
   problem (3000 iterations in float32); ``api.cp_quadratic_d1_l1`` on it
   (host cut) in float32, held against the port's own float64 run on the
   CPU; the same problem through ``cut="device"`` and the chained loop
   (``bench.py``'s options), held against the same float64 run; and the
   524k-vertex TV denoising problem of ``bench.py`` through the
   per-iteration device loop, held against its own float64 run on the card;
9. where the time goes (``torch.profiler``).

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
    from cp_pfdr_graph_d1_tpu_torch.ops import (components_fused,
                                                mincut_fused, solve_fused,
                                                solve_small, stencil_fused)
    return {"stencil_fused": stencil_fused.fused_stencil_iteration,
            "solve_small": solve_small.fused_pfdr_solve_small,
            "mincut_fused": mincut_fused.fused_pdhg_min_cut,
            "components_fused": components_fused.fused_components,
            "solve_fused": solve_fused.fused_pfdr_solve}


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
    return errs, main


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

    # the main paths: each with the counts set to 0 just before it and read
    # just after; each must have launched the kernels it runs
    launches = dict.fromkeys(counters(), 0)
    paths = (("pfdr", phase_pfdr, (), ("stencil_fused",)),
             ("cp-host", phase_cp, (), ("solve_small", "solve_fused")),
             ("cp-chain", phase_cp_chain, None,
              ("mincut_fused", "components_fused", "stencil_fused",
               "solve_small")),
             ("cp-device", phase_cp_device, (),
              ("mincut_fused", "components_fused")))
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
    }
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
                   f"{mc['it']} steps"),
        dict(name="components_fused", source="components_fused.cu",
             replaces="components_fused.py:84", max_abs_err=0.0,
             ms=cc["ms"], plain_ms=cc["plain_ms"],
             shape=f"{SIDE_524K}x{SIDE_524K} F=2, 10% active, "
                   f"{cc['rounds']} rounds"),
        dict(name="solve_fused", source="solve_fused.cu",
             replaces="solve_fused.py:300", max_abs_err=sf_err[
                 torch.float32], max_abs_err_f64=sf_err[torch.float64],
             main_path_max_abs_err=sfm["err_float32"],
             main_path_max_abs_err_f64=sfm["err_float64"],
             ms=sfm["ms"], plain_ms=sfm["plain_ms"],
             shape=f"dense, rv={sfm['rv']} "
                   f"rv_cap={sfm['args'][5].shape[0]} "
                   f"e={sfm['args'][8].shape[0]} (the host-cut path's first "
                   f"reduced problem), 300 iterations"),
    ]
    kernels = []
    for row in rows:
        b_ms, b_by = bound(*work[row["name"]])
        kernels.append(dict(
            name=row["name"], route="cuda",
            source="cp_pfdr_graph_d1_tpu_torch/csrc/" + row.pop("source"),
            replaces="cp_pfdr_graph_d1_tpu/ops/" + row.pop("replaces"),
            launches=launches[row["name"]], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, **{k: v for k, v in row.items()
                                if k != "name"}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
