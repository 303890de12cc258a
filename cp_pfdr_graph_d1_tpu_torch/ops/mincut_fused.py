"""A whole certified PDHG min-cut on a stencil graph: the hand-written
Hopper kernel ``csrc/mincut_fused.cu`` and its plain PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.mincut_fused``
(``fused_pdhg_min_cut``, ``device_cut_stencil_fused``).  The TPU kernel held
every field in VMEM and admitted fields of at most 12 MB; the Hopper kernel
keeps them in global memory and synchronises its grid between half-steps,
so it takes any field size (the 724 x 724 grid of the device cut-pursuit
problem included).

:func:`fused_pdhg_min_cut` launches the kernel for tensors on a CUDA device
and runs :func:`pdhg_min_cut_plain` for tensors on the CPU; there is no
other fallback.  Each launch adds one to ``fused_pdhg_min_cut.launches``.
Out-of-range stencil slots carry zero weight, so their circular wrap-around
is inert (``sigma = 0`` keeps their dual at its start and ``w z = 0`` drops
them from the adjoint), as in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .stencil_fused import MAX_FAMILIES, _roll2

THRESHOLDS = 15    # cut candidates per certificate (coarea levels)
_THREADS = 256     # kCutThreads of the CUDA source
_MAX_BLOCKS = 4096


def thresholds(dtype, device):
    """The coarea levels ``linspace(0.03, 0.97, 15)`` of the certificate."""
    return torch.linspace(0.03, 0.97, THRESHOLDS, dtype=dtype, device=device)


def _adjoint(w, z, shifts):
    """``(K^t z)`` on the field: ``sum_f w z[f] - roll(w z[f], shift_f)``."""
    acc = torch.zeros_like(w[0])
    for k, (dy, dx) in enumerate(shifts):
        wz = w[k] * z[k]
        acc = acc + wz - _roll2(wz, dy, dx)
    return acc


def pdhg_min_cut_plain(w, c, tau, sigma, x0, z0, tol, it_max: int, *,
                       shifts: Tuple, check_every: int):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_pdhg_min_cut`), written as the JAX package's Pallas kernel
    body is."""
    ts = thresholds(x0.dtype, x0.device)
    sw = [sigma[k] * w[k] for k in range(len(shifts))]
    x, xb, z = x0.clone(), x0.clone(), z0.clone()
    it = 0
    gap = torch.tensor(float("inf"), dtype=x0.dtype, device=x0.device)
    t_best = ts[0]
    while it < it_max and bool(gap > tol):
        for _ in range(check_every):
            z = torch.stack([
                torch.clamp(z[k] + sw[k] * (xb - _roll2(xb, -dy, -dx)), -1, 1)
                for k, (dy, dx) in enumerate(shifts)])
            x_new = torch.clamp(x - tau * (_adjoint(w, z, shifts) + c), 0, 1)
            xb = 2 * x_new - x
            x = x_new
        dual = torch.clamp(c + _adjoint(w, z, shifts), max=0).sum()
        side = x[None] > ts[:, None, None]                  # [T, H, W]
        vals = torch.where(side, c, 0).sum(dim=(1, 2))
        for k, (dy, dx) in enumerate(shifts):
            cut = side != torch.roll(side, (-dy, -dx), dims=(1, 2))
            vals = vals + torch.where(cut, w[k], 0).sum(dim=(1, 2))
        best = int(torch.argmin(vals))
        gap = vals[best] - dual
        t_best = ts[best]
        it += check_every
    return (x, z, gap, t_best,
            torch.tensor(it, dtype=torch.int32, device=x0.device))


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_mincut_declared", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        for name in ("cp_mincut_fused_f32", "cp_mincut_fused_f64"):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = ([ptr] * 12 + [i] + [ptr] * 3 + [i, i, i, ptr, i,
                                                           i, ptr])
        lib.cp_mincut_sums.restype = i
        lib.cp_mincut_sums.argtypes = []
        if lib.cp_mincut_sums() != THRESHOLDS + 1:
            raise RuntimeError("THRESHOLDS disagrees with the CUDA source")
        lib._cp_mincut_declared = True
    return lib


def _check(w, vertex_fields, edge_fields, tol, shifts):
    x0 = vertex_fields[0]
    if x0.ndim != 2:
        raise ValueError(f"x0 must be [H, W], got {tuple(x0.shape)}")
    h, wd = x0.shape
    f = len(shifts)
    if not 1 <= f <= MAX_FAMILIES:
        raise ValueError(f"{f} shift families; the kernel takes 1.."
                         f"{MAX_FAMILIES}")
    if x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not "
                         f"{x0.dtype}")
    named = ([(f"vertex field {k}", a, (h, wd))
              for k, a in enumerate(vertex_fields)]
             + [(f"edge field {k}", a, (f, h, wd))
                for k, a in enumerate(edge_fields)]
             + [("tol", tol, ())])
    for name, a, want in named:
        if tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{want}")
        if a.dtype != x0.dtype or a.device != x0.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                             f"{x0.dtype} on {x0.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def fused_pdhg_min_cut(w, c, tau, sigma, x0, z0, tol, it_max: int, *,
                       shifts: Tuple, check_every: int):
    """Complete PDHG min-cut of ``min <c, x> + sum_e w_e |x_u - x_v|`` over
    ``[0, 1]^V``.

    Args:
      w: [F, H, W] edge weights (0 = absent, masked and padded slots too).
      c: [H, W] unary costs (clipped finite).
      tau, sigma: [H, W] / [F, H, W] preconditioned step sizes.
      x0, z0: warm starts ([H, W], [F, H, W]).
      tol: 0-d tensor, the absolute duality-gap certificate.
      it_max: step cap (the loop runs whole chunks of ``check_every``).
      shifts: ((dy, dx), ...) of the F shift families.

    Returns:
      ``(x [H, W], z [F, H, W], gap, t_best, it)``, the last three 0-d
      tensors; the cut is ``x > t_best``.
    """
    if not x0.is_cuda:
        return pdhg_min_cut_plain(w, c, tau, sigma, x0, z0, tol, it_max,
                                  shifts=shifts, check_every=check_every)
    _check(w, (x0, c, tau), (w, sigma, z0), tol, shifts)
    if check_every < 1:
        raise ValueError(f"check_every must be positive, got {check_every}")
    lib = _lib()
    h, wd = x0.shape
    ts = thresholds(x0.dtype, x0.device)
    x = torch.empty_like(x0)
    xb = torch.empty_like(x0)
    z = torch.empty_like(z0)
    max_blocks = min(-(-h * wd // _THREADS), _MAX_BLOCKS)
    partials = torch.empty(max_blocks * (THRESHOLDS + 1), dtype=x0.dtype,
                           device=x0.device)
    gap = torch.empty((), dtype=x0.dtype, device=x0.device)
    t_best = torch.empty((), dtype=x0.dtype, device=x0.device)
    it = torch.empty((), dtype=torch.int32, device=x0.device)
    flat = [int(v) for dydx in shifts for v in dydx]
    shifts_c = (ctypes.c_int * len(flat))(*flat)
    fn = (lib.cp_mincut_fused_f32 if x0.dtype == torch.float32
          else lib.cp_mincut_fused_f64)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(w.data_ptr(), c.data_ptr(), tau.data_ptr(), sigma.data_ptr(),
                x0.data_ptr(), z0.data_ptr(), ts.data_ptr(), tol.data_ptr(),
                x.data_ptr(), xb.data_ptr(), z.data_ptr(),
                partials.data_ptr(), max_blocks, gap.data_ptr(),
                t_best.data_ptr(), it.data_ptr(), h, wd, len(shifts),
                shifts_c, int(it_max), int(check_every), stream)
    if rc != 0:
        raise RuntimeError(f"mincut_fused launch failed (CUDA error {rc})")
    fused_pdhg_min_cut.launches += 1
    return x, z, gap, t_best, it


fused_pdhg_min_cut.launches = 0


def cut_problem(graph, wts, cost, tol_rel: float, x0=None, z0=None):
    """Arguments of :func:`fused_pdhg_min_cut` for one cut on a stencil
    graph with edge weights ``wts`` [E] (zero for absent edges): the
    preconditioning, cost clipping and certificate scale of
    ``solvers/cut_pursuit_device._device_cut``.  Returns ``(args, big)``,
    ``args`` the seven arguments before ``it_max`` and ``big`` the cost
    scale (a 0-d tensor); the certificate is ``args[6] = tol_rel * big``."""
    h, wd = graph.field_shape
    f = len(graph.shifts)
    dtype = wts.dtype
    fin = torch.isfinite(cost)
    big = 1.0 + 2.0 * (wts.sum() + torch.where(fin, cost.abs(), 0.0).sum())
    c_cl = torch.clamp(torch.where(fin, cost, big), -big, big).to(dtype)
    deg_w = graph.vertex_degree_weighted(wts)
    tau = torch.where(deg_w > 0, 1.0 / torch.clamp(deg_w, min=1e-30),
                      1.0 / torch.clamp(c_cl.abs(), min=1e-12))
    sigma = torch.where(wts > 0, 0.5 / torch.clamp(wts, min=1e-30), 0.0)
    if x0 is None:
        x0 = torch.full((graph.num_vertices,), 0.5, dtype=dtype,
                        device=wts.device)
    if z0 is None:
        z0 = torch.zeros(graph.num_edges, dtype=dtype, device=wts.device)
    args = (wts.reshape(f, h, wd), c_cl.reshape(h, wd), tau.reshape(h, wd),
            sigma.reshape(f, h, wd), x0.reshape(h, wd).contiguous(),
            z0.reshape(f, h, wd).contiguous(), (tol_rel * big).to(dtype))
    return args, big


def device_cut_stencil_fused(graph, active, cost, tol_rel: float,
                             it_max: int, check_every: int, x0=None,
                             z0=None):
    """One steepest cut on a stencil graph, active edges weight-masked out
    (:func:`cut_problem`, then :func:`fused_pdhg_min_cut`).  Returns
    ``(sep [E] bool, gap, big, x [V], z [E])`` with ``gap`` and ``big``
    0-d tensors."""
    args, big = cut_problem(graph, torch.where(active, 0.0, graph.la_d1),
                            cost, tol_rel, x0, z0)
    x, z, gap, t_best, _ = fused_pdhg_min_cut(
        *args, it_max, shifts=graph.shifts, check_every=check_every)
    x = x.reshape(-1)
    z = z.reshape(-1)
    su, sv = graph.gather_endpoints(x > t_best)
    sep = (su != sv) & ~active & (graph.la_d1 > 0)
    return sep, gap, big, x, z
