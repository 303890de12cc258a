"""One multi-label PFDR iteration on a stencil field of K label planes: the
hand-written Hopper kernel ``csrc/stencil_fused_simplex.cu`` and its plain
PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.stencil_fused_simplex``
(``fused_stencil_simplex_iteration``): loss gradient, forward step,
per-(family, label) d1 prox with relaxation, weighted average, Michelot
simplex projection in the metric and the stopping sum, in one launch.

:func:`fused_stencil_simplex_iteration` launches the CUDA kernel for tensors
on a CUDA device and runs :func:`stencil_simplex_iteration_plain` for
tensors on the CPU; there is no other fallback.  Each launch adds one to
``fused_stencil_simplex_iteration.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .stencil_fused import MAX_FAMILIES

# must equal kMaxLabels in csrc/stencil_fused_simplex.cu
MAX_LABELS = 32

_FIELDS = ("p", "q", "la_f", "ga", "ga_proj", "prev", "zu", "zv", "wu", "wv",
           "w_d1u", "w_d1v", "th_d1")


def _roll3(x, dy: int, dx: int):
    """Circular shift of every plane of [n, H, W], moving (i, j) to
    (i + dy, j + dx)."""
    return torch.roll(x, (dy, dx), dims=(1, 2))


def stencil_simplex_iteration_plain(p, q, la_f, ga, ga_proj, prev, zu, zv,
                                    wu, wv, w_d1u, w_d1v, th_d1, *,
                                    shifts: Tuple, rho: float, al: float,
                                    has_laf: bool, label_mode: bool):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_stencil_simplex_iteration`), written as the JAX package's
    Pallas kernel body is."""
    k = p.shape[0]
    # loss gradient (see solvers.pfdr_simplex._loss_grad)
    if al == 0.0:
        g = -q
    else:
        if al == 1.0:
            g = p - q
        else:
            al_k = al / k
            al_1 = 1.0 - al
            g = -al_1 * (al_k + al_1 * q) / (al_k + al_1 * p)
        if has_laf:
            g = g * la_f[0]
    fp = 2.0 * p - ga * g
    acc = torch.zeros_like(p)
    zu_out, zv_out = [], []
    for f, (dy, dx) in enumerate(shifts):
        fpv = _roll3(fp, -dy, -dx)
        pv = _roll3(p, -dy, -dx)
        au = fp - zu[f]
        av = fpv - zv[f]
        avg = w_d1u[f] * au + w_d1v[f] * av
        diff = au - av
        shrunk = torch.sign(diff) * torch.clamp(diff.abs() - th_d1[f], min=0)
        zuf = zu[f] + rho * ((avg + w_d1v[f] * shrunk) - p)
        zvf = zv[f] + rho * ((avg - w_d1u[f] * shrunk) - pv)
        zu_out.append(zuf)
        zv_out.append(zvf)
        acc = acc + wu[f] * zuf
        acc = acc + _roll3(wv[f] * zvf, dy, dx)
    # Michelot simplex projection in the metric ga_proj, K passes, the label
    # sums in the kernel's order
    one = torch.ones((), dtype=p.dtype, device=p.device)
    active = torch.ones_like(acc)
    la = torch.zeros_like(acc[0])
    for _ in range(k):
        sx = acc[0] * active[0]
        sm = ga_proj[0] * active[0]
        for c in range(1, k):
            sx = sx + acc[c] * active[c]
            sm = sm + ga_proj[c] * active[c]
        la = (sx - 1.0) / torch.where(sm > 0, sm, one)
        active = active * (acc - la * ga_proj > 0).to(acc.dtype)
    pn = torch.clamp(acc - la * ga_proj, min=0)
    if label_mode:
        best = pn[0]
        lab = torch.zeros_like(pn[0])
        for c in range(1, k):
            better = pn[c] > best
            best = torch.where(better, pn[c], best)
            lab = torch.where(better, torch.full_like(lab, float(c)), lab)
        dif = (lab != prev[0]).to(p.dtype).sum()
        prev_new = lab[None]
    else:
        s = (pn[0] - prev[0]).abs()
        for c in range(1, k):
            s = s + (pn[c] - prev[c]).abs()
        dif = s.sum()
        prev_new = pn
    return pn, prev_new, torch.stack(zu_out), torch.stack(zv_out), dif


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_simplex_declared", False):
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("cp_stencil_simplex_f32", "cp_stencil_simplex_f64"):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = [ptr] * 19 + [i, i, i, i, ptr, d, d, i, i, ptr]
        lib.cp_stencil_simplex_partials_len.restype = i
        lib.cp_stencil_simplex_partials_len.argtypes = [i, i]
        lib.cp_stencil_simplex_max_labels.restype = i
        lib.cp_stencil_simplex_max_labels.argtypes = []
        if lib.cp_stencil_simplex_max_labels() != MAX_LABELS:
            raise RuntimeError("MAX_LABELS disagrees with the CUDA source")
        lib._cp_simplex_declared = True
    return lib


def _check(arrays, shifts, label_mode):
    p = arrays[0]
    if p.ndim != 3:
        raise ValueError(f"p must be [K, H, W], got {tuple(p.shape)}")
    k, h, w = p.shape
    f = len(shifts)
    if not 1 <= f <= MAX_FAMILIES:
        raise ValueError(f"{f} shift families; the kernel takes 1.."
                         f"{MAX_FAMILIES}")
    if not 1 <= k <= MAX_LABELS:
        raise ValueError(f"{k} labels; the stencil_fused_simplex kernel "
                         f"takes 1..{MAX_LABELS}")
    if p.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {p.dtype}")
    shapes = {"la_f": (1, h, w), "prev": (1 if label_mode else k, h, w)}
    for name, a in zip(_FIELDS, arrays):
        want = shapes.get(name, (k, h, w) if name in _FIELDS[:6]
                          else (f, k, h, w))
        if tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{want}")
        if a.dtype != p.dtype or a.device != p.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                             f"{p.dtype} on {p.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def fused_stencil_simplex_iteration(p, q, la_f, ga, ga_proj, prev, zu, zv,
                                    wu, wv, w_d1u, w_d1v, th_d1, *,
                                    shifts: Tuple, rho: float, al: float,
                                    has_laf: bool, label_mode: bool):
    """One fused multi-label PFDR step.

    Args:
      p, q, ga, ga_proj: [K, H, W] label planes.
      la_f: [1, H, W] per-vertex loss weights (ignored unless has_laf).
      prev: [K, H, W] previous iterate, or [1, H, W] previous
        maximum-likelihood labels (label_mode).
      zu, zv, wu, wv, w_d1u, w_d1v, th_d1: [F, K, H, W] per-(family, label)
        edge planes.
      shifts: ((dy, dx), ...) of the F shift families.
      rho: relaxation parameter; al: loss selector (0 linear, 1 quadratic,
        in ]0, 1[ smoothed KL).

    Returns:
      ``(p_new, prev_new, zu_new, zv_new, dif_sum)``; ``dif_sum`` (0-d) is
      the changed-label count (label_mode) or ``sum |p_new - prev|`` (the
      caller divides by the vertex count).
    """
    arrays = (p, q, la_f, ga, ga_proj, prev, zu, zv, wu, wv, w_d1u, w_d1v,
              th_d1)
    kw = dict(shifts=shifts, rho=rho, al=al, has_laf=has_laf,
              label_mode=label_mode)
    if not p.is_cuda:
        return stencil_simplex_iteration_plain(*arrays, **kw)
    _check(arrays, shifts, label_mode)
    lib = _lib()
    k, h, w = p.shape
    po = torch.empty_like(p)
    prevo = torch.empty_like(prev)
    zuo = torch.empty_like(zu)
    zvo = torch.empty_like(zv)
    partials = torch.empty(lib.cp_stencil_simplex_partials_len(h, w),
                           dtype=p.dtype, device=p.device)
    dif = torch.empty((), dtype=p.dtype, device=p.device)
    flat = [int(v) for dydx in shifts for v in dydx]
    shifts_c = (ctypes.c_int * len(flat))(*flat)
    fn = (lib.cp_stencil_simplex_f32 if p.dtype == torch.float32
          else lib.cp_stencil_simplex_f64)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[a.data_ptr() for a in arrays], po.data_ptr(),
                prevo.data_ptr(), zuo.data_ptr(), zvo.data_ptr(),
                partials.data_ptr(), dif.data_ptr(), h, w, k, len(shifts),
                shifts_c, float(rho), float(al), int(has_laf),
                int(label_mode), stream)
    if rc != 0:
        raise RuntimeError(f"stencil_fused_simplex launch failed (CUDA "
                           f"error {rc})")
    fused_stencil_simplex_iteration.launches += 1
    return po, prevo, zuo, zvo, dif


fused_stencil_simplex_iteration.launches = 0
