"""One PFDR edge + vertex stage on a stencil field: the hand-written Hopper
kernel ``csrc/stencil_fused.cu`` and its plain PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.stencil_fused``
(``fused_stencil_iteration``).  :func:`fused_stencil_iteration` launches the
CUDA kernel for tensors on a CUDA device and runs
:func:`stencil_iteration_plain` for tensors on the CPU; there is no other
fallback.  Each launch adds one to ``fused_stencil_iteration.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .prox import vertex_prox_plain

# must equal kMaxFamilies in csrc/stencil_fused.cu
MAX_FAMILIES = 16

_VKIND = {"none": 0, "l1": 1, "bounds": 2}
_FIELDS = ("x", "grad", "ga", "th_l1", "zu", "zv", "wu", "wv", "w_d1u",
           "w_d1v", "th_d1")


def _roll2(x, dy: int, dx: int):
    """Circular shift moving element (i, j) to (i + dy, j + dx)."""
    return torch.roll(x, (dy, dx), dims=(0, 1))


def stencil_iteration_plain(x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u,
                            w_d1v, th_d1, *, shifts: Tuple, rho: float,
                            vkind: str, positivity: bool, lo: float,
                            hi: float):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_stencil_iteration`), written as the JAX package's Pallas
    kernel body is."""
    p = 2.0 * x - ga * grad
    acc = torch.zeros_like(x)
    zu_out, zv_out = [], []
    for f, (dy, dx) in enumerate(shifts):
        pv = _roll2(p, -dy, -dx)
        xv = _roll2(x, -dy, -dx)
        au = p - zu[f]
        av = pv - zv[f]
        avg = w_d1u[f] * au + w_d1v[f] * av
        diff = au - av
        shrunk = torch.sign(diff) * torch.clamp(diff.abs() - th_d1[f], min=0)
        zuf = zu[f] + rho * ((avg + w_d1v[f] * shrunk) - x)
        zvf = zv[f] + rho * ((avg - w_d1u[f] * shrunk) - xv)
        zu_out.append(zuf)
        zv_out.append(zvf)
        acc = acc + wu[f] * zuf
        acc = acc + _roll2(wv[f] * zvf, dy, dx)
    xn = vertex_prox_plain(acc, th_l1, vkind, positivity, lo, hi)
    delta = xn - x
    return (xn, torch.stack(zu_out), torch.stack(zv_out),
            (delta * delta).sum(), (xn * xn).sum())


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_stencil_declared", False):
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("cp_stencil_fused_f32", "cp_stencil_fused_f64"):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = ([ptr] * 16 + [i, i, i, ptr, d, i, i, d, d, ptr])
        lib.cp_stencil_partials_len.restype = i
        lib.cp_stencil_partials_len.argtypes = [i, i]
        lib.cp_stencil_max_families.restype = i
        lib.cp_stencil_max_families.argtypes = []
        if lib.cp_stencil_max_families() != MAX_FAMILIES:
            raise RuntimeError("MAX_FAMILIES disagrees with the CUDA source")
        lib._cp_stencil_declared = True
    return lib


def _check(arrays, shifts, vkind):
    x = arrays[0]
    if x.ndim != 2:
        raise ValueError(f"x must be [H, W], got {tuple(x.shape)}")
    h, w = x.shape
    f = len(shifts)
    if not 1 <= f <= MAX_FAMILIES:
        raise ValueError(f"{f} shift families; the kernel takes 1.."
                         f"{MAX_FAMILIES}")
    if vkind not in _VKIND:
        raise ValueError(f"unknown vertex prox {vkind!r}")
    for name, a in zip(_FIELDS, arrays):
        want = (h, w) if name in ("x", "grad", "ga", "th_l1") else (f, h, w)
        if tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{want}")
        if a.dtype != x.dtype or a.device != x.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                             f"{x.dtype} on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {x.dtype}")


def fused_stencil_iteration(x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u,
                            w_d1v, th_d1, *, shifts: Tuple, rho: float,
                            vkind: str, positivity: bool, lo: float,
                            hi: float):
    """One fused edge+vertex PFDR step on an (H, W) field.

    Args:
      x, grad, ga, th_l1: [H, W] vertex fields.
      zu, zv, wu, wv, w_d1u, w_d1v, th_d1: [F, H, W] per-family edge fields.
      shifts: ((dy, dx), ...) of the F shift families.
      rho: relaxation parameter.
      vkind / positivity / lo / hi: vertex-prox description.

    Returns:
      (x_new [H, W], zu_new, zv_new [F, H, W], num, den) where num/den are
      the squared evolution and squared norm of the new iterate (0-d).
    """
    arrays = (x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v, th_d1)
    if not x.is_cuda:
        return stencil_iteration_plain(
            *arrays, shifts=shifts, rho=rho, vkind=vkind,
            positivity=positivity, lo=lo, hi=hi)
    _check(arrays, shifts, vkind)
    lib = _lib()
    h, w = x.shape
    xo = torch.empty_like(x)
    zuo = torch.empty_like(zu)
    zvo = torch.empty_like(zv)
    partials = torch.empty(lib.cp_stencil_partials_len(h, w),
                           dtype=x.dtype, device=x.device)
    sums = torch.empty(2, dtype=x.dtype, device=x.device)
    flat = [int(v) for dydx in shifts for v in dydx]
    shifts_c = (ctypes.c_int * len(flat))(*flat)
    fn = (lib.cp_stencil_fused_f32 if x.dtype == torch.float32
          else lib.cp_stencil_fused_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[a.data_ptr() for a in arrays], xo.data_ptr(),
                zuo.data_ptr(), zvo.data_ptr(), partials.data_ptr(),
                sums.data_ptr(), h, w, len(shifts), shifts_c, float(rho),
                _VKIND[vkind], int(positivity), float(lo), float(hi),
                stream)
    if rc != 0:
        raise RuntimeError(f"stencil_fused launch failed (CUDA error {rc})")
    fused_stencil_iteration.launches += 1
    return xo, zuo, zvo, sums[0], sums[1]


fused_stencil_iteration.launches = 0
