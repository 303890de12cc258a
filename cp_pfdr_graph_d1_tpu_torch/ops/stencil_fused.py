"""One PFDR edge + vertex stage on a stencil field: the hand-written Hopper
kernel ``csrc/stencil_fused.cu`` and its plain PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.stencil_fused``
(``fused_stencil_iteration``).  :func:`fused_stencil_iteration` launches the
CUDA kernel for tensors on a CUDA device and runs
:func:`stencil_iteration_plain` for tensors on the CPU; there is no other
fallback.  The kernel runs a thread a vertex in one launch
(:func:`blocks`).  A launch goes through a plan (shifts, partials and the
ticket that elects the block ending the sums), checked once and kept by the
caller: on the graph (:meth:`..stencil.StencilGraphD1.fused_iteration`,
``graph._stage_plans``) or, for the standalone wrapper, in this module.
Each launch adds one to ``fused_stencil_iteration.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import banded
from .banded_fused import run_stage, stage_key
from .prox import vertex_prox_plain

# kMaxFamilies and kVertexBlock of the CUDA sources
MAX_FAMILIES = 16
VERTEX_BLOCK = 128

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


def blocks(h: int, w: int) -> int:
    """Blocks of a launch on an (H, W) field: thread ``t`` of block ``b``
    takes the cell ``b VERTEX_BLOCK + t`` (row-major) when it lies in the
    field; 154 blocks at 140 x 140, more than the H100's 132 SMs."""
    return -(-h * w // VERTEX_BLOCK)


class _Plan(ctypes.Structure):
    """``StencilPlan`` of ``csrc/stencil_fused.cu``."""
    _fields_ = ([("partials", ctypes.c_void_p), ("ticket", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("h", "w", "nf", "device")]
                + [("dy", ctypes.c_int * MAX_FAMILIES),
                   ("dx", ctypes.c_int * MAX_FAMILIES)]
                + [(n, ctypes.c_double) for n in ("rho", "lo", "hi")]
                + [("vkind", ctypes.c_int), ("positivity", ctypes.c_int)])


@functools.cache
def _lib():
    """The kernels' library (:func:`.banded._lib`) with the entries
    declared and the constants mirrored here checked against the CUDA
    source."""
    lib = banded._lib()
    ptr = ctypes.c_void_p
    for t in ("f32", "f64"):
        fn = getattr(lib, f"cp_stencil_fused_{t}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 16
    lib.cp_stencil_plan_size.restype = ctypes.c_int
    lib.cp_stencil_plan_size.argtypes = []
    lib.cp_stencil_shape.restype = None
    lib.cp_stencil_shape.argtypes = [ptr]
    shape = (ctypes.c_int * 2)()
    lib.cp_stencil_shape(shape)
    if (lib.cp_stencil_plan_size() != ctypes.sizeof(_Plan)
            or tuple(shape) != (MAX_FAMILIES, VERTEX_BLOCK)):
        raise RuntimeError("ops/stencil_fused.py disagrees with "
                           "csrc/stencil_fused.cu")
    return lib


def _check(arrays, shifts, vkind, field_shape=None):
    """Raises on stage fields the kernel does not take: [H, W] vertex
    fields and [F, H, W] edge fields (or, given ``field_shape`` (H, W), the
    same flattened: [V] and [F V]), one float type on one device,
    contiguous."""
    x = arrays[0]
    if field_shape is None:
        if x.ndim != 2:
            raise ValueError(f"x must be [H, W], got {tuple(x.shape)}")
        field_shape = tuple(x.shape)
    h, w = field_shape
    f = len(shifts)
    if not 1 <= f <= MAX_FAMILIES:
        raise ValueError(f"{f} shift families; the kernel takes 1.."
                         f"{MAX_FAMILIES}")
    if vkind not in _VKIND:
        raise ValueError(f"unknown vertex prox {vkind!r}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {x.dtype}")
    for name, a in zip(_FIELDS, arrays):
        vertex = name in ("x", "grad", "ga", "th_l1")
        if x.ndim == 1:
            want = (h * w,) if vertex else (f * h * w,)
        else:
            want = (h, w) if vertex else (f, h, w)
        if tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{want}")
        if a.dtype != x.dtype or a.device != x.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                             f"{x.dtype} on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _make_plan(plans, key, field_shape, shifts, fields, rho, vkind,
               positivity, lo, hi):
    """Checks the fields once for ``key`` and prepares the launch:
    ``(C function, plan address, device index, the plan and its
    buffers)``, kept in ``plans``."""
    _check(fields, shifts, vkind, field_shape)
    lib = _lib()
    x = fields[0]
    h, w = field_shape
    partials = x.new_empty(2 * blocks(h, w))
    ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
    f = len(shifts)
    pad = [0] * (MAX_FAMILIES - f)
    plan = _Plan(partials.data_ptr(), ticket.data_ptr(), h, w, f,
                 x.device.index,
                 (ctypes.c_int * MAX_FAMILIES)(*[s[0] for s in shifts], *pad),
                 (ctypes.c_int * MAX_FAMILIES)(*[s[1] for s in shifts], *pad),
                 float(rho), float(lo), float(hi), _VKIND[vkind],
                 int(positivity))
    sfx = "f32" if x.dtype == torch.float32 else "f64"
    entry = (getattr(lib, f"cp_stencil_fused_{sfx}"), ctypes.addressof(plan),
             x.device.index, (plan, partials, ticket))
    plans[key] = entry
    return entry


def fused_stage(plans, field_shape, shifts, fields, *, rho: float,
                vkind: str, positivity: bool, lo: float, hi: float):
    """The kernel's stage on CUDA ``fields`` (as :func:`fused_stencil_iteration`
    takes them, or flattened: [V] and [F V]) through the plan kept in the
    dict ``plans``: ``(x_new [V], zu_new, zv_new [F V], num, den)``.  The
    checks run once per (fields' dtypes, shapes and devices, shifts, stage
    constants).  Two streams must not run a stage through one plan at once:
    they would share its ticket and partials."""
    key = (stage_key(fields, rho, vkind, positivity, lo, hi), shifts)
    entry = plans.get(key)
    if entry is None:
        entry = _make_plan(plans, key, field_shape, shifts, fields, rho,
                           vkind, positivity, lo, hi)
    fn, plan, index, _ = entry
    nv = field_shape[0] * field_shape[1]
    out = run_stage(fn, plan, index, nv, len(shifts) * nv, fields,
                    "stencil_fused")
    fused_stencil_iteration.launches += 1
    return out


_plans: dict = {}


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
    if x.ndim != 2:
        raise ValueError(f"x must be [H, W], got {tuple(x.shape)}")
    shifts = tuple((int(dy), int(dx)) for dy, dx in shifts)
    xn, zun, zvn, num, den = fused_stage(
        _plans, tuple(x.shape), shifts, arrays, rho=rho, vkind=vkind,
        positivity=positivity, lo=lo, hi=hi)
    return (xn.view(x.shape), zun.view(zu.shape), zvn.view(zv.shape), num,
            den)


fused_stencil_iteration.launches = 0
