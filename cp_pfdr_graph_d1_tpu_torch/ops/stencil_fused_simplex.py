"""One multi-label PFDR iteration on a stencil field of K label planes: the
hand-written Hopper kernel ``csrc/stencil_fused_simplex.cu`` and its plain
PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.stencil_fused_simplex``
(``fused_stencil_simplex_iteration``): loss gradient, forward step,
per-(family, label) d1 prox with relaxation, weighted average, Michelot
simplex projection in the metric and the stopping sum, in one launch.

:func:`fused_stencil_simplex_iteration` launches the CUDA kernel for tensors
on a CUDA device and runs :func:`stencil_simplex_iteration_plain` for
tensors on the CPU; there is no other fallback.  The kernel runs a thread a
(cell, label) (:func:`launch_shape`).  A launch goes through a plan (shifts,
stage constants, partials and the ticket that elects the block ending the
sum), checked once and kept by the caller: on the graph
(:meth:`..stencil.StencilGraphD1.fused_simplex_iteration`,
``graph._simplex_plans``) or, for the standalone wrapper, in this module.
Each launch adds one to ``fused_stencil_simplex_iteration.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import operator
from typing import Tuple

import torch

from . import banded
from .stencil_fused import MAX_FAMILIES

# kMaxLabels and kMaxSimplexThreads of csrc/stencil_fused_simplex.cu
MAX_LABELS = 32
MAX_THREADS = 1024

_FIELDS = ("p", "q", "la_f", "ga", "ga_proj", "prev", "zu", "zv", "wu", "wv",
           "w_d1u", "w_d1v", "th_d1")


def _roll3(x, dy: int, dx: int):
    """Circular shift of every plane of [n, H, W], moving (i, j) to
    (i + dy, j + dx)."""
    return torch.roll(x, (dy, dx), dims=(1, 2))


def simplex_forward_plain(p, q, la_f, ga, *, al: float, has_laf: bool):
    """Forward step ``2 p - Gamma g`` on label planes (label axis first;
    ``la_f`` a single plane), with the loss gradient of
    ``solvers.pfdr_simplex._loss_grad``."""
    k = p.shape[0]
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
    return 2.0 * p - ga * g


def simplex_tail_plain(acc, ga_proj, prev, *, label_mode: bool):
    """Michelot simplex projection of the averaged label planes ``acc`` in
    the metric ``ga_proj`` (K passes, the label sums in the kernels' order)
    and the stopping sum: ``(p_new, prev_new, dif_sum)``."""
    k = acc.shape[0]
    one = torch.ones((), dtype=acc.dtype, device=acc.device)
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
        return pn, lab[None], (lab != prev[0]).to(acc.dtype).sum()
    s = (pn[0] - prev[0]).abs()
    for c in range(1, k):
        s = s + (pn[c] - prev[c]).abs()
    return pn, pn, s.sum()


def stencil_simplex_iteration_plain(p, q, la_f, ga, ga_proj, prev, zu, zv,
                                    wu, wv, w_d1u, w_d1v, th_d1, *,
                                    shifts: Tuple, rho: float, al: float,
                                    has_laf: bool, label_mode: bool):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_stencil_simplex_iteration`), written as the JAX package's
    Pallas kernel body is."""
    fp = simplex_forward_plain(p, q, la_f, ga, al=al, has_laf=has_laf)
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
    pn, prev_new, dif = simplex_tail_plain(acc, ga_proj, prev,
                                           label_mode=label_mode)
    return pn, prev_new, torch.stack(zu_out), torch.stack(zv_out), dif


def launch_shape(h: int, w: int, k: int):
    """``(cells, threads, blocks)`` of a launch on an (H, W) field of K
    labels: a block holds ``cells`` = 32 m consecutive cells (m = max(1,
    8 // K)) times the K labels, thread ``t`` of block ``b`` takes label
    ``t // cells`` of cell ``b cells + t % cells`` when that cell lies in
    the field.  At 140 x 140, K = 4: 307 blocks of 256 threads."""
    cells = 32 * max(1, 8 // k)
    return cells, k * cells, -(-h * w // cells)


class _Plan(ctypes.Structure):
    """``SimplexPlan`` of ``csrc/stencil_fused_simplex.cu``."""
    _fields_ = ([("partials", ctypes.c_void_p), ("ticket", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("h", "w", "k", "nf", "device",
                                               "has_laf", "label_mode")]
                + [("dy", ctypes.c_int * MAX_FAMILIES),
                   ("dx", ctypes.c_int * MAX_FAMILIES)]
                + [("rho", ctypes.c_double), ("al", ctypes.c_double)])


@functools.cache
def _lib():
    """The kernels' library (:func:`.banded._lib`) with the entries
    declared and the constants mirrored here checked against the CUDA
    source."""
    lib = banded._lib()
    ptr = ctypes.c_void_p
    for t in ("f32", "f64"):
        fn = getattr(lib, f"cp_stencil_simplex_{t}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 19
    lib.cp_stencil_simplex_plan_size.restype = ctypes.c_int
    lib.cp_stencil_simplex_plan_size.argtypes = []
    lib.cp_stencil_simplex_shape.restype = None
    lib.cp_stencil_simplex_shape.argtypes = [ctypes.c_int] * 3 + [ptr]
    shape = (ctypes.c_int * 5)()
    for h, w, k in ((140, 140, 1), (140, 140, 4), (7, 9, 9), (3, 5, 32)):
        lib.cp_stencil_simplex_shape(h, w, k, shape)
        if tuple(shape) != (MAX_LABELS, MAX_FAMILIES) + launch_shape(h, w, k):
            raise RuntimeError("ops/stencil_fused_simplex.py disagrees with "
                               "csrc/stencil_fused_simplex.cu")
    if lib.cp_stencil_simplex_plan_size() != ctypes.sizeof(_Plan):
        raise RuntimeError("_Plan disagrees with csrc/stencil_fused_simplex.cu")
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


_SIGNATURE = operator.attrgetter("dtype", "shape", "device")


def plan_key(fields, shifts, *, rho: float, al: float, has_laf: bool,
             label_mode: bool):
    """Key of a launch plan: each field's dtype, shape and device (so the
    type, K and the label mode's prev plane), the shifts and the stage's
    constants (rho, the loss al, has_laf, label_mode)."""
    return (tuple(map(_SIGNATURE, fields)), shifts, float(rho), float(al),
            bool(has_laf), bool(label_mode))


def _make_plan(plans, key, shifts, fields, rho, al, has_laf, label_mode):
    """Checks the fields once for ``key`` and prepares the launch:
    ``(C function, plan address, device index, output sizes, the plan and
    its buffers)``, kept in ``plans``."""
    _check(fields, shifts, label_mode)
    lib = _lib()
    p = fields[0]
    k, h, w = p.shape
    f = len(shifts)
    partials = p.new_empty(launch_shape(h, w, k)[2])
    ticket = torch.zeros(1, dtype=torch.int32, device=p.device)
    pad = [0] * (MAX_FAMILIES - f)
    # each shift reduced to |dy| < H, |dx| < W (the same circular shift)
    dys = [int(math.fmod(dy, h)) for dy, _ in shifts]
    dxs = [int(math.fmod(dx, w)) for _, dx in shifts]
    plan = _Plan(partials.data_ptr(), ticket.data_ptr(), h, w, k, f,
                 p.device.index, int(has_laf), int(label_mode),
                 (ctypes.c_int * MAX_FAMILIES)(*dys, *pad),
                 (ctypes.c_int * MAX_FAMILIES)(*dxs, *pad), float(rho),
                 float(al))
    sfx = "f32" if p.dtype == torch.float32 else "f64"
    sizes = (f * k * h * w, k * h * w, fields[5].numel())
    entry = (getattr(lib, f"cp_stencil_simplex_{sfx}"),
             ctypes.addressof(plan), p.device.index, sizes,
             (plan, partials, ticket))
    plans[key] = entry
    return entry


def fused_stage(plans, shifts, fields, *, rho: float, al: float,
                has_laf: bool, label_mode: bool):
    """The kernel's iteration on CUDA ``fields`` (as
    :func:`fused_stencil_simplex_iteration` takes them) through the plan
    kept in the dict ``plans``: ``(p_new, prev_new, zu_new, zv_new,
    dif_sum)``, views of one output tensor.  The checks run once per
    :func:`plan_key`.  Two streams must not run an iteration through one
    plan at once: they would share its ticket and partials."""
    key = plan_key(fields, shifts, rho=rho, al=al, has_laf=has_laf,
                   label_mode=label_mode)
    entry = plans.get(key)
    if entry is None:
        entry = _make_plan(plans, key, shifts, fields, rho, al, has_laf,
                           label_mode)
    fn, plan, index, (nz, npn, nprev), _ = entry
    if not all(map(torch.Tensor.is_contiguous, fields)):
        raise ValueError("stencil_fused_simplex: a field is not contiguous")
    p, prev, zu = fields[0], fields[5], fields[6]
    out = p.new_empty(2 * nz + npn + nprev + 2)
    base, size = out.data_ptr(), out.element_size()
    rc = fn(plan, *[a.data_ptr() for a in fields], base + 2 * nz * size,
            base + (2 * nz + npn) * size, base,
            base + (2 * nz + npn + nprev) * size, banded._raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"stencil_fused_simplex launch failed (CUDA "
                           f"error {rc})")
    fused_stencil_simplex_iteration.launches += 1
    z = out.narrow(0, 0, 2 * nz).view((2,) + tuple(zu.shape))
    return (out.narrow(0, 2 * nz, npn).view(p.shape),
            out.narrow(0, 2 * nz + npn, nprev).view(prev.shape), z[0], z[1],
            out[2 * nz + npn + nprev])


_plans: dict = {}


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
    kw = dict(rho=rho, al=al, has_laf=has_laf, label_mode=label_mode)
    if not p.is_cuda:
        return stencil_simplex_iteration_plain(*arrays, shifts=shifts, **kw)
    shifts = tuple((int(dy), int(dx)) for dy, dx in shifts)
    return fused_stage(_plans, shifts, arrays, **kw)


fused_stencil_simplex_iteration.launches = 0
