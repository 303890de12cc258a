"""Whole PFDR solve of a reduced problem of any size in one launch: the
hand-written Hopper kernel ``csrc/solve_fused.cu`` and its plain PyTorch
version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.solve_fused``
(``fused_pfdr_solve``).  It takes the reduced problems that
:mod:`.solve_small` cannot hold in one block's shared memory
(:func:`.solve_small.fits`).  The TPU kernel reached edges through the
banded-tile layout of ``ops/banded.BandedPlan`` (``[nt T8, 128]`` edge
tiles, one-hot selector products, ``wd8`` vertex windows), a workaround for
the TPU's lack of a vector gather; this kernel takes flat vertex and edge
rows, indexed endpoints and the per-vertex incidence list instead, with the
arguments of :func:`.solve_small.fused_pfdr_solve_small` plus the resume
count ``it0``.  Callers pass the edges sorted stably by their smaller
endpoint, the order of the TPU kernel's banded plan (``ops/banded.py:103``).

:func:`fused_pfdr_solve` launches the kernel for tensors on a CUDA device
and runs :func:`solve_fused_plain` for tensors on the CPU; there is no other
fallback.  Each launch adds one to ``fused_pfdr_solve.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..graph import incidence_csr
from .solve_small import _OP_KIND, _VKIND, _check, solve_small_plain

_THREADS = 256     # kSolveThreads of the CUDA source
_MAX_BLOCKS = 4096


def solve_fused_plain(op_kind: str, op, aty, ga, th_l1, x0, z0, ec, eu, ev,
                      *, rv: int, it_max: int, rho: float, vkind: str,
                      positivity: bool, lo: float, hi: float,
                      dif_tol2: float, eps: float, it0: int = 0):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_pfdr_solve`): the reduced PFDR iteration of
    :func:`.solve_small.solve_small_plain`, resumed at iteration ``it0``."""
    x, z, it, dif = solve_small_plain(
        op_kind, op, aty, ga, th_l1, x0, z0, ec, eu, ev, rv=rv,
        it_max=it_max - it0, rho=rho, vkind=vkind, positivity=positivity,
        lo=lo, hi=hi, dif_tol2=dif_tol2, eps=eps)
    return x, z, it + it0, dif


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_solve_fused_declared", False):
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("cp_solve_fused_f32", "cp_solve_fused_f64"):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = ([i, ptr, i] + [ptr] * 10
                           + [i, i, i, i, d, i, i, d, d, d, d]
                           + [ptr] * 6 + [i] + [ptr] * 3)
        lib._cp_solve_fused_declared = True
    return lib


def fused_pfdr_solve(op_kind: str, op, aty, ga, th_l1, x0, z0, ec, eu, ev,
                     *, rv: int, it_max: int, rho: float, vkind: str,
                     positivity: bool, lo: float, hi: float,
                     dif_tol2: float, eps: float, it0: int = 0):
    """Complete reduced PFDR solve, resumable.

    Args: as :func:`.solve_small.fused_pfdr_solve_small`, with no size
      limit, plus ``it0``: iterations already done (a resumed solve passes
      the state it stopped at as ``x0``/``z0`` and runs up to ``it_max``
      in all).  The evolution test starts afresh, as in the JAX package.

    Returns:
      ``(x [rv_cap], z [2, E], it, dif)`` with ``it`` (``it0`` included) an
      int32 and ``dif`` a 0-d tensor on the inputs' device.
    """
    kw = dict(rv=rv, it_max=it_max, rho=rho, vkind=vkind,
              positivity=positivity, lo=lo, hi=hi, dif_tol2=dif_tol2,
              eps=eps)
    if not x0.is_cuda:
        return solve_fused_plain(op_kind, op, aty, ga, th_l1, x0, z0, ec,
                                 eu, ev, it0=it0, **kw)
    _check(op_kind, op, (x0, aty, ga, th_l1), z0, ec, eu, ev, rv,
           size_limit=False)
    if vkind not in _VKIND:
        raise ValueError(f"unknown vertex prox {vkind!r}")
    lib = _lib()
    rv_cap, ne = x0.shape[0], eu.shape[0]
    n_rows = op.shape[0] if op_kind == "dense" else 0
    eu32 = eu.to(torch.int32).contiguous()
    ev32 = ev.to(torch.int32).contiguous()
    offsets, slots = incidence_csr(eu32, ev32, rv_cap)
    xo = torch.empty_like(x0)
    zo = torch.empty_like(z0)
    p = torch.empty_like(x0)
    r = torch.empty(max(n_rows, 1), dtype=x0.dtype, device=x0.device)
    wz = torch.empty(2 * ne, dtype=x0.dtype, device=x0.device)
    max_blocks = min(-(-max(rv_cap, ne) // _THREADS), _MAX_BLOCKS)
    partials = torch.empty(2 * max_blocks, dtype=x0.dtype, device=x0.device)
    it = torch.empty((), dtype=torch.int32, device=x0.device)
    dif = torch.empty((), dtype=x0.dtype, device=x0.device)
    fn = (lib.cp_solve_fused_f32 if x0.dtype == torch.float32
          else lib.cp_solve_fused_f64)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_OP_KIND[op_kind], op.data_ptr(), n_rows, aty.data_ptr(),
                ga.data_ptr(), th_l1.data_ptr(), x0.data_ptr(),
                z0.data_ptr(), ec.data_ptr(), eu32.data_ptr(),
                ev32.data_ptr(), offsets.data_ptr(), slots.data_ptr(),
                rv_cap, ne, int(rv), int(it_max) - int(it0), float(rho),
                _VKIND[vkind], int(positivity), float(lo), float(hi),
                float(dif_tol2), float(eps), xo.data_ptr(), zo.data_ptr(),
                p.data_ptr(), r.data_ptr(), wz.data_ptr(),
                partials.data_ptr(), max_blocks, it.data_ptr(),
                dif.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"solve_fused launch failed (CUDA error {rc})")
    fused_pfdr_solve.launches += 1
    return xo, zo, it + int(it0), dif


fused_pfdr_solve.launches = 0
