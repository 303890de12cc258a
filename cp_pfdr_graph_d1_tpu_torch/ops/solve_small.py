"""Whole PFDR solve of a small reduced problem in one launch: the
hand-written Hopper kernel ``csrc/solve_small.cu`` and its plain PyTorch
version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.solve_small``
(``fused_pfdr_solve_small``).  The TPU kernel gathers endpoints and
scatters edges through a one-hot ``[rv_cap, 2e]`` matrix that must fit in
VMEM; the Hopper kernel uses indexed loads and a per-vertex incidence list
instead, so its only size limit is the shared memory that holds the
iterate and the forward values (:func:`fits`).  The TPU-only devices (the
``split3`` bf16 dots, ``[8, 128]`` lane padding, VMEM budgets) are gone.

:func:`fused_pfdr_solve_small` launches the kernel for tensors on a CUDA
device and runs :func:`solve_small_plain` for tensors on the CPU; there is
no other fallback.  Each launch adds one to
``fused_pfdr_solve_small.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..graph import csr_table, incidence_csr
from .prox import vertex_prox_plain

# opt-in dynamic shared memory of one Hopper block (232,448 bytes), less
# room for the kernel's static shared variables
MAX_SMEM_BYTES = 232_448 - 1024

_OP_KIND = {"dense": 0, "gram": 1, "diag": 2}
_VKIND = {"none": 0, "l1": 1, "bounds": 2}


def smem_bytes(rv_cap: int, n_rows: int, itemsize: int) -> int:
    """Dynamic shared memory of one launch (must match ``smem_bytes`` in
    ``csrc/solve_small.cu``): iterate, forward values, ``A x`` and the
    reduction scratch."""
    return itemsize * (2 * rv_cap + n_rows + 64)


def fits(rv_cap: int, n_rows: int, dtype) -> bool:
    """Whether a reduced problem of ``rv_cap`` vertices (and ``n_rows``
    observation rows for a dense operator, 0 otherwise) fits the kernel."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    return smem_bytes(rv_cap, n_rows, itemsize) <= MAX_SMEM_BYTES


def solve_small_plain(op_kind: str, op, aty, ga, th_l1, x0, z0, ec, eu, ev,
                      *, rv: int, it_max: int, rho: float, vkind: str,
                      positivity: bool, lo: float, hi: float,
                      dif_tol2: float, eps: float):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_pfdr_solve_small`)."""
    rv_cap = x0.shape[0]
    # edge -> vertex sums by gather and row sum: deterministic on every
    # device, in the CSR order the kernel uses
    table = csr_table(*incidence_csr(eu, ev, rv_cap))
    eu = eu.to(torch.int64)
    ev = ev.to(torch.int64)
    wu, wv, wdu, wdv, thd = ec
    live = torch.arange(rv_cap, device=x0.device) < rv
    x = x0.clone()
    zu, zv = z0[0].clone(), z0[1].clone()
    it = 0
    dif = torch.tensor(max(dif_tol2, 1.0), dtype=x0.dtype, device=x0.device)
    while it < it_max and bool(dif >= dif_tol2):
        if op_kind == "dense":
            g = op.T @ (op @ x)
        elif op_kind == "gram":
            g = x @ op
        else:
            g = op * x
        p = 2.0 * x - ga * (g - aty)
        au = p[eu] - zu
        av = p[ev] - zv
        avg = wdu * au + wdv * av
        diff = au - av
        shrunk = torch.sign(diff) * torch.clamp(diff.abs() - thd, min=0)
        zu = zu + rho * ((avg + wdv * shrunk) - x[eu])
        zv = zv + rho * ((avg - wdu * shrunk) - x[ev])
        a = torch.cat([wu * zu, wv * zv, zu.new_zeros(1)])[table].sum(dim=1)
        xn = vertex_prox_plain(a, th_l1, vkind, positivity, lo, hi)
        xn = torch.where(live, xn, torch.zeros_like(xn))
        delta = xn - x
        num = (delta * delta).sum()
        den = (xn * xn).sum()
        dif = torch.where(den > eps, num / den, num / eps)
        x = xn
        it += 1
    return (x, torch.stack([zu, zv]),
            torch.tensor(it, dtype=torch.int32, device=x0.device), dif)


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_small_declared", False):
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("cp_solve_small_f32", "cp_solve_small_f64"):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = ([i, ptr, i] + [ptr] * 10
                           + [i, i, i, i, d, i, i, d, d, d, d]
                           + [ptr] * 6)
        lib.cp_solve_small_smem_bytes.restype = ctypes.c_size_t
        lib.cp_solve_small_smem_bytes.argtypes = [i, i, i]
        if lib.cp_solve_small_smem_bytes(8, 100, 7) != smem_bytes(100, 7, 8):
            raise RuntimeError("smem_bytes disagrees with the CUDA source")
        lib._cp_small_declared = True
    return lib


def _check(op_kind, op, vertex_rows, z0, ec, eu, ev, rv, size_limit=True):
    x0 = vertex_rows[0]
    rv_cap = x0.shape[0]
    ne = eu.shape[0]
    if op_kind not in _OP_KIND:
        raise ValueError(f"unknown operator kind {op_kind!r}")
    if x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not "
                         f"{x0.dtype}")
    want_op = {"dense": (op.shape[0], rv_cap) if op.ndim == 2 else None,
               "gram": (rv_cap, rv_cap), "diag": (rv_cap,)}[op_kind]
    arrays = [("op", op, want_op), ("z0", z0, (2, ne)), ("ec", ec, (5, ne))]
    arrays += [(f"vertex row {k}", a, (rv_cap,))
               for k, a in enumerate(vertex_rows)]
    for name, a, want in arrays:
        if want is None or tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{want}")
        if a.dtype != x0.dtype or a.device != x0.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                             f"{x0.dtype} on {x0.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, a in (("eu", eu), ("ev", ev)):
        if tuple(a.shape) != (ne,) or a.device != x0.device:
            raise ValueError(f"{name} must be [{ne}] on {x0.device}")
    if ne < 1 or not 0 <= rv <= rv_cap:
        raise ValueError(f"need at least one edge and 0 <= rv <= rv_cap "
                         f"(ne={ne}, rv={rv}, rv_cap={rv_cap})")
    n_rows = op.shape[0] if op_kind == "dense" else 0
    if size_limit and not fits(rv_cap, n_rows, x0.dtype):
        raise ValueError(
            f"reduced problem too large for the solve_small kernel: "
            f"rv_cap={rv_cap}, n_rows={n_rows}, {x0.dtype} needs "
            f"{smem_bytes(rv_cap, n_rows, x0.element_size())} B of shared "
            f"memory, the limit is {MAX_SMEM_BYTES} B")


def fused_pfdr_solve_small(op_kind: str, op, aty, ga, th_l1, x0, z0, ec,
                           eu, ev, *, rv: int, it_max: int, rho: float,
                           vkind: str, positivity: bool, lo: float,
                           hi: float, dif_tol2: float, eps: float):
    """Complete small-problem PFDR solve.

    Args:
      op_kind: "dense" (``op`` is ``A`` [N, rv_cap]), "gram" (``op`` is
        ``A^t A`` [rv_cap, rv_cap]) or "diag" (``op`` is the diagonal
        [rv_cap]).
      aty, ga, th_l1, x0: [rv_cap] vertex rows (``aty`` in the operator's
        gradient convention: the gradient is ``A^t A x - aty``).
      z0: [2, E] initial auxiliary pairs (zu; zv).
      ec: [5, E] edge constants, rows (wu, wv, w_d1u, w_d1v, th_d1).
      eu, ev: [E] integer endpoints; padding edges carry zero weights.
      rv: true vertex count; entries ``>= rv`` are held at zero.
      it_max, dif_tol2, eps: iteration cap and evolution test, as in the
        PFDR loop.

    Returns:
      ``(x [rv_cap], z [2, E], it, dif)`` with ``it`` an int32 and ``dif``
      a 0-d tensor on the inputs' device.
    """
    kw = dict(rv=rv, it_max=it_max, rho=rho, vkind=vkind,
              positivity=positivity, lo=lo, hi=hi, dif_tol2=dif_tol2,
              eps=eps)
    if not x0.is_cuda:
        return solve_small_plain(op_kind, op, aty, ga, th_l1, x0, z0, ec,
                                 eu, ev, **kw)
    _check(op_kind, op, (x0, aty, ga, th_l1), z0, ec, eu, ev, rv)
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
    wz = torch.empty(2 * ne, dtype=x0.dtype, device=x0.device)
    it = torch.empty((), dtype=torch.int32, device=x0.device)
    dif = torch.empty((), dtype=x0.dtype, device=x0.device)
    fn = (lib.cp_solve_small_f32 if x0.dtype == torch.float32
          else lib.cp_solve_small_f64)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_OP_KIND[op_kind], op.data_ptr(), n_rows, aty.data_ptr(),
                ga.data_ptr(), th_l1.data_ptr(), x0.data_ptr(),
                z0.data_ptr(), ec.data_ptr(), eu32.data_ptr(),
                ev32.data_ptr(), offsets.data_ptr(), slots.data_ptr(),
                rv_cap, ne, int(rv), int(it_max), float(rho),
                _VKIND[vkind], int(positivity), float(lo), float(hi),
                float(dif_tol2), float(eps), xo.data_ptr(), zo.data_ptr(),
                wz.data_ptr(), it.data_ptr(), dif.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"solve_small launch failed (CUDA error {rc})")
    fused_pfdr_solve_small.launches += 1
    return xo, zo, it, dif


fused_pfdr_solve_small.launches = 0
