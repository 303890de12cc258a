"""Set-up of a reduced cut-pursuit problem in one launch: the hand-written
Hopper kernel ``csrc/reduced_setup.cu`` and its plain PyTorch version.

The set-up takes a reduced problem from the products of its contraction
(the reduced operator, observation and graph) to the inputs of the
whole-solve kernels (:mod:`.solve_small`, :mod:`.solve_fused`): the DIAG
Lipschitz metric, whose factor is the largest eigenvalue of a small
symmetric matrix by the power iteration of :func:`.power_iter
.operator_norm`, then the initial preconditioning of
:func:`..solvers.pfdr_quadratic.initial_precondition`, the edge rows and
the warm start's endpoint values.  No kernel of the JAX package does this
(it runs these steps as XLA operations); in the port they were eager
PyTorch operations, about 70 launches, and a device read after every power
step for its stopping test.

The contraction hands the metric over as a :class:`PendingMetric` (the
matrix and the scale, before the power iteration), so that the power
iteration runs in the set-up's launch; the routes without a set-up take
its value (:func:`metric_value`).  :func:`settle_metric` runs the power
iteration in PyTorch where the kernel does not take it: CPU tensors, and a
matrix of more than :data:`FUSED_POWER_MAX_DIM` rows.

:func:`reduced_setup` launches the kernel for tensors on a CUDA device
and runs :func:`reduced_setup_plain` for CPU tensors; there is no other
fallback.  The kernel's one block takes reduced graphs of every size: on
an NVIDIA H100 the plain chain's launches over the whole card did not
overtake it up to 262,144 reduced vertices (``chip_smoke.py
--reduced-setup``'s size sweep, PERF.md).  Each launch adds one to
``reduced_setup.launches`` and to the traced solve's
``reduced.setup_fused`` counter; its power steps reach ``lipschitz.steps``
at the solve's next device read (:func:`..utils.monitor.count_device`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..config import (OPERATOR_NORM_IT_MAX, OPERATOR_NORM_NB_INIT,
                      OPERATOR_NORM_TOL, Lipsch)
from ..operators import DenseOp, DiagOp, QuadOp
from ..utils.monitor import count, count_device, span
from .power_iter import MatApply, operator_norm, start_columns

# opt-in dynamic shared memory of one Hopper block (232,448 bytes), less
# room for the kernel's static shared variables (kSetupSmemLimit)
MAX_SMEM_BYTES = 232_448 - 4096

# the most rows of a power-iteration matrix the kernel takes; beyond it the
# power iteration runs in PyTorch before the launch (cuBLAS products over
# the card, a host read a step).  chip_smoke.py --reduced-setup on an
# NVIDIA H100 80GB HBM3 at 700 W, a set-up of the premultiplied EEG-grid
# operator with a synchronise, kernel against PyTorch in two runs: float32
# 3.3-3.4 against 10.0-12.2 ms at 512 rows, 13.5-13.7 against 12.4-19.1 at
# 1024; float64 5.8-5.9 against 9.5-9.9 ms at 512, 14.3-14.5 against
# 6.1-8.6 at 1024
FUSED_POWER_MAX_DIM = 512

_KIND = {"dense": 0, "gram": 1, "diag": 2}


class PendingMetric(NamedTuple):
    """The DIAG Lipschitz metric ``scale * ||M||`` of a reduced problem
    before its power iteration: ``mat`` the symmetric [p, p] matrix M,
    Jacobi-equilibrated first with ``equilibrate`` (``M_ij / (d_i d_j)``,
    ``d = sqrt(max(diag M, 0))``, 1 where 0), ``scale`` the [rv_cap]
    factor."""
    mat: torch.Tensor
    equilibrate: bool
    scale: torch.Tensor


def metric_value(lipsch):
    """The metric as a tensor: a :class:`PendingMetric`'s power iteration
    runs here, in PyTorch; a tensor passes."""
    if not isinstance(lipsch, PendingMetric):
        return lipsch
    with span("cp.reduced.lipschitz"):
        m = lipsch.mat
        if lipsch.equilibrate:
            d = torch.sqrt(torch.clamp(torch.diagonal(m), min=0))
            d_safe = torch.where(d > 0, d, torch.ones_like(d))
            m = m / (d_safe[:, None] * d_safe[None, :])
        c = operator_norm(MatApply(m), m.shape[0], m.dtype, m.device)
    return lipsch.scale * c


def smem_bytes(p: int, itemsize: int) -> int:
    """Dynamic shared memory of a launch whose M has ``p`` rows: the power
    iteration's vectors (must match ``setup_smem_bytes`` in
    ``csrc/reduced_setup.cu``)."""
    return itemsize * (2 * OPERATOR_NORM_NB_INIT + 1) * p


def power_in_kernel(mat) -> bool:
    """Whether the kernel runs the power iteration of the matrix ``mat``:
    on a CUDA device, up to :data:`FUSED_POWER_MAX_DIM` rows (its iterate
    then fits shared memory in either type)."""
    return mat.is_cuda and 0 < mat.shape[0] <= FUSED_POWER_MAX_DIM


def settle_metric(lipsch):
    """The metric as :func:`reduced_setup` takes it: a
    :class:`PendingMetric` whose power iteration the kernel runs stays
    pending, any other is computed here (:func:`metric_value`)."""
    if isinstance(lipsch, PendingMetric) and power_in_kernel(lipsch.mat):
        return lipsch
    return metric_value(lipsch)


class SetupOut(NamedTuple):
    """The whole-solve kernels' inputs that the set-up makes."""
    aty: torch.Tensor   # [rv_cap] A^t y in the operator's convention
    ga: torch.Tensor    # [rv_cap] Gamma
    th_l1: torch.Tensor  # [rv_cap] l1 thresholds
    ec: torch.Tensor    # [5, E] wu, wv, w_d1u, w_d1v, th_d1
    z0: torch.Tensor    # [2, E] the warm start's endpoint values
    lipsch: torch.Tensor  # [rv_cap] the DIAG Lipschitz metric


def reduced_setup_plain(r_op: QuadOp, ry, lipsch, rgraph, r_la_l1, x0, *,
                        rho: float) -> SetupOut:
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`reduced_setup`)."""
    from ..solvers.pfdr_quadratic import initial_precondition
    lipsch = metric_value(lipsch)
    pre = initial_precondition(r_op, ry, rgraph, r_la_l1, rho, lipsch,
                               Lipsch.DIAG)
    aty = r_op.apply_t(ry) if isinstance(r_op, DenseOp) else ry
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    return SetupOut(aty.contiguous(), pre.ga.contiguous(),
                    pre.th_l1.contiguous(), ec,
                    torch.stack([x0[rgraph.eu], x0[rgraph.ev]]), lipsch)


def reduced_setup(r_op: QuadOp, mat, ry, lipsch, rgraph, r_la_l1, x0, *,
                  rho: float) -> SetupOut:
    """The set-up of one reduced problem, in one launch.

    Args:
      r_op, mat, ry: the reduced operator (dense, Gram or diagonal), its
        array and observation (the dense operator's ``y``, else ``A^t y``).
      lipsch: the DIAG Lipschitz metric, a [rv_cap] tensor or a
        :class:`PendingMetric`.
      rgraph: the reduced graph over ``rv_cap`` vertices (padding edges
        carry weight 0).
      r_la_l1: [rv_cap] summed l1 weights, or None.
      x0: [rv_cap] warm start.

    Returns:
      :class:`SetupOut`, in ``rgraph``'s edge order.
    """
    if not x0.is_cuda:
        return reduced_setup_plain(r_op, ry, lipsch, rgraph, r_la_l1, x0,
                                   rho=rho)
    return _fused(r_op, mat, ry, settle_metric(lipsch), rgraph, r_la_l1, x0,
                  rho)


reduced_setup.launches = 0


def _fused(r_op, mat, ry, lipsch, rgraph, r_la_l1, x0, rho):
    """:func:`reduced_setup` on the card, its metric settled: the outputs,
    one launch, the counts."""
    kind = ("dense" if isinstance(r_op, DenseOp)
            else "diag" if isinstance(r_op, DiagOp) else "gram")
    nv, ne = rgraph.num_vertices, rgraph.num_edges
    pending = isinstance(lipsch, PendingMetric)
    # the outputs in one allocation
    ga, th_l1, ec, z0, lip = torch.empty(
        3 * nv + 7 * ne, dtype=x0.dtype, device=x0.device).split(
            [nv, nv, 5 * ne, 2 * ne, nv])
    aty = r_op.apply_t(ry) if kind == "dense" else ry
    out = SetupOut(aty.contiguous(), ga, th_l1, ec.view(5, ne),
                   z0.view(2, ne), lip if pending else lipsch)
    steps = torch.empty((), dtype=torch.int32, device=x0.device) \
        if pending else None
    _launch(kind, mat.contiguous(), lipsch, rgraph, r_la_l1, x0.contiguous(),
            float(rho), out, steps)
    reduced_setup.launches += 1
    count("reduced.setup_fused", 1)
    if pending:
        count_device("lipschitz.steps", steps)
    return out


class _Params(ctypes.Structure):
    """``SetupParams`` of ``csrc/reduced_setup.cu``."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "kind", "n_rows", "rv_cap", "ne", "p", "equilibrate", "it_max",
        "scale_stride")]
        + [("tol", ctypes.c_double), ("cap", ctypes.c_double)]
        + [(n, ctypes.c_void_p) for n in (
            "mat", "aty", "pm", "start", "scale", "lip_in", "la_d1", "la_l1",
            "x0", "eu", "ev", "inc_off", "inc_slot", "ga", "th_l1", "ec",
            "z0", "lip", "steps")])


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_setup_declared", False):
        lib.cp_reduced_setup.restype = ctypes.c_int
        lib.cp_reduced_setup.argtypes = [ctypes.POINTER(_Params),
                                         ctypes.c_int, ctypes.c_void_p]
        lib.cp_reduced_setup_smem_bytes.restype = ctypes.c_size_t
        lib.cp_reduced_setup_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.cp_reduced_setup_restarts.restype = ctypes.c_int
        lib.cp_reduced_setup_restarts.argtypes = []
        if (lib.cp_reduced_setup_smem_bytes(8, 100) != smem_bytes(100, 8)
                or lib.cp_reduced_setup_restarts() != OPERATOR_NORM_NB_INIT):
            raise RuntimeError("reduced_setup.py disagrees with the CUDA "
                               "source")
        lib._cp_setup_declared = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kind, mat, lipsch, rgraph, r_la_l1, x0, rho, out, steps):
    """Checks the inputs, then launches the kernel on the current stream,
    writing ``out`` (all but ``aty``; its metric and ``steps`` with a
    pending metric)."""
    nv, ne = rgraph.num_vertices, rgraph.num_edges
    dtype, device = x0.dtype, x0.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    n_rows = mat.shape[0] if kind == "dense" else 0
    want = {"dense": (n_rows, nv), "gram": (nv, nv), "diag": (nv,)}[kind]
    arrays = [("mat", mat, want), ("aty", out.aty, (nv,)),
              ("la_d1", rgraph.la_d1, (ne,)), ("x0", x0, (nv,))]
    if r_la_l1 is not None:
        arrays.append(("r_la_l1", r_la_l1, (nv,)))
    pending = isinstance(lipsch, PendingMetric)
    if pending:
        p = lipsch.mat.shape[0]
        arrays += [("metric matrix", lipsch.mat, (p, p)),
                   ("metric scale", lipsch.scale, (nv,))]
    else:
        arrays.append(("metric", lipsch, (nv,)))
    for name, a, shape in arrays:
        if tuple(a.shape) != shape or a.dtype != dtype or a.device != device:
            raise ValueError(f"{name} is {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}; expected {dtype} {shape} on "
                             f"{device}")
    if ne < 1:
        raise ValueError("the reduced graph needs at least one edge")
    eu = rgraph.eu.to(torch.int64).contiguous()
    ev = rgraph.ev.to(torch.int64).contiguous()
    offsets, slots = rgraph.incidence_lists()
    la_d1 = rgraph.la_d1.contiguous()
    la_l1 = None if r_la_l1 is None else r_la_l1.contiguous()
    prm = _Params(kind=_KIND[kind], n_rows=n_rows, rv_cap=nv, ne=ne,
                  tol=OPERATOR_NORM_TOL, cap=1.9 * (2.0 - rho),
                  mat=_ptr(mat), aty=_ptr(out.aty), la_d1=_ptr(la_d1),
                  la_l1=_ptr(la_l1), x0=_ptr(x0), eu=_ptr(eu), ev=_ptr(ev),
                  inc_off=_ptr(offsets), inc_slot=_ptr(slots),
                  ga=_ptr(out.ga), th_l1=_ptr(out.th_l1),
                  ec=_ptr(out.ec), z0=_ptr(out.z0))
    if pending:
        pm = lipsch.mat.contiguous()
        start = start_columns(p, OPERATOR_NORM_NB_INIT, dtype, device)
        prm.p, prm.equilibrate = p, int(lipsch.equilibrate)
        prm.it_max, prm.scale_stride = (OPERATOR_NORM_IT_MAX,
                                        lipsch.scale.stride(0))
        prm.pm, prm.start, prm.scale = _ptr(pm), _ptr(start), \
            _ptr(lipsch.scale)
        prm.lip, prm.steps = _ptr(out.lipsch), _ptr(steps)
    else:
        prm.lip_in = _ptr(lipsch.contiguous())
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cp_reduced_setup(ctypes.byref(prm), x0.element_size(),
                                  stream)
    if rc != 0:
        raise RuntimeError(f"reduced_setup launch failed (CUDA error {rc})")
