"""Whole PFDR solve of a small reduced problem in one launch: the
hand-written Hopper kernel ``csrc/solve_small.cu`` and its plain PyTorch
version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.solve_small``
(``fused_pfdr_solve_small``).  The TPU kernel gathers endpoints and
scatters edges through a one-hot ``[rv_cap, 2e]`` matrix that must fit in
VMEM; the Hopper kernel uses indexed loads and a per-vertex incidence list
instead, so its only size limit is shared memory (:func:`fits`).  It runs
in one block, or as a thread-block cluster of ``C`` CTAs that share the
vertices, the edges and the operator (:func:`cluster_size` picks ``C``;
:func:`smem_bytes` counts each CTA's shared memory).  The TPU-only devices
(the ``split3`` bf16 dots, ``[8, 128]`` lane padding, VMEM budgets) are
gone.

:func:`fused_pfdr_solve_small` launches the kernel for tensors on a CUDA
device and runs :func:`solve_small_plain` for tensors on the CPU; there is
no other fallback.  Each launch adds one to
``fused_pfdr_solve_small.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..graph import csr_table, incidence_csr
from .prox import vertex_prox_plain

# opt-in dynamic shared memory of one Hopper block (232,448 bytes), less
# room for the kernel's static shared variables
MAX_SMEM_BYTES = 232_448 - 1024

_OP_KIND = {"dense": 0, "gram": 1, "diag": 2}
_VKIND = {"none": 0, "l1": 1, "bounds": 2}

# cluster sizes the kernel takes (kMaxCluster in csrc/solve_small.cu); 16
# CTAs is the H100's largest (non-portable) cluster
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# an operator of at least CLUSTER_MIN_OP_BYTES runs on a cluster of 16 CTAs
# (fewer where shared memory or rv_cap ask for it), a smaller one in one
# block: on the EEG problem's partitions (chip_smoke.py's crossover lines,
# PERF.md) one block wins below the dense rv_cap 512 operator (186 KB in
# float32), 16 CTAs from rv_cap 1024 (373 KB) and the Gram rv_cap 256 one
# (256 KB) on, and more CTAs do better up to 16
CLUSTER_MIN_OP_BYTES = 256 * 1024


def _itemsize(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def op_rows(op_kind: str, rv_cap: int, n_rows: int) -> int:
    """Rows of the operator's slice a CTA of a cluster holds: A's
    ``n_rows`` for "dense", the Gram matrix's ``rv_cap`` for "gram", none
    for "diag"."""
    return {"dense": n_rows, "gram": rv_cap, "diag": 0}[op_kind]


def smem_bytes(rv_cap: int, n_rows: int, itemsize: int, cluster: int = 1,
               *, n_op: int = 0, op_in_smem: bool = False) -> int:
    """Dynamic shared memory of one CTA (must match ``smem_bytes`` and
    ``cluster_smem_bytes`` in ``csrc/solve_small.cu``).  One block: the
    iterate, the forward values, ``A x`` (``n_rows``: the dense A's rows,
    else 0) and the reduction scratch.  A CTA of a cluster: its slice of
    ``cs = ceil(rv_cap / cluster)`` vertices at two parities, their
    forward values, Gamma, ``A^t y`` and l1 thresholds, the partial
    product and ``A x`` (``n_op`` each, see :func:`op_rows`), the scratch,
    the evolution partials and ratio; the operator's slice (``n_op cs``
    values) with ``op_in_smem``; its vertices' ``cs + 1`` incidence
    offsets (int32)."""
    if cluster == 1:
        return itemsize * (2 * rv_cap + n_rows + 64)
    cs = -(-rv_cap // cluster)
    n = 6 * cs + 2 * n_op + 64 + 3
    if op_in_smem:
        n += n_op * cs
    return itemsize * n + 4 * (cs + 1)


def fits(rv_cap: int, n_rows: int, dtype) -> bool:
    """Whether a reduced problem of ``rv_cap`` vertices (and ``n_rows``
    observation rows for a dense operator, 0 otherwise) fits the kernel:
    the one-block limit, which bounds the problems the kernel takes on any
    schedule (:func:`cluster_size` picks only clusters that fit)."""
    return smem_bytes(rv_cap, n_rows, _itemsize(dtype)) <= MAX_SMEM_BYTES


def _cluster_smem(op_kind, rv_cap, n_rows, dtype, cluster):
    """``(op_in_smem, bytes)`` of one CTA of a cluster: the operator's slice
    in shared memory when it fits there, else streamed from L2."""
    size = functools.partial(smem_bytes, rv_cap, n_rows, _itemsize(dtype),
                             cluster, n_op=op_rows(op_kind, rv_cap, n_rows))
    if size(op_in_smem=True) <= MAX_SMEM_BYTES:
        return True, size(op_in_smem=True)
    return False, size()


def cluster_size(op_kind: str, rv_cap: int, n_rows: int, dtype) -> int:
    """CTAs of the launch: one block for the diagonal operator and for an
    operator under ``CLUSTER_MIN_OP_BYTES``; else 16, halved while that is
    more than ``rv_cap`` or a CTA's shared memory does not fit."""
    op_bytes = op_rows(op_kind, rv_cap, n_rows) * rv_cap * _itemsize(dtype)
    if op_kind == "diag" or op_bytes < CLUSTER_MIN_OP_BYTES:
        return 1
    c = CLUSTER_SIZES[-1]
    while c > 1 and (c > rv_cap or _cluster_smem(
            op_kind, rv_cap, n_rows, dtype, c)[1] > MAX_SMEM_BYTES):
        c //= 2
    return c


def launch_shape(op_kind: str, rv_cap: int, n_rows: int, dtype,
                 cluster: int | None = None):
    """``(cluster, op_in_smem, smem bytes)`` of a launch: the cluster
    :func:`cluster_size` picks, or ``cluster`` when given (a cluster takes
    the dense and Gram operators)."""
    c = cluster_size(op_kind, rv_cap, n_rows, dtype) if cluster is None \
        else cluster
    if c not in CLUSTER_SIZES or c > rv_cap or (c > 1 and op_kind == "diag"):
        raise ValueError(f"cluster of {c} CTAs for the {op_kind} operator; "
                         f"the kernel takes {CLUSTER_SIZES}, at most "
                         f"rv_cap={rv_cap}, and one block for 'diag'")
    if c == 1:
        n = n_rows if op_kind == "dense" else 0
        return 1, False, smem_bytes(rv_cap, n, _itemsize(dtype))
    return (c, *_cluster_smem(op_kind, rv_cap, n_rows, dtype, c))


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
            fn.argtypes = ([i, ptr, i] + [ptr] * 11
                           + [i, i, i, i, d, i, i, d, d, d, d]
                           + [ptr] * 5 + [i, i, ptr])
        lib.cp_solve_small_smem_bytes.restype = ctypes.c_size_t
        lib.cp_solve_small_smem_bytes.argtypes = [i, i, i]
        lib.cp_solve_small_cluster_smem_bytes.restype = ctypes.c_size_t
        lib.cp_solve_small_cluster_smem_bytes.argtypes = [i] * 5
        lib.cp_solve_small_max_cluster.restype = i
        lib.cp_solve_small_max_cluster.argtypes = []
        ok = (lib.cp_solve_small_smem_bytes(8, 100, 7)
              == smem_bytes(100, 7, 8)
              and lib.cp_solve_small_max_cluster() == CLUSTER_SIZES[-1])
        for c in CLUSTER_SIZES[1:]:
            for in_smem in (False, True):
                ok = ok and lib.cp_solve_small_cluster_smem_bytes(
                    8, 100, 7, c, in_smem) == smem_bytes(
                        100, 7, 8, c, n_op=7, op_in_smem=in_smem)
        if not ok:
            raise RuntimeError("smem_bytes disagrees with the CUDA source")
        lib._cp_small_declared = True
    return lib


def _check(op_kind, op, vertex_rows, z0, ec, eu, ev, rv, size_limit=True,
           cluster=None):
    """Checks the inputs; returns :func:`launch_shape` (None without
    ``size_limit``)."""
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
    if not size_limit:
        return None
    n_rows = op.shape[0] if op_kind == "dense" else 0
    shape = launch_shape(op_kind, rv_cap, n_rows, x0.dtype, cluster)
    if not fits(rv_cap, n_rows, x0.dtype) or shape[2] > MAX_SMEM_BYTES:
        need = max(shape[2], smem_bytes(rv_cap, n_rows, x0.element_size()))
        raise ValueError(
            f"reduced problem too large for the solve_small kernel: "
            f"rv_cap={rv_cap}, n_rows={n_rows}, {x0.dtype} needs {need} B "
            f"of shared memory ({shape[0]} CTAs), the limit is "
            f"{MAX_SMEM_BYTES} B")
    return shape


def fused_pfdr_solve_small(op_kind: str, op, aty, ga, th_l1, x0, z0, ec,
                           eu, ev, *, rv: int, it_max: int, rho: float,
                           vkind: str, positivity: bool, lo: float,
                           hi: float, dif_tol2: float, eps: float):
    """Complete small-problem PFDR solve, on the cluster
    :func:`cluster_size` picks.

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
    return _solve(None, op_kind, op, aty, ga, th_l1, x0, z0, ec, eu, ev,
                  rv=rv, it_max=it_max, rho=rho, vkind=vkind,
                  positivity=positivity, lo=lo, hi=hi, dif_tol2=dif_tol2,
                  eps=eps)


def _solve(cluster, op_kind, op, aty, ga, th_l1, x0, z0, ec, eu, ev, **kw):
    """:func:`fused_pfdr_solve_small` on a cluster of ``cluster`` CTAs, or
    on the one :func:`cluster_size` picks for None: the forced size serves
    the timing of each size against the others."""
    rv, vkind = kw["rv"], kw["vkind"]
    if not x0.is_cuda:
        return solve_small_plain(op_kind, op, aty, ga, th_l1, x0, z0, ec,
                                 eu, ev, **kw)
    c, in_smem, _ = _check(op_kind, op, (x0, aty, ga, th_l1), z0, ec, eu,
                           ev, rv, cluster=cluster)
    if vkind not in _VKIND:
        raise ValueError(f"unknown vertex prox {vkind!r}")
    lib = _lib()
    rv_cap, ne = x0.shape[0], eu.shape[0]
    n_rows = op.shape[0] if op_kind == "dense" else 0
    eu32 = eu.to(torch.int32).contiguous()
    ev32 = ev.to(torch.int32).contiguous()
    offsets, slots = incidence_csr(eu32, ev32, rv_cap)
    # a cluster writes the edge terms in incidence order: slot s goes to
    # position pos[s] of the list
    pos = None
    if c > 1:
        pos = torch.empty_like(slots)
        pos[slots.to(torch.int64)] = torch.arange(
            slots.numel(), dtype=torch.int32, device=slots.device)
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
                0 if pos is None else pos.data_ptr(), rv_cap, ne, int(rv),
                int(kw["it_max"]), float(kw["rho"]), _VKIND[vkind],
                int(kw["positivity"]), float(kw["lo"]), float(kw["hi"]),
                float(kw["dif_tol2"]), float(kw["eps"]), xo.data_ptr(),
                zo.data_ptr(), wz.data_ptr(), it.data_ptr(), dif.data_ptr(),
                c, int(in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"solve_small launch failed (CUDA error {rc})")
    fused_pfdr_solve_small.launches += 1
    return xo, zo, it, dif


fused_pfdr_solve_small.launches = 0
