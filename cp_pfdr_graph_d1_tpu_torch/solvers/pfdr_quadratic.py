"""Preconditioned forward-Douglas-Rachford for quadratic + d1 problems
(counterpart of ``cp_pfdr_graph_d1_tpu.solvers.pfdr_quadratic``).

Solves, over a graph ``G = (V, E)``::

    min_x  1/2 ||y - A x||^2  +  sum_{(u,v) in E} la_d1(uv) |x_u - x_v|
           + sum_v la_l1(v) |x_v|  (+ indicator of x >= 0)     [l1 family]
           + sum_v indicator of lo <= x_v <= hi                [bounds family]

Numerics follow the reference exactly
(``PFDR_graph_quadratic_d1_l1.cpp:57-268`` for the preconditioner and
``:353-532`` for the iteration), as in the JAX package.

The loop is a Python loop over eager PyTorch operations.  The stopping test
reads the evolution back to the host every iteration (one device
synchronisation per iteration on CUDA), so the iteration count equals the
JAX package's.  On a stencil, circulant or banded graph with the tensors
on a CUDA device the edge and vertex stage of each iteration is one
hand-written kernel (:mod:`..ops.stencil_fused`, :mod:`..ops.circulant_fused`,
:mod:`..ops.banded_fused`); the gradient ``A^t(A x - y)`` stays a matrix
product outside it, as in the JAX package.  An unmonitored solve on a
:class:`~..banded_graph.BandedGraphD1` (no ``monitor``, ``verbose`` or
``dif_rcd``) runs whole in one launch of :mod:`..ops.solve_fused`, as the
JAX package's banded whole-solve branch does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..banded_graph import BandedGraphD1
from ..config import Lipsch, PFDROptions
from ..graph import GraphD1
from ..operators import DenseOp, DiagOp, GramOp, IdentityOp, QuadOp
from ..ops.prox import d1_pair_prox, vertex_prox_plain
from ..ops.solve_fused import fused_pfdr_solve
from ..ops.stencil_fused import MAX_FAMILIES


class VertexProx(NamedTuple):
    """Description of the separable vertex term ``g_v``."""
    kind: str = "none"          # "none" | "l1" | "bounds"
    positivity: bool = False    # only for kind == "l1"
    lo: float = -math.inf       # only for kind == "bounds"
    hi: float = math.inf


class Precond(NamedTuple):
    """Preconditioning products (reference ``preconditioning()`` outputs)."""
    ga: torch.Tensor       # [V] diagonal descent metric Gamma
    wu: torch.Tensor       # [E] splitting weights (sum to 1 per vertex)
    wv: torch.Tensor
    w_d1u: torch.Tensor    # [E] normalized d1-prox weights
    w_d1v: torch.Tensor
    th_d1: torch.Tensor    # [E] d1 soft-threshold levels
    th_l1: torch.Tensor    # [V] l1 soft-threshold levels (zeros when unused)


class PFDRResult(NamedTuple):
    x: torch.Tensor
    it: int
    obj: torch.Tensor   # [it_max + 1]; entries beyond ``it`` are zero
    dif: torch.Tensor   # [it_max + 1]; entries from ``it`` on are zero


class PFDRSolveState(NamedTuple):
    """Complete loop state: resuming from it reproduces the uninterrupted
    trajectory.  Obtain with ``pfdr_quadratic_d1(..., return_state=True)``
    and pass back as ``state0=`` with the same graph, operator, options and
    dtype.  :func:`..convert.pfdr_solve_state` builds one from the JAX
    package's state."""
    x: torch.Tensor
    zu: torch.Tensor
    zv: torch.Tensor
    pre: Precond
    x_prev: torch.Tensor
    dif: torch.Tensor
    dif_rcd2: torch.Tensor
    it: int


def _safe_div(num, den, fill=0.0):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       fill)


def _amplitude_scale(graph, x, inverse: bool):
    """Mean amplitude over nonzero coordinates
    (``PFDR_graph_quadratic_d1_l1.cpp:145-154``): its inverse at initial
    preconditioning, itself at reconditioning."""
    n = graph.vertex_allsum((x != 0).to(x.dtype))
    s = graph.vertex_allsum(x.abs())
    if inverse:
        return _safe_div(n, s, 1.0)
    return _safe_div(s, n, 1.0)


def _metric_cap(inv_h, rho, lipsch, ltype: Lipsch):
    """Caps the metric at ``1.9 (2 - rho) / L``
    (``PFDR_graph_quadratic_d1_l1.cpp:224-239``)."""
    a = 1.9 * (2.0 - rho)
    if lipsch is None:
        return torch.clamp(inv_h, max=a)
    if ltype is Lipsch.SCAL:
        if isinstance(lipsch, torch.Tensor):
            return torch.minimum(inv_h, a / lipsch)
        return torch.clamp(inv_h, max=a / lipsch)
    return torch.where(lipsch > 0,
                       torch.minimum(inv_h, _safe_div(a, lipsch, math.inf)),
                       inv_h)


def _finalize_precond(graph: GraphD1, h, wu_raw, wv_raw, la_l1, l1_h_term,
                      rho, lipsch, ltype) -> Precond:
    """Common tail of initial- and re-conditioning
    (``PFDR_graph_quadratic_d1_l1.cpp:193-267``)."""
    aux = graph.vertex_degree_weighted(wu_raw)
    h = h + aux
    inv_aux = _safe_div(1.0, aux, 0.0)
    inv_u, inv_v = graph.gather_endpoints(inv_aux)
    wu = wu_raw * inv_u
    wv = wv_raw * inv_v
    if la_l1 is not None:
        h = h + l1_h_term
    ga = _safe_div(1.0, h, 1.0)
    ga = _metric_cap(ga, rho, lipsch, ltype)

    gau, gav = graph.gather_endpoints(ga)
    w_d1u = wu / gau
    w_d1v = wv / gav
    s = w_d1u + w_d1v
    prod = w_d1u * w_d1v
    th_d1 = torch.where(prod > 0, graph.la_d1 * _safe_div(s, prod), 0.0)
    w_d1u = _safe_div(w_d1u, s, 0.5)
    w_d1v = _safe_div(w_d1v, s, 0.5)
    th_l1 = ga * la_l1 if la_l1 is not None else torch.zeros_like(ga)
    return Precond(ga, wu, wv, w_d1u, w_d1v, th_d1, th_l1)


def initial_precondition(op: QuadOp, obs, graph: GraphD1,
                         la_l1, rho, lipsch, ltype) -> Precond:
    """First preconditioning, from the observation
    (``PFDR_graph_quadratic_d1_l1.cpp:57-268`` with ``P == NULL``)."""
    h = op.gram_diag(graph.num_vertices, obs.dtype, obs.device)
    if op.uses_residual:
        pinv = _safe_div(op.apply_t(obs), h)
    else:
        pinv = _safe_div(obs, h)
    c = _amplitude_scale(graph, pinv, inverse=True)
    w_raw = c * graph.la_d1
    l1_h = c * la_l1 if la_l1 is not None else None
    return _finalize_precond(graph, h, w_raw, w_raw, la_l1, l1_h,
                             rho, lipsch, ltype)


def recondition(op: QuadOp, obs, graph: GraphD1, la_l1, rho, cond_min,
                lipsch, ltype, x, grad, zu, zv, pre: Precond):
    """Reconditioning at the current iterate, preserving subgradients
    (``PFDR_graph_quadratic_d1_l1.cpp:89-99,159-250`` with ``P != NULL``)."""
    xu, xv = graph.gather_endpoints(x)
    gau, gav = graph.gather_endpoints(pre.ga)
    gu, gv = graph.gather_endpoints(grad)
    sub_u = (pre.wu / gau) * (xu - gau * gu - zu)
    sub_v = (pre.wv / gav) * (xv - gav * gv - zv)

    h = op.gram_diag(graph.num_vertices, obs.dtype, obs.device)
    c = _amplitude_scale(graph, x, inverse=False)
    amp = torch.maximum(torch.maximum(xu.abs(), xv.abs()), c)
    d = torch.maximum((xu - xv).abs(), cond_min * amp)
    w_raw = _safe_div(graph.la_d1, d)
    if la_l1 is not None:
        l1_h = la_l1 / torch.maximum(x.abs(), c * cond_min)
    else:
        l1_h = None
    new = _finalize_precond(graph, h, w_raw, w_raw, la_l1, l1_h,
                            rho, lipsch, ltype)
    ngau, ngav = graph.gather_endpoints(new.ga)
    zu = xu - ngau * (gu + _safe_div(sub_u, new.wu))
    zv = xv - ngav * (gv + _safe_div(sub_v, new.wv))
    return new, zu, zv


def _tv(graph, x):
    xu, xv = graph.gather_endpoints(x)
    return graph.edge_allsum(graph.la_d1 * (xu - xv).abs())


def _full_obj(op: QuadOp, x, obs, graph: GraphD1, la_l1, vprox: VertexProx):
    """Objective: quadratic + d1 + (l1) terms
    (``PFDR_graph_quadratic_d1_l1.cpp:388-422``; the reference's stale-index
    bug at :417 is not reproduced)."""
    obj = op.quad_obj(x, obs) + _tv(graph, x)
    if la_l1 is not None and vprox.kind == "l1":
        obj = obj + graph.vertex_allsum(la_l1 * x.abs())
    return obj


def fused_route(opt: PFDROptions, graph, obs) -> bool:
    """Whether the iteration goes through a fused stage kernel's wrapper
    (stencil, circulant and banded containers): "auto" when the tensors lie
    on a CUDA device, "on" always.  A stencil the kernel cannot take raises
    rather than running the staged loop in its place."""
    if (opt.fused == "off" or not hasattr(graph, "fused_iteration")
            or not getattr(graph, "supports_fused", True)):
        return False
    if not (opt.fused == "on" or obs.is_cuda):
        return False
    f = len(graph.shifts) if hasattr(graph, "shifts") else 0
    if f > MAX_FAMILIES:
        raise ValueError(
            f"stencil of {f} shift families; the stencil_fused kernel takes "
            f"at most {MAX_FAMILIES} (pass PFDROptions(fused='off') for the "
            f"staged loop)")
    return True


def _whole_solve_kind(op: QuadOp, graph) -> str | None:
    """Operator kind of the whole-solve kernel (:mod:`..ops.solve_fused`)
    for a banded graph, or None."""
    if not isinstance(graph, BandedGraphD1) or not graph.supports_fused:
        return None
    if isinstance(op, DenseOp):
        return "dense"
    if isinstance(op, GramOp):
        return "gram"
    if isinstance(op, (DiagOp, IdentityOp)):
        return "diag"
    return None


def whole_solve_inputs(op: QuadOp, obs, graph: BandedGraphD1,
                       vprox: VertexProx, pre: Precond, x0, zu0, zv0,
                       opt: PFDROptions, op_kind: str, it0: int = 0):
    """``(args, kw)`` of the :func:`..ops.solve_fused.fused_pfdr_solve`
    call of :func:`_whole_solve`.  The banded edge order is the order that
    kernel takes (sorted stably by the smaller endpoint)."""
    nv = graph.num_vertices
    if op_kind == "dense":
        mat, aty = op.a, op.apply_t(obs)
    elif op_kind == "gram":
        mat, aty = op.gram, obs
    else:
        mat = (torch.ones(nv, dtype=obs.dtype, device=obs.device)
               if isinstance(op, IdentityOp) else op.diag)
        aty = obs
    eps_mach = torch.finfo(obs.dtype).eps
    eps = opt.dif_tol if 0 < opt.dif_tol < eps_mach else eps_mach
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    args = (op_kind, mat.contiguous(), aty.contiguous(), pre.ga.contiguous(),
            pre.th_l1.contiguous(), x0.contiguous(), torch.stack([zu0, zv0]),
            ec, graph.eu, graph.ev)
    kw = dict(rv=nv, it_max=opt.it_max, rho=float(opt.rho), vkind=vprox.kind,
              positivity=vprox.positivity, lo=float(vprox.lo),
              hi=float(vprox.hi), dif_tol2=float(opt.dif_tol) ** 2, eps=eps,
              it0=it0)
    return args, kw


def _whole_solve(op: QuadOp, obs, graph: BandedGraphD1, vprox: VertexProx,
                 pre: Precond, x0, zu0, zv0, opt: PFDROptions, op_kind: str,
                 it0: int = 0):
    """The complete solve in one launch of :func:`..ops.solve_fused
    .fused_pfdr_solve` (its plain version for CPU tensors), from the
    iterate ``x0`` and auxiliary pairs ``zu0``/``zv0`` after ``it0``
    iterations: ``(x, zu, zv, it, dif)``."""
    args, kw = whole_solve_inputs(op, obs, graph, vprox, pre, x0, zu0, zv0,
                                  opt, op_kind, it0)
    x, z, it, dif = fused_pfdr_solve(*args, **kw)
    return x, z[0], z[1], int(it), dif


def pfdr_quadratic_d1(op: QuadOp, obs, graph: GraphD1, *,
                      la_l1=None,
                      vprox: VertexProx = VertexProx(),
                      lipsch=None,
                      ltype: Lipsch = Lipsch.SCAL,
                      x0=None,
                      opt: PFDROptions = PFDROptions(),
                      monitor: bool = False,
                      state0: PFDRSolveState | None = None,
                      return_state: bool = False):
    """Runs the PFDR iteration to convergence.

    Args:
      op: quadratic-term operator (see :mod:`..operators`).
      obs: observation tensor in the operator's convention ([N] or [V]);
        its dtype and device are the solve's.
      graph: the d1 graph, on the same device.
      la_l1: optional [V] l1 weights (l1 family only).
      vprox: vertex-prox description.
      lipsch: optional Lipschitz bound (scalar, or [V] with ``ltype=DIAG``).
      x0: initial iterate (defaults to zeros).
      monitor: when True, records objective and evolution traces.
      state0: optional :class:`PFDRSolveState` from an earlier
        ``return_state=True`` call; resumes exactly where it stopped (same
        graph, operator and options required); ``x0`` is ignored.
      return_state: when True, returns ``(result, PFDRSolveState)``.

    Returns:
      :class:`PFDRResult`.  Trace contract, as in the JAX package: ``obj``
      and ``dif`` have length ``it_max + 1``; only ``obj[:it + 1]`` and
      ``dif[:it]`` are meaningful and the rest is zero.  When
      ``monitor=False`` they are one-element zero placeholders.
    """
    vcount = graph.num_vertices
    dtype, device = obs.dtype, obs.device
    if x0 is None:
        x0 = torch.zeros(vcount, dtype=dtype, device=device)
    if la_l1 is not None:
        la_l1 = torch.as_tensor(la_l1, dtype=dtype,
                                device=device).expand(vcount)

    eps_mach = torch.finfo(dtype).eps
    dif_tol = opt.dif_tol
    eps = dif_tol if 0 < dif_tol < eps_mach else eps_mach
    dif_tol2 = dif_tol * dif_tol
    dif_rcd2 = opt.dif_rcd * opt.dif_rcd
    rho = float(opt.rho)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    if state0 is not None:
        pre, zu, zv, x = state0.pre, state0.zu, state0.zv, state0.x
        x_prev, dif, dif_rcd2_t = state0.x_prev, state0.dif, state0.dif_rcd2
        it = int(state0.it)
    else:
        pre = initial_precondition(op, obs, graph, la_l1, rho, lipsch, ltype)
        zu, zv = graph.gather_endpoints(x0)
        x = x_prev = x0
        dif = scalar(max(dif_tol2, dif_rcd2))
        dif_rcd2_t = scalar(dif_rcd2)
        it = 0
    fused = fused_route(opt, graph, obs)
    whole_kind = _whole_solve_kind(op, graph) if fused else None
    if (whole_kind is not None and not monitor and opt.verbose == 0
            and opt.dif_rcd == 0):
        x, zu, zv, it, dif = _whole_solve(
            op, obs, graph, vprox, pre, x, zu, zv, opt, whole_kind, it0=it)
        res = PFDRResult(x=x, it=it, obj=obs.new_zeros(1),
                         dif=obs.new_zeros(1))
        if return_state:
            return res, PFDRSolveState(x=x, zu=zu, zv=zv, pre=pre, x_prev=x,
                                       dif=dif, dif_rcd2=scalar(0.0), it=it)
        return res

    n_trace = opt.it_max + 1 if monitor else 1
    obj_trace = torch.zeros(n_trace, dtype=dtype, device=device)
    dif_trace = torch.zeros(n_trace, dtype=dtype, device=device)

    while it < opt.it_max and bool(dif >= dif_tol2):
        grad = op.grad(x, obs)
        if monitor:
            obj = op.quad_obj(x, obs) + _tv(graph, x)
            if la_l1 is not None:
                obj = obj + graph.vertex_allsum(la_l1 * x.abs())
            obj_trace[it] = obj

        # reconditioning (:448-460)
        if opt.dif_rcd > 0 and bool(dif < dif_rcd2_t):
            pre, zu, zv = recondition(op, obs, graph, la_l1, rho,
                                      opt.cond_min, lipsch, ltype, x, grad,
                                      zu, zv, pre)
            dif_rcd2_t = dif_rcd2_t * scalar(0.01)

        if fused:
            x_new, zu, zv, num, den = graph.fused_iteration(
                x, grad, pre, zu, zv, rho, vprox)
        else:
            # forward step P = 2 X - Ga grad (:463-464)
            p = 2.0 * x - pre.ga * grad
            # per-edge d1 prox on auxiliary pairs, with relaxation (:466-489)
            pxu, pxv = graph.gather_endpoints(torch.stack([p, x], dim=-1))
            au = pxu[..., 0] - zu
            av = pxv[..., 0] - zv
            pu, pv = d1_pair_prox(au, av, pre.w_d1u, pre.w_d1v, pre.th_d1)
            zu = zu + rho * (pu - pxu[..., 1])
            zv = zv + rho * (pv - pxv[..., 1])
            # weighted average back to the iterate (:491-497)
            x_new = graph.edge_to_vertex_sum(pre.wu * zu, pre.wv * zv)
            # vertex prox (:499-512)
            x_new = vertex_prox_plain(x_new, pre.th_l1, vprox.kind,
                                      vprox.positivity, vprox.lo, vprox.hi)
            delta = x_new - x_prev
            num = graph.vertex_allsum(delta * delta)
            den = graph.vertex_allsum(x_new * x_new)

        # relative iterate evolution (:514-529)
        num = num.to(dtype)
        den = den.to(dtype)
        dif = torch.where(den > eps, num / den, num / eps)
        if monitor:
            dif_trace[it] = dif
        if opt.verbose and (it + 1) % opt.verbose == 0:
            print(f"PFDR iteration {it + 1} (max. {opt.it_max}); "
                  f"relative evolution {float(dif):.3e} "
                  f"(tol {dif_tol:.1e})", flush=True)
        x = x_prev = x_new
        it += 1

    if monitor:
        obj_trace[it] = _full_obj(op, x, obs, graph, la_l1, vprox)
    res = PFDRResult(x=x, it=it, obj=obj_trace, dif=dif_trace)
    if return_state:
        return res, PFDRSolveState(x=x, zu=zu, zv=zv, pre=pre,
                                   x_prev=x_prev, dif=dif,
                                   dif_rcd2=dif_rcd2_t, it=it)
    return res
