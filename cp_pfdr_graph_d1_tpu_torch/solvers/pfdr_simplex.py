"""Preconditioned forward-Douglas-Rachford for loss + d1 + simplex problems
(counterpart of ``cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex``).

Solves, for ``K`` labels over a graph ``G = (V, E)``::

    min_{p_v in simplex}  sum_v  f_al(p_v; q_v)
                          + sum_{(u,v) in E} la_d1(uv) ||p_u - p_v||_1

with the loss keyed on the scalar ``al`` as in the reference
(``PFDR_graph_loss_d1_simplex.cpp:372-726``):

* ``al == 0``  — linear loss ``-<p, q>`` (zero Hessian; the d1-prox weights
  collapse to 1/2 and the thresholds to 2, reference :599-614),
* ``al == 1``  — quadratic loss ``1/2 la_f ||p - q||^2``,
* ``0 < al < 1`` — smoothed Kullback-Leibler
  ``KL(al/K + (1-al) q, al/K + (1-al) p)``.

State is vertex-major ``[V, K]``, as in the JAX package; the vertex prox is
the Michelot simplex projection in the metric ``Gamma``
(:func:`..ops.prox.proj_simplex_metric`).

Two loops compute the same iteration.  The staged loop runs eager PyTorch
operations on any graph container.  On a :class:`~..stencil.StencilGraphD1`
or a :class:`~..circulant.CirculantGraphD1` whose tensors lie on a CUDA
device (``PFDROptions.fused="auto"``), or with ``fused="on"``, each
iteration is one launch of the hand-written kernel
:mod:`..ops.stencil_fused_simplex` or :mod:`..ops.circulant_fused_simplex`
(their plain versions for CPU tensors); that loop carries the container's
label planes, converts once at entry and once at exit, and between
launches for monitoring, progress lines and reconditioning.  Both loops
read the evolution back to the host once per iteration, so the iteration
count is the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PFDROptions
from ..graph import GraphD1
from ..ops.prox import d1_pair_prox, proj_simplex_metric
from ..ops.stencil_fused import MAX_FAMILIES
from ..ops.stencil_fused_simplex import MAX_LABELS
from .pfdr_quadratic import _safe_div


class SimplexPrecond(NamedTuple):
    ga: torch.Tensor       # [V, K] descent metric (unnormalized)
    ga_proj: torch.Tensor  # [V, K] per-vertex max-normalized (projection)
    wu: torch.Tensor       # [E, K] splitting weights
    wv: torch.Tensor
    w_d1u: torch.Tensor    # [E, K] normalized d1 prox weights
    w_d1v: torch.Tensor
    th_d1: torch.Tensor    # [E, K] d1 thresholds


class SimplexState(NamedTuple):
    """Carry of the staged loop."""
    p: torch.Tensor
    zu: torch.Tensor
    zv: torch.Tensor
    pre: SimplexPrecond
    prev: torch.Tensor     # last iterate [V, K], or ML labels [V, 1]
    dif: torch.Tensor
    dif_rcd: torch.Tensor
    it: int


class SimplexResult(NamedTuple):
    p: torch.Tensor
    it: int
    obj: torch.Tensor   # [it_max + 1] when monitored; entries beyond it zero
    dif: torch.Tensor   # [it_max + 1] when monitored; entries from it zero


class SimplexSolveState(NamedTuple):
    """Complete loop state of the multi-label PFDR: resuming from it
    reproduces the uninterrupted trajectory.  Obtain with
    ``pfdr_loss_d1_simplex(..., return_state=True)`` and pass back as
    ``state0=`` with the same graph container, observations, options and
    dtype.  :func:`..convert.simplex_solve_state` builds one from the JAX
    package's state."""
    p: torch.Tensor
    zu: torch.Tensor
    zv: torch.Tensor
    pre: SimplexPrecond
    prev: torch.Tensor
    dif: torch.Tensor
    dif_rcd: torch.Tensor
    it: int


def _loss_grad(al: float, p, q, la_f):
    """Gradient of the separable loss (``PFDR_graph_loss_d1_simplex.cpp:
    144-156`` for the three cases)."""
    if al == 0.0:
        return -q
    if al == 1.0:
        g = p - q
    else:
        al_k = al / q.shape[-1]
        al_1 = 1.0 - al
        g = -al_1 * (al_k + al_1 * q) / (al_k + al_1 * p)
    if la_f is not None:
        g = la_f[:, None] * g
    return g


def _loss_hessian(al: float, p, q, la_f):
    """Diagonal Hessian estimate (:160-190)."""
    if al == 0.0:
        return torch.zeros_like(q)
    if al == 1.0:
        h = torch.ones_like(q)
    else:
        al_k = al / q.shape[-1]
        al_1 = 1.0 - al
        denom = al_k / al_1 + p
        h = (al_k + al_1 * q) / (denom * denom)
    if la_f is not None:
        h = la_f[:, None] * h
    return h


def _loss_lipschitz(al: float, q, la_f):
    """Per-coordinate Lipschitz bound of the loss gradient (:249-285);
    None for the linear loss (L = 0, no cap)."""
    if al == 0.0:
        return None
    if al == 1.0:
        lip = torch.ones_like(q)
    else:
        al_k = al / q.shape[-1]
        al_1 = 1.0 - al
        lip = (al_k + al_1 * q) / ((al_k / al_1) ** 2)
    if la_f is not None:
        lip = la_f[:, None] * lip
    return lip


def loss_pervertex(al: float, p, q, la_f):
    """Per-vertex loss values [V] (:476-526)."""
    if al == 0.0:
        per_v = -(p * q).sum(dim=-1)
    elif al == 1.0:
        per_v = 0.5 * ((p - q) ** 2).sum(dim=-1)
    else:
        al_k = al / q.shape[-1]
        al_1 = 1.0 - al
        c = al_k + al_1 * q
        per_v = (c * torch.log(c / (al_k + al_1 * p))).sum(dim=-1)
    if la_f is not None:
        per_v = la_f * per_v
    return per_v


def loss_objective(al: float, p, q, la_f):
    """Loss part of the objective (:476-526), a 0-d tensor."""
    return loss_pervertex(al, p, q, la_f).sum()


def d1_objective(graph: GraphD1, p):
    """d1 part of the objective, a 0-d tensor."""
    pu, pv = graph.gather_endpoints(p)
    return graph.edge_allsum(graph.la_d1 * (pu - pv).abs().sum(dim=-1))


def _precondition_simplex(al, la_f, graph: GraphD1, q, p, rho,
                          edge_w_raw) -> SimplexPrecond:
    """Metric and splitting weights from raw per-(edge, label) d1 weights
    ``edge_w_raw`` (:159-306)."""
    h = _loss_hessian(al, p, q, la_f)
    aux = graph.edge_to_vertex_sum(edge_w_raw, edge_w_raw)
    inv_aux = _safe_div(1.0, aux)
    inv_u, inv_v = graph.gather_endpoints(inv_aux)
    wu = edge_w_raw * inv_u
    wv = edge_w_raw * inv_v
    if al == 0.0:
        ga = inv_aux
    else:
        ga = _safe_div(1.0, h + aux, 1.0)
    cap_amt = 1.9 * (2.0 - rho)
    lip = _loss_lipschitz(al, q, la_f)
    if lip is not None:
        ga = torch.minimum(ga, cap_amt / lip)
    if al == 0.0:
        # linear loss: fixed prox weights 1/2 and thresholds 2 (:599-614)
        w_d1u = torch.full_like(wu, 0.5)
        w_d1v = torch.full_like(wv, 0.5)
        th_d1 = torch.full_like(wu, 2.0)
    else:
        gau, gav = graph.gather_endpoints(ga)
        w_d1u = wu / gau
        w_d1v = wv / gav
        s = w_d1u + w_d1v
        prod = w_d1u * w_d1v
        th_d1 = torch.where(prod > 0,
                            graph.la_d1[:, None] * _safe_div(s, prod), 0.0)
        w_d1u = _safe_div(w_d1u, s, 0.5)
        w_d1v = _safe_div(w_d1v, s, 0.5)
    # per-vertex max-normalization for projection stability (:360-369)
    ga_proj = _safe_div(ga, ga.amax(dim=-1, keepdim=True), 1.0)
    return SimplexPrecond(ga, ga_proj, wu, wv, w_d1u, w_d1v, th_d1)


def initial_precondition_simplex(al, la_f, graph, q, p, rho):
    w_raw = graph.la_d1[:, None].expand(graph.num_edges, q.shape[-1])
    return _precondition_simplex(al, la_f, graph, q, p, rho, w_raw)


def recondition_simplex(al, la_f, graph, q, p, rho, cond_min, zu, zv,
                        pre: SimplexPrecond):
    """Reconditioning preserving subgradients (:92-157, 337-358)."""
    g = _loss_grad(al, p, q, la_f)
    pu, pv = graph.gather_endpoints(p)
    gau, gav = graph.gather_endpoints(pre.ga)
    gu, gv = graph.gather_endpoints(g)
    sub_u = (pre.wu / gau) * (pu - gau * gu - zu)
    sub_v = (pre.wv / gav) * (pv - gav * gv - zv)
    d = torch.clamp((pu - pv).abs(), min=cond_min)
    w_raw = graph.la_d1[:, None] / d
    new = _precondition_simplex(al, la_f, graph, q, p, rho, w_raw)
    ngau, ngav = graph.gather_endpoints(new.ga)
    zu = pu - ngau * (gu + _safe_div(sub_u, new.wu))
    zv = pv - ngav * (gv + _safe_div(sub_v, new.wv))
    return new, zu, zv


def _ml_labels(p):
    """Maximum-likelihood labels (the first maximum on ties)."""
    return torch.argmax(p, dim=-1)


def fused_simplex_route(opt: PFDROptions, graph, q) -> bool:
    """Whether the solve runs the kernel loop: on a container with a fused
    multi-label stage (stencil or circulant), "auto" when the tensors lie
    on a CUDA device and the container's kernel takes the label count
    (``supports_fused_simplex``: at most ``MAX_LABELS`` labels, and on a
    stencil at most ``MAX_FAMILIES`` families; any other runs the staged
    loop, as in the JAX package), "on" always.  "on" with a label or
    family count the kernels cannot take raises."""
    if (opt.fused == "off"
            or not hasattr(graph, "fused_simplex_iteration")):
        return False
    if not (opt.fused == "on" or q.is_cuda):
        return False
    k = q.shape[-1]
    f = len(getattr(graph, "shifts", ()))
    if opt.fused == "on" and (f > MAX_FAMILIES or k > MAX_LABELS):
        raise ValueError(
            f"{type(graph).__name__} with {k} labels"
            + (f" and {f} shift families" if f else "")
            + f"; the fused multi-label kernels take at most {MAX_LABELS} "
            f"labels (stencils at most {MAX_FAMILIES} families); pass "
            f"PFDROptions(fused='off' or 'auto') for the staged loop")
    return graph.supports_fused_simplex(k)


def _simplex_fused_loop(graph, q, p0, la_f, pre: SimplexPrecond, *,
                        al: float, opt: PFDROptions, has_laf: bool,
                        label_mode: bool, monitor: bool = False, state0=None,
                        return_state: bool = False, step=None):
    """Whole-iteration kernel loop on a stencil or circulant container,
    resumable through ``state0``.  It carries the container's label planes
    (``[K, H, W]`` and ``[F, K, H, W]`` on a stencil, ``[K, V]`` and
    ``[K, E]`` on a circulant container: ``graph.vertex_planes`` and
    ``graph.edge_planes``); the objective of ``monitor``, the progress
    lines of ``verbose`` and the reconditioning of ``dif_rcd > 0`` convert
    the planes between launches and compute what the staged loop computes.
    ``step`` replaces the iteration (by default
    ``graph.fused_simplex_iteration``, the kernel's wrapper)."""
    vcount = graph.vertex_count_global()
    dtype, device = q.dtype, q.device
    rho = float(opt.rho)
    if step is None:
        step = graph.fused_simplex_iteration
    tv, vt = graph.vertex_planes, graph.vertex_rows
    te, ev = graph.edge_planes, graph.edge_rows

    def planes(pre):
        return (tv(pre.ga), tv(pre.ga_proj),
                [te(a) for a in (pre.wu, pre.wv, pre.w_d1u, pre.w_d1v,
                                 pre.th_d1)])

    def objective(p):
        return (graph.vertex_allsum(loss_pervertex(al, p, q, la_f))
                + d1_objective(graph, p))

    if state0 is not None:
        zu0, zv0 = state0.zu, state0.zv
    else:
        zu0, zv0 = graph.gather_endpoints(p0)
    p3 = tv(p0)
    q3 = tv(q)
    laf3 = tv(la_f[:, None] if has_laf
              else torch.zeros((graph.num_vertices, 1), dtype=dtype,
                               device=device))
    ga3, gap3, edges = planes(pre)
    zu, zv = te(zu0), te(zv0)
    if state0 is not None:
        prev = tv(state0.prev)
        dif, dif_rcd, it = state0.dif, state0.dif_rcd, int(state0.it)
    else:
        prev = tv(_ml_labels(p0).to(dtype)[:, None]) if label_mode else p3
        dif = torch.tensor(max(opt.dif_tol, opt.dif_rcd), dtype=dtype,
                           device=device)
        dif_rcd = torch.tensor(opt.dif_rcd, dtype=dtype, device=device)
        it = 0
    n_trace = opt.it_max + 1 if monitor else 1
    obj_trace = torch.zeros(n_trace, dtype=dtype, device=device)
    dif_trace = torch.zeros(n_trace, dtype=dtype, device=device)
    while it < opt.it_max and bool(dif >= opt.dif_tol):
        if monitor:
            obj_trace[it] = objective(vt(p3))
        if opt.dif_rcd > 0 and bool(dif < dif_rcd):
            pre, zu_e, zv_e = recondition_simplex(
                al, la_f, graph, q, vt(p3), rho, opt.cond_min, ev(zu),
                ev(zv), pre)
            ga3, gap3, edges = planes(pre)
            zu, zv = te(zu_e), te(zv_e)
            dif_rcd = dif_rcd * 0.1
        p3, prev, zu, zv, dif_sum = step(
            p3, q3, laf3, ga3, gap3, prev, zu, zv, *edges, rho=rho, al=al,
            has_laf=has_laf, label_mode=label_mode)
        dif = dif_sum if label_mode else dif_sum / vcount
        if monitor:
            dif_trace[it] = dif
        if opt.verbose and (it + 1) % opt.verbose == 0:
            print(f"PFDR iteration {it + 1} (max. {opt.it_max}); "
                  f"relative evolution {float(dif):.3e} "
                  f"(tol {opt.dif_tol:.1e})", flush=True)
        it += 1
    p = vt(p3)
    if monitor:
        obj_trace[it] = objective(p)
    res = SimplexResult(p=p, it=it, obj=obj_trace, dif=dif_trace)
    if return_state:
        return res, SimplexSolveState(
            p=p, zu=ev(zu), zv=ev(zv), pre=pre, prev=vt(prev), dif=dif,
            dif_rcd=dif_rcd, it=it)
    return res


def pfdr_loss_d1_simplex(graph: GraphD1, q, *, al: float, la_f=None,
                         p0=None, opt: PFDROptions = PFDROptions(),
                         monitor: bool = False,
                         state0: SimplexSolveState | None = None,
                         return_state: bool = False):
    """Runs the multi-label PFDR iteration.

    Args:
      graph: the d1 graph, on the device of ``q``.
      q: [V, K] observations (vertex-major; rows need not be normalized for
        the linear loss); its dtype and device are the solve's.
      al: loss selector — 0 linear, 1 quadratic, in ]0,1[ smoothed-KL.
      la_f: optional [V] (or scalar) per-vertex loss weights.
      p0: initial point (defaults to the uniform distribution).
      opt: PFDR options; ``dif_tol >= 1`` stops on the number of changed
        maximum-likelihood labels.
      monitor: when True, records objective and evolution traces.
      state0: optional :class:`SimplexSolveState` from an earlier
        ``return_state=True`` call; resumes exactly where it stopped (same
        graph, observations and options); ``p0`` is ignored.
      return_state: when True, returns ``(result, SimplexSolveState)``.

    Returns:
      :class:`SimplexResult`.  Trace contract, as in the JAX package: with
      ``monitor`` the traces have length ``it_max + 1``, only
      ``obj[:it + 1]`` and ``dif[:it]`` are meaningful and the rest is zero;
      otherwise they are one-element zero placeholders.
    """
    dtype, device = q.dtype, q.device
    vcount, k = q.shape
    if p0 is None:
        p0 = torch.full_like(q, 1.0 / k)
    has_laf = la_f is not None
    laf = (torch.as_tensor(la_f, dtype=dtype, device=device).expand(vcount)
           if has_laf else None)
    al = float(al)
    label_mode = opt.dif_tol >= 1.0
    if state0 is not None:
        pre, p0 = state0.pre, state0.p
    else:
        pre = initial_precondition_simplex(al, laf, graph, q, p0, opt.rho)
    if fused_simplex_route(opt, graph, q):
        return _simplex_fused_loop(
            graph, q, p0, laf, pre, al=al, opt=opt, has_laf=has_laf,
            label_mode=label_mode, monitor=monitor, state0=state0,
            return_state=return_state)

    rho = float(opt.rho)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    if state0 is not None:
        s = SimplexState(p=p0, zu=state0.zu, zv=state0.zv, pre=pre,
                         prev=state0.prev, dif=state0.dif,
                         dif_rcd=state0.dif_rcd, it=int(state0.it))
    else:
        zu, zv = graph.gather_endpoints(p0)
        prev = (_ml_labels(p0).to(dtype)[:, None] if label_mode else p0)
        s = SimplexState(p=p0, zu=zu, zv=zv, pre=pre, prev=prev,
                         dif=scalar(max(opt.dif_tol, opt.dif_rcd)),
                         dif_rcd=scalar(opt.dif_rcd), it=0)
    n_trace = opt.it_max + 1 if monitor else 1
    obj_trace = torch.zeros(n_trace, dtype=dtype, device=device)
    dif_trace = torch.zeros(n_trace, dtype=dtype, device=device)

    def objective(p):
        return (graph.vertex_allsum(loss_pervertex(al, p, q, laf))
                + d1_objective(graph, p))

    while s.it < opt.it_max and bool(s.dif >= opt.dif_tol):
        if monitor:
            obj_trace[s.it] = objective(s.p)
        pre, zu, zv, dif_rcd = s.pre, s.zu, s.zv, s.dif_rcd
        if opt.dif_rcd > 0 and bool(s.dif < s.dif_rcd):
            pre, zu, zv = recondition_simplex(al, laf, graph, q, s.p, rho,
                                              opt.cond_min, zu, zv, pre)
            dif_rcd = dif_rcd * scalar(0.1)

        # forward step FP = 2P - Ga grad (:567-587)
        g = _loss_grad(al, s.p, q, laf)
        fp = 2.0 * s.p - pre.ga * g
        # per-(edge, label) d1 prox with relaxation (:589-634)
        fpu, fpv = graph.gather_endpoints(fp)
        spu, spv = graph.gather_endpoints(s.p)
        pu, pv = d1_pair_prox(fpu - zu, fpv - zv, pre.w_d1u, pre.w_d1v,
                              pre.th_d1)
        zu = zu + rho * (pu - spu)
        zv = zv + rho * (pv - spv)
        # weighted average (:636-648), simplex projection in metric Ga
        # (:650-651)
        p = graph.edge_to_vertex_sum(pre.wu * zu, pre.wv * zv)
        p = proj_simplex_metric(p, pre.ga_proj, 1.0)

        # iterate evolution (:653-691)
        if label_mode:
            labels = _ml_labels(p).to(dtype)[:, None]
            dif = graph.vertex_allsum((labels != s.prev).to(dtype))
            prev = labels
        else:
            dif = (graph.vertex_allsum((p - s.prev).abs())
                   / graph.vertex_count_global())
            prev = p
        if monitor:
            dif_trace[s.it] = dif
        if opt.verbose and (s.it + 1) % opt.verbose == 0:
            print(f"PFDR iteration {s.it + 1} (max. {opt.it_max}); "
                  f"relative evolution {float(dif):.3e} "
                  f"(tol {opt.dif_tol:.1e})", flush=True)
        s = SimplexState(p=p, zu=zu, zv=zv, pre=pre, prev=prev, dif=dif,
                         dif_rcd=dif_rcd, it=s.it + 1)

    if monitor:
        obj_trace[s.it] = objective(s.p)
    res = SimplexResult(p=s.p, it=s.it, obj=obj_trace, dif=dif_trace)
    if return_state:
        return res, SimplexSolveState(p=s.p, zu=s.zu, zv=s.zv, pre=s.pre,
                                      prev=s.prev, dif=s.dif,
                                      dif_rcd=s.dif_rcd, it=s.it)
    return res
