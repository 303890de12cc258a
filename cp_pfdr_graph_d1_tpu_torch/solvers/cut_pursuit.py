"""Cut-pursuit outer solver for quadratic + d1 (+ l1 / bounds) problems
(counterpart of ``cp_pfdr_graph_d1_tpu.solvers.cut_pursuit``, host-cut
route).

Minimizes ``1/2 ||y - A x||^2 + sum_e la_d1 |x_u - x_v| + g(x)`` (``g`` the
l1(+positivity) or box term) by alternating steepest binary cuts on the full
graph with PFDR solves of the problem contracted onto the connected
components of inactive edges — the algorithm of
``CP_PFDR_graph_quadratic_d1_l1.cpp:212-1007`` and
``CP_PFDR_graph_quadratic_d1_bounds.cpp:207``.

With ``cut="host"`` the steepest cut (native push-relabel), the components
and the contraction run on the host in numpy and scipy.  Each reduced
problem goes, in this order, to:

1. one whole-solve kernel when the tensors lie on a CUDA device (or
   ``pfdr.fused="on"``): the reduced operator and Lipschitz metric are
   matrix products on the device, the preconditioning runs on the device,
   and one launch of :mod:`..ops.solve_small` (or, from 4096 reduced
   vertices on, of :mod:`..ops.solve_fused`) runs the whole PFDR solve.
   PFDR options the kernels do not serve (reconditioning, progress lines)
   send the reduced solves down this list with ``"auto"`` and raise with
   ``"on"`` (:func:`.cut_pursuit_common.reduced_solve_route`);
2. the native C++ PFDR on the host, only with ``host_small="on"``;
3. the staged PyTorch PFDR loop of :mod:`.pfdr_quadratic`
   (``pfdr.fused="off"``, CPU tensors with ``"auto"``, or those options).

``cut="device"`` keeps the whole iteration on the tensors' device: the
chained loop (:mod:`.cut_pursuit_chain`) or the per-iteration device loop
(:mod:`.cut_pursuit_device`), as ``CPOptions.chain`` selects.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import maxflow, native
from ..config import CPOptions, Lipsch, numpy_dtype
from ..graph import GraphD1
from ..operators import (DenseOp, DiagOp, GramOp, IdentityOp, QuadOp,
                         RankShardedOp)
from ..ops.power_iter import MatApply, dense_operator_norm, operator_norm
from ..ops.solve_fused import fused_pfdr_solve
from ..ops.solve_small import fits, fused_pfdr_solve_small
from ..utils.monitor import StageProfiler
from .cut_pursuit_common import (bucket, build_reduced_graph,
                                 component_representatives,
                                 connected_components, host_reduce_dense,
                                 host_reduce_diag, host_reduce_gram,
                                 machine_eps, make_reduced_container, np64,
                                 pad_reduced_graph, reduced_solve_route)
from .pfdr_quadratic import (VertexProx, initial_precondition,
                             pfdr_quadratic_d1)

# dense/Gram operators larger than this are not copied to the host for the
# cut gradient and the native route
_HOST_OP_MAX_ELEMS = 32 * 1024 * 1024


class CPState(NamedTuple):
    """Warm-restart state of the outer loop (the reference's
    ``CPql1_Restart``)."""
    active: np.ndarray   # bool [E] cut-pursuit active-edge flags
    cv: np.ndarray       # int32 [V] component labels
    rx: np.ndarray       # [rV] component values


class CPResult(NamedTuple):
    cv: np.ndarray       # int32 [V]
    rx: np.ndarray       # [rV]
    it: int
    time: np.ndarray     # [it + 1] wall-clock seconds per CP iteration
    obj: np.ndarray      # [it + 1] objective trace (when monitored)
    dif: np.ndarray      # [it] iterate evolution
    state: CPState


# ---------------------------------------------------------------------------
# device stages
# ---------------------------------------------------------------------------

def _objective(op: QuadOp, obs, x_full, graph: GraphD1, la_l1):
    obj = op.quad_obj(x_full, obs)
    xu, xv = graph.gather_endpoints(x_full)
    obj = obj + (graph.la_d1 * (xu - xv).abs()).sum()
    if la_l1 is not None:
        obj = obj + (la_l1 * x_full.abs()).sum()
    return obj


def _one_hot(cv, rv_cap: int, dtype):
    return torch.nn.functional.one_hot(cv.to(torch.int64), rv_cap).to(dtype)


def _equilibrated_norm(raa, rv_cap: int):
    """Jacobi-equilibrated power-method scale ``c`` of a reduced Gram."""
    d = torch.sqrt(torch.clamp(torch.diagonal(raa), min=0))
    d_safe = torch.where(d > 0, d, torch.ones_like(d))
    eq = raa / (d_safe[:, None] * d_safe[None, :])
    return operator_norm(MatApply(eq), rv_cap, raa.dtype, raa.device)


def _reduce_dense(a, obs, cv, rv_cap: int, pre_at: bool):
    """Reduced operator, observation and DIAG Lipschitz metric for the dense
    mode (``CP_PFDR_graph_quadratic_d1_l1.cpp:663-836``): component column
    sums as a one-hot matrix product."""
    return reduced_dense(a @ _one_hot(cv, rv_cap, a.dtype), obs, rv_cap,
                         pre_at)


def reduced_dense(ra, obs, rv_cap: int, pre_at: bool):
    """Tail of :func:`_reduce_dense` from the component column sums ``ra``
    [N, rv_cap] (the distributed operators gather them first)."""
    if pre_at:
        raa = ra.T @ ra
        ry = ra.T @ obs
        return raa, ry, torch.diagonal(raa) * _equilibrated_norm(raa, rv_cap)
    cn = torch.sqrt((ra * ra).sum(dim=0))
    cn_safe = torch.where(cn > 0, cn, torch.ones_like(cn))
    c = dense_operator_norm(ra / cn_safe)
    return ra, obs, cn * cn * c


def _reduce_gram(gram, obs, cv, rv_cap: int):
    """Reduced quantities for the premultiplied (A^t A) mode."""
    s = _one_hot(cv, rv_cap, gram.dtype)
    return reduced_gram(s.T @ (gram @ s), obs @ s, rv_cap)


def reduced_gram(raa, ry, rv_cap: int):
    """Tail of :func:`_reduce_gram` from the reduced Gram ``raa`` and
    observation ``ry`` (the distributed operators sum them first)."""
    return raa, ry, torch.diagonal(raa) * _equilibrated_norm(raa, rv_cap)


def _reduce_diag(diag, obs, cv, rv_cap: int):
    """Reduced quantities for the diagonal/identity mode: the reduced Gram
    stays diagonal and is its own Lipschitz metric (``:774-776``)."""
    s = _one_hot(cv, rv_cap, obs.dtype)
    rdiag = diag @ s
    return rdiag, obs @ s, rdiag


def _reduce_operator(kind: str, op_arr, obs, cv, rv_cap: int, pre_at: bool):
    """``(r_op, mat, ry, lipsch)`` of the problem contracted onto ``cv``,
    for an operator of kind "dense", "gram" or "diag", or "dist" (then
    ``op_arr`` is the operator: its ``reduced`` method sums the reduction
    over the ranks it is sharded on, and every rank gets the same reduced
    problem; one-hot products at every size, as for the other kinds)."""
    if kind == "dist":
        return op_arr.reduced(obs, cv, rv_cap, pre_at, onehot_max=rv_cap)
    if kind == "dense":
        mat, ry, lipsch = _reduce_dense(op_arr, obs, cv, rv_cap, pre_at)
        return (GramOp(mat) if pre_at else DenseOp(mat)), mat, ry, lipsch
    if kind == "gram":
        mat, ry, lipsch = _reduce_gram(op_arr, obs, cv, rv_cap)
        return GramOp(mat), mat, ry, lipsch
    mat, ry, lipsch = _reduce_diag(op_arr, obs, cv, rv_cap)
    return DiagOp(mat), mat, ry, lipsch


# from this many reduced vertices on, by operator kind, solve_fused (every
# SM of the card) takes the reduced solves (chip_smoke.py's crossover
# lines, PERF.md).  On an NVIDIA H100 80GB HBM3 at 700 W, per 300 float32
# iterations of the EEG problem's first reduced problem (rv_cap 4096),
# solve_small on a cluster of 16 CTAs beats solve_fused on the dense
# operator (3.471 against 5.699 ms); the diagonal one runs in one block and
# loses (4.960 against 3.199).  Dense rv_cap 8192 and Gram operators from
# rv_cap 1024 on were not measured, so they keep solve_fused
SOLVE_FUSED_MIN_RV_CAP = {"dense": 8192, "gram": 4096, "diag": 4096}


def _op_kind(r_op: QuadOp) -> str:
    """The whole-solve kernels' name of a reduced operator's kind."""
    if isinstance(r_op, DenseOp):
        return "dense"
    return "diag" if isinstance(r_op, DiagOp) else "gram"


def kernel_solve_inputs(r_op: QuadOp, mat, ry, lipsch, rgraph: GraphD1,
                        r_la_l1, x0, rv: int, *, vprox: VertexProx,
                        rho: float, dif_tol: float, sort_edges: bool):
    """Arguments of the whole-solve kernels for one reduced problem: the
    preconditioning on the reduced graph, then the vertex rows, the edge
    rows (sorted stably by their smaller endpoint with ``sort_edges``, the
    order ``solve_fused`` takes) and the options.  Returns ``(args, kw)``
    for :func:`..ops.solve_small.fused_pfdr_solve_small` or
    :func:`..ops.solve_fused.fused_pfdr_solve` (``it_max`` not
    included)."""
    pre = initial_precondition(r_op, ry, rgraph, r_la_l1, rho, lipsch,
                               Lipsch.DIAG)
    op_kind = _op_kind(r_op)
    aty = r_op.apply_t(ry) if op_kind == "dense" else ry
    eu, ev = rgraph.eu, rgraph.ev
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    if sort_edges:
        perm = torch.sort(torch.minimum(eu, ev), stable=True).indices
        eu, ev, ec = eu[perm], ev[perm], ec[:, perm].contiguous()
    args = (op_kind, mat.contiguous(), aty.contiguous(), pre.ga.contiguous(),
            pre.th_l1.contiguous(), x0.contiguous(),
            torch.stack([x0[eu], x0[ev]]), ec, eu, ev)
    kw = dict(rv=rv, rho=rho, vkind=vprox.kind, positivity=vprox.positivity,
              lo=float(vprox.lo), hi=float(vprox.hi),
              dif_tol2=float(dif_tol) ** 2,
              eps=machine_eps(numpy_dtype(ry.dtype), dif_tol))
    return args, kw


def fits_small(r_op: QuadOp, mat, rv_cap: int) -> bool:
    """Whether the reduced problem fits the solve_small kernel (its
    one-block limit, :func:`..ops.solve_small.fits`)."""
    n_rows = mat.shape[0] if isinstance(r_op, DenseOp) else 0
    return fits(rv_cap, n_rows, mat.dtype)


def _kernel_solve(r_op: QuadOp, mat, ry, lipsch, rgraph: GraphD1, r_la_l1,
                  x0, rv: int, it_max: int, *, vprox: VertexProx, rho: float,
                  dif_tol: float):
    """Whole reduced PFDR solve in one kernel launch
    (:func:`kernel_solve_inputs`): :mod:`..ops.solve_small` when the
    problem fits it (:func:`fits_small`) and has fewer vertices than
    ``SOLVE_FUSED_MIN_RV_CAP`` gives for its operator's kind, else
    :mod:`..ops.solve_fused`.
    The two compute the same function, so the choice changes speed, not
    the result beyond float rounding.  CPU tensors run the kernels' plain
    versions.

    Args:
      r_op, mat, ry, lipsch: reduced operator, its array, observation and
        DIAG Lipschitz metric (:func:`_reduce_operator`).
      rgraph: reduced graph over ``rv_cap = rgraph.num_vertices`` vertices
        (components ``>= rv`` are padding; padding edges have weight 0).
      r_la_l1: [rv_cap] summed l1 weights, or None.
      x0: [rv_cap] warm start.

    Returns:
      ``(x [rv_cap], it)`` with ``it`` a 0-d int32 tensor.
    """
    small = (rgraph.num_vertices < SOLVE_FUSED_MIN_RV_CAP[_op_kind(r_op)]
             and fits_small(r_op, mat, rgraph.num_vertices))
    args, kw = kernel_solve_inputs(r_op, mat, ry, lipsch, rgraph, r_la_l1,
                                   x0, rv, vprox=vprox, rho=rho,
                                   dif_tol=dif_tol, sort_edges=not small)
    if small:
        x, _, it, _ = fused_pfdr_solve_small(*args, it_max=it_max, **kw)
    else:
        x, _, it, _ = fused_pfdr_solve(*args, it_max=it_max, **kw)
    return x, it


def _reduce_solve_small(op_arr, obs, cv, rgraph: GraphD1, r_la_l1, x0,
                        it_max: int, rv: int, *, kind: str, pre_at: bool,
                        vprox: VertexProx, rho: float, dif_tol: float):
    """One reduced cut-pursuit stage of the kernel route (counterpart of
    the JAX package's ``_reduce_solve_small``): the reduced operator and
    Lipschitz metric (:func:`_reduce_operator`, ``op_arr`` the full
    operator's array, ``cv`` int [V] labels on the device), then
    :func:`_kernel_solve`.  Returns ``(x [rv_cap], it)``."""
    r_op, mat, ry, lipsch = _reduce_operator(kind, op_arr, obs, cv,
                                             rgraph.num_vertices, pre_at)
    return _kernel_solve(r_op, mat, ry, lipsch, rgraph, r_la_l1, x0, rv,
                         it_max, vprox=vprox, rho=rho, dif_tol=dif_tol)


# ---------------------------------------------------------------------------
# host-side steepest cut
# ---------------------------------------------------------------------------

def _steepest_cut(dfs, x_full, eu, ev, la_d1, active, la_l1, positivity,
                  lo, hi, differentiable):
    """Runs the one or two min-cuts of a CP iteration; returns the updated
    active mask and the number of newly activated edges
    (``CP_PFDR_graph_quadratic_d1_l1.cpp:410-549``, bounds analog
    ``CP_PFDR_graph_quadratic_d1_bounds.cpp:390-532``)."""
    inact = ~active
    ieu, iev, ila = eu[inact], ev[inact], la_d1[inact]
    num_v = len(dfs)

    def cut(c):
        side = maxflow.min_cut(num_v, ieu, iev, ila, c)
        return side[ieu] != side[iev]

    if differentiable:
        sep = cut(dfs)
    else:
        zero = x_full == 0
        if la_l1 is not None:
            c1 = dfs + np.where(zero, la_l1, 0.0)
            if positivity:
                c2 = np.where(zero, np.inf, -dfs)
            else:
                c2 = -dfs + np.where(zero, la_l1, 0.0)
        else:
            # bounds family: moves blocked where the bound binds
            c1 = np.where(x_full == hi, np.inf, dfs) if np.isfinite(hi) \
                else dfs
            c2 = np.where(x_full == lo, np.inf, -dfs) if np.isfinite(lo) \
                else -dfs
        sep = cut(c1) | cut(c2)

    new_active = active.copy()
    idx = np.nonzero(inact)[0][sep]
    new_active[idx] = True
    return new_active, len(idx)


def _duplex_cut(dfs, x_full, eu, ev, la_d1, active, la_l1, positivity):
    """Single two-layer ternary cut replacing the two directional cuts
    (``CP_PFDR_graph_quadratic_d1_l1_duplex.cpp:468-549``)."""
    num_v = len(dfs)
    zero = x_full == 0
    if la_l1 is not None:
        up = dfs + np.where(zero, la_l1, 0.0)
        do = dfs - np.where(zero, la_l1, 0.0)
    else:
        up = dfs.copy()
        do = dfs.copy()
    if positivity:
        do = np.where(zero, -np.inf, do)
    m = np.maximum(0.0, np.maximum(-up, do))
    c = np.concatenate([-do + m, -(up + m)])
    inact = ~active
    ieu, iev, ila = eu[inact], ev[inact], la_d1[inact]
    rng_v = np.arange(num_v, dtype=np.int32)
    eeu = np.concatenate([ieu, ieu + num_v, rng_v])
    eev = np.concatenate([iev, iev + num_v, rng_v + num_v])
    # the reference's arc v1->v2 (capacity m) is paid when v1 keeps and v2
    # moves; in the U-membership convention that is the arc v2->v1
    w_uv = np.concatenate([ila, ila, np.zeros(num_v)])
    w_vu = np.concatenate([ila, ila, m])
    side = maxflow.min_cut_directed(2 * num_v, eeu, eev, w_uv, w_vu, c)
    sep = (side[ieu] != side[iev]) | (side[ieu + num_v] != side[iev + num_v])
    new_active = active.copy()
    idx = np.nonzero(inact)[0][sep]
    new_active[idx] = True
    return new_active, len(idx)


def _d1_sign_terms(dfs, x_full, eu, ev, la_d1, active):
    """Adds the differentiable d1 contribution of active edges
    (``CP_PFDR_graph_quadratic_d1_l1.cpp:376-391``), in place."""
    ae = np.nonzero(active)[0]
    if not len(ae):
        return
    d = x_full[eu[ae]] - x_full[ev[ae]]
    s = np.sign(d) * la_d1[ae]
    np.add.at(dfs, eu[ae], s)
    np.add.at(dfs, ev[ae], -s)


def _merge_close(x_full, eu, ev, active, eps, dif_tol):
    """Deactivates active edges whose endpoint values are relatively equal
    (``CP_PFDR_graph_quadratic_d1_l1.cpp:863-886``), in place."""
    ae = np.nonzero(active)[0]
    if len(ae):
        a = x_full[eu[ae]]
        b = x_full[ev[ae]]
        d = np.abs(a - b)
        amax = np.maximum(np.abs(a), np.abs(b))
        rel = np.where(amax > eps, d / np.maximum(amax, eps), d / eps)
        active[ae[rel <= dif_tol]] = False


# ---------------------------------------------------------------------------
# main solver
# ---------------------------------------------------------------------------

def cp_quadratic_d1(op: QuadOp, obs, graph: GraphD1, *,
                    la_l1=None, positivity: bool = False,
                    bounds=None, duplex: bool = False,
                    opt: CPOptions = CPOptions(),
                    monitor: bool = False,
                    state: Optional[CPState] = None) -> CPResult:
    """Cut-pursuit solve; returns component labels ``cv`` and values ``rx``
    (full solution ``x = rx[cv]``), plus ``Time``/``Obj``/``Dif`` traces.

    Args:
      op: quadratic operator (Dense / Gram / Diag / Identity), its tensors
        on the device of ``obs``.
      obs: observation tensor in the operator's convention; its dtype and
        device are the solve's.
      graph: the d1 graph on the same device.
      la_l1: optional [V] (or scalar) l1 weights — selects the l1 family.
      positivity: adds the nonnegativity constraint (l1 family).
      bounds: optional (lo, hi) scalars — selects the bounds family
        (mutually exclusive with la_l1/positivity).
      duplex: one two-layer ternary cut instead of two directional cuts.
      state: optional warm restart from a previous result's ``.state``
        (:func:`..convert.cp_state` builds one from the JAX package's).
    """
    if bounds is not None and (la_l1 is not None or positivity):
        raise ValueError("bounds is exclusive with la_l1/positivity")
    if opt.cut == "device":
        # the whole iteration on the device: the chained loop when the
        # problem admits it, else the per-iteration device loop
        from .cut_pursuit_chain import chain_admissible, \
            cp_quadratic_d1_chain
        from .cut_pursuit_device import cp_quadratic_d1_device
        kw = dict(la_l1=la_l1, positivity=positivity, bounds=bounds, opt=opt,
                  state=state)
        if chain_admissible(op, graph, opt, duplex, monitor, obs):
            return cp_quadratic_d1_chain(op, obs, graph, **kw)
        return cp_quadratic_d1_device(op, obs, graph, duplex=duplex,
                                      monitor=monitor, **kw)
    t0 = _time.monotonic()
    prof = StageProfiler()
    eu, ev, la_d1 = graph.host_coo()
    num_v = graph.num_vertices
    num_e = graph.num_edges
    device = obs.device
    tdtype = obs.dtype
    dtype = numpy_dtype(tdtype)

    lo, hi = (-np.inf, np.inf) if bounds is None else (
        float(bounds[0]), float(bounds[1]))
    if la_l1 is not None:
        if isinstance(la_l1, torch.Tensor):
            la_l1 = la_l1.detach().cpu().numpy()
        la_l1 = np.broadcast_to(np.asarray(la_l1, dtype), (num_v,)).copy()
    differentiable = (la_l1 is None and not positivity
                      and not (np.isfinite(lo) or np.isfinite(hi)))
    if bounds is not None:
        vprox = VertexProx(kind="bounds", lo=lo, hi=hi)
    elif la_l1 is not None:
        vprox = VertexProx(kind="l1", positivity=positivity)
    elif positivity:
        vprox = VertexProx(kind="l1", positivity=True)
        la_l1 = np.zeros(num_v, dtype)
    else:
        vprox = VertexProx()

    eps = machine_eps(dtype, opt.dif_tol)
    dif_tol2 = opt.dif_tol * opt.dif_tol
    la_l1_dev = (torch.as_tensor(la_l1, device=device)
                 if la_l1 is not None else None)

    def mon_objective(x_full_np):
        return float(_objective(op, obs, torch.as_tensor(x_full_np,
                                                         device=device),
                                graph, la_l1_dev))

    # host copies of the operator: the cut gradient is a host matvec, and
    # the host_small route solves reduced problems in native C++.  Only an
    # explicit "on" moves work to the host ("auto" is off in the port)
    use_host = opt.host_small == "on"
    if use_host and not native.available():
        raise RuntimeError("host_small='on' needs the native PFDR, which did "
                           "not build")
    a_np = gram_np = diag_np = None
    y_np = None
    if use_host:
        y_np = np64(obs)
        if isinstance(op, DenseOp) and op.a.numel() <= _HOST_OP_MAX_ELEMS:
            a_np = np64(op.a)
            a_t_np = np.ascontiguousarray(a_np.T)
        elif isinstance(op, GramOp) and op.gram.numel() <= _HOST_OP_MAX_ELEMS:
            gram_np = np64(op.gram)
        elif isinstance(op, DiagOp):
            diag_np = np64(op.diag)
        elif isinstance(op, IdentityOp):
            diag_np = np.ones(num_v)
        la_l1_64 = (np.asarray(la_l1, np.float64)
                    if la_l1 is not None else None)

    # reduced problems go to the solve_small kernel on a CUDA device (its
    # wrapper runs the plain version for CPU tensors, with fused="on")
    dev_route = reduced_solve_route(opt.pfdr, obs.is_cuda) == "kernel"
    if isinstance(op, RankShardedOp):  # sharded over ranks
        kind, op_arr = "dist", op
    elif isinstance(op, DenseOp):
        kind, op_arr = "dense", op.a
    elif isinstance(op, GramOp):
        kind, op_arr = "gram", op.gram
    elif isinstance(op, DiagOp):
        kind, op_arr = "diag", op.diag
    else:
        kind, op_arr = "diag", torch.ones(num_v, dtype=tdtype, device=device)

    # -- initialization: single component, scalar prox solve (:66-175) ------
    if state is None:
        if a_np is not None:
            a1 = a_np.sum(axis=1)
            ry1, raa1 = float(a1 @ y_np), float(a1 @ a1)
        elif gram_np is not None:
            ry1, raa1 = float(y_np.sum()), float(gram_np.sum())
        elif diag_np is not None:
            ry1, raa1 = float(y_np.sum()), float(diag_np.sum())
        else:
            ry1, raa1 = (float(v) for v in op.ones_image(num_v, obs))
        if bounds is not None:
            x1 = min(max(ry1 / raa1, lo), hi)
        else:
            rl1 = float(la_l1.sum()) if la_l1 is not None else 0.0
            if ry1 > rl1:
                x1 = (ry1 - rl1) / raa1
            elif not positivity and ry1 < -rl1:
                x1 = (ry1 + rl1) / raa1
            else:
                x1 = 0.0
        active = np.zeros(num_e, bool)
        cv = np.zeros(num_v, np.int32)
        rx = np.asarray([x1], dtype)
    else:
        active = np.array(state.active, bool)
        cv = np.array(state.cv, np.int32)
        rx = np.array(state.rx, dtype)

    times = [0.0]
    objs = []
    difs = []
    x_prev = rx[cv]
    if monitor:
        objs.append(mon_objective(x_prev))

    prof.tick("init")
    pfdr_it_prev = opt.pfdr.it_max
    it = 0
    dif = max(dif_tol2, 1.0)
    num_comp = len(rx)
    # inexact outer loop: intermediate reduced solves are capped while the
    # partition still changes; the settled partition is polished at full
    # accuracy at the end
    inexact_on = (opt.inexact == "auto"
                  and opt.pfdr.it_max > opt.inexact_cap)
    last_capped = False
    x_prev2 = x_prev

    def pfdr_opt(inner_it_max):
        if inner_it_max == opt.pfdr.it_max:
            return opt.pfdr
        return dataclasses.replace(opt.pfdr, it_max=inner_it_max)

    def pre_at_rule(n_obs):
        return num_comp < (2 * n_obs * pfdr_it_prev) // (
            n_obs + pfdr_it_prev)

    def reduced_l1(rv_cap, cv):
        if la_l1 is None:
            return None
        r = np.zeros(rv_cap, dtype)
        np.add.at(r, cv, la_l1)
        return torch.as_tensor(r, device=device)

    def solve_reduced(rg, cv, num_comp, rx0, inner_it_max):
        """Solves the reduced problem on the current partition through the
        first route that applies (module docstring); returns the [rV]
        component values."""
        nonlocal pfdr_it_prev
        n_obs = (op_arr.num_obs if kind == "dist"
                 else op_arr.shape[0] if kind == "dense" else 0)
        pre_at = n_obs > 0 and pre_at_rule(n_obs)
        if dev_route:
            rv_cap = max(bucket(num_comp), 128)
            e_cap = max(bucket(len(rg.eu)), 128)
            reu, rev, rla = pad_reduced_graph(rg, rv_cap, e_cap)
            rgraph = make_reduced_container(reu, rev, rla, rv_cap, tdtype,
                                            device)
            x0 = np.zeros(rv_cap, dtype)
            x0[:num_comp] = rx0
            x, it_d = _reduce_solve_small(
                op_arr, obs, torch.as_tensor(cv, device=device), rgraph,
                reduced_l1(rv_cap, cv), torch.as_tensor(x0, device=device),
                inner_it_max, num_comp, kind=kind, pre_at=pre_at,
                vprox=vprox, rho=float(opt.pfdr.rho),
                dif_tol=float(opt.pfdr.dif_tol))
            pfdr_it_prev = max(int(it_d), 1)
            return x.cpu().numpy()[:num_comp].astype(dtype)
        if (use_host and num_comp <= opt.host_small_max
                and (a_np is not None or gram_np is not None
                     or diag_np is not None)):
            # -- host route: numpy reduce + native C++ PFDR -----------------
            if a_np is not None:
                mode, mat, ry, lipsch = host_reduce_dense(
                    a_t_np, y_np, cv, num_comp, pre_at)
            elif gram_np is not None:
                mat, ry, lipsch = host_reduce_gram(gram_np, y_np, cv,
                                                   num_comp)
                mode = -1
            else:
                mat, ry, lipsch = host_reduce_diag(diag_np, y_np, cv,
                                                   num_comp)
                mode = 0
            r_la_l1 = None
            if la_l1 is not None:
                r_la_l1 = np.zeros(num_comp)
                np.add.at(r_la_l1, cv, la_l1_64)
            rx_new, pfdr_it = native.pfdr_quadratic_d1_host(
                mode, mat, ry, rg.eu, rg.ev,
                np.asarray(rg.la_d1, np.float64), la_l1=r_la_l1,
                positivity=vprox.positivity,
                bounds=(lo, hi) if bounds is not None else None,
                lip_diag=np.asarray(lipsch, np.float64),
                rho=opt.pfdr.rho, cond_min=opt.pfdr.cond_min,
                dif_rcd=opt.pfdr.dif_rcd, dif_tol=opt.pfdr.dif_tol,
                it_max=inner_it_max, x0=rx0)
            pfdr_it_prev = max(pfdr_it, 1)
            return rx_new.astype(dtype)
        # -- staged route: reduced operator on the device + PFDR loop --------
        rv_cap = bucket(num_comp)
        reu, rev, rla = pad_reduced_graph(rg, rv_cap, bucket(len(rg.eu)))
        rgraph = make_reduced_container(reu, rev, rla, rv_cap, tdtype,
                                        device)
        r_op, _, ry, lipsch = _reduce_operator(
            kind, op_arr, obs, torch.as_tensor(cv, device=device), rv_cap,
            pre_at)
        x0 = np.zeros(rv_cap, dtype)
        x0[:num_comp] = rx0
        # -- reduced PFDR solve (:842-859) -----------------------------------
        res = pfdr_quadratic_d1(
            r_op, ry, rgraph, la_l1=reduced_l1(rv_cap, cv), vprox=vprox,
            lipsch=lipsch, ltype=Lipsch.DIAG,
            x0=torch.as_tensor(x0, device=device),
            opt=pfdr_opt(inner_it_max))
        pfdr_it_prev = max(res.it, 1)
        return res.x.cpu().numpy()[:num_comp].astype(dtype)

    while it < opt.it_max and dif >= dif_tol2:
        x_full = rx[cv]

        # -- steepest cut (:337-549) ---------------------------------------
        if a_np is not None:
            dfs = (a_np.T @ (a_np @ x_full - y_np)).astype(dtype)
        elif gram_np is not None:
            dfs = (gram_np @ x_full - y_np).astype(dtype)
        elif diag_np is not None:
            dfs = (diag_np * x_full - y_np).astype(dtype)
        else:
            dfs = op.grad(torch.as_tensor(x_full, device=device),
                          obs).cpu().numpy().astype(dtype)
        _d1_sign_terms(dfs, x_full, eu, ev, la_d1, active)
        if la_l1 is not None:
            dfs += np.sign(x_full) * la_l1
        prof.tick("gradient")
        if duplex and not differentiable and bounds is None:
            active, n_new = _duplex_cut(
                dfs, x_full, eu, ev, la_d1, active, la_l1, positivity)
        else:
            active, n_new = _steepest_cut(
                dfs, x_full, eu, ev, la_d1, active, la_l1, positivity, lo,
                hi, differentiable)

        prof.tick("cut")
        if n_new == 0:  # nothing to recompute (:556-563)
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            if monitor:
                objs.append(objs[-1] if objs else float("nan"))
            continue

        # -- contraction (:568-661) ----------------------------------------
        # zero-weight edges (e.g. stencil padding) never join components
        num_comp, cv = connected_components(num_v, eu, ev,
                                            ~active & (la_d1 > 0))
        rg = build_reduced_graph(cv, num_comp, eu, ev, la_d1, active, eps)
        # warm start: every vertex of a component carries the same value
        rx0 = x_full[component_representatives(cv)]
        prof.tick("contract")

        inner_cap = opt.inexact_cap if inexact_on else opt.pfdr.it_max
        rx = solve_reduced(rg, cv, num_comp, rx0, inner_cap)
        last_capped = inner_cap < opt.pfdr.it_max
        prof.tick("reduced-solve")
        x_full = rx[cv]
        _merge_close(x_full, eu, ev, active, eps, opt.dif_tol)

        # -- evolution + objective (:889-975) ------------------------------
        x_prev2 = x_prev
        delta = x_full - x_prev
        den = float(np.dot(x_full, x_full))
        dif = float(np.dot(delta, delta)) / (den if den > eps else eps)
        difs.append(dif)
        x_prev = x_full
        it += 1
        times.append(_time.monotonic() - t0)
        if monitor:
            objs.append(mon_objective(x_full))
        prof.tick("merge+trace")
        if opt.verbose:
            print(f"CP it {it}: {num_comp} components, "
                  f"{int(active.sum())} active edges, dif {dif:.3g}, "
                  f"PFDR it {pfdr_it_prev}")

    if last_capped and num_comp == len(rx):
        # final full-accuracy solve on the settled partition (rx is its own
        # warm start); merge and the last trace entries are recomputed
        rx = solve_reduced(rg, cv, num_comp, rx, opt.pfdr.it_max)
        x_full = rx[cv]
        _merge_close(x_full, eu, ev, active, eps, opt.dif_tol)
        delta = x_full - x_prev2
        den = float(np.dot(x_full, x_full))
        difs[-1] = float(np.dot(delta, delta)) / (den if den > eps else eps)
        times[-1] = _time.monotonic() - t0
        if monitor:
            objs[-1] = mon_objective(x_full)
        prof.tick("final-polish")
    prof.report()
    return CPResult(
        cv=cv, rx=rx, it=it,
        time=np.asarray(times),
        obj=np.asarray(objs) if monitor else np.zeros(0, dtype),
        dif=np.asarray(difs),
        state=CPState(active=active, cv=cv, rx=rx))
