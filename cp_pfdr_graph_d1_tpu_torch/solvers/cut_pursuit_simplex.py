"""Cut-pursuit outer solver for separable-loss + d1 + simplex labeling
(counterpart of ``cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex``).

Minimizes ``sum_v f_al(p_v; q_v) + sum_e la_d1 ||p_u - p_v||_1`` over
per-vertex probability vectors, by alternating a sequence of K-1
alpha-expansion binary cuts (the steepest descent search of
``CP_PFDR_graph_loss_d1_simplex.cpp:522-618``) with multi-label PFDR solves
of the component-contracted problem (:643-780).

The binary energies of each expansion cut use the Kolmogorov-Zabih
decomposition (:563-595), re-expressed in the symmetric form the min-cut
takes (unary costs + symmetric edge weights), which is algebraically
identical.

With ``cut="host"`` the cuts (native push-relabel), the components and the
contraction run on the host in numpy and scipy, and each reduced problem
goes to the staged PFDR loop of :mod:`.pfdr_simplex` on the tensors' device
(a reduced graph is a COO :class:`~..graph.GraphD1`), or to the native C++
PFDR on the host with ``host_small="on"``.  ``cut="device"`` runs the
device loop (:mod:`.cut_pursuit_simplex_device`), unless ``device_obs``
keeps this loop with the observation stages on the device.
"""
from __future__ import annotations

import dataclasses
import time as _time
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import maxflow, native
from ..config import CPOptions, numpy_dtype
from ..graph import GraphD1
from .cut_pursuit_common import (bucket, build_reduced_graph,
                                 connected_components, machine_eps,
                                 make_reduced_container, np64,
                                 pad_reduced_graph)
from .cut_pursuit_device import _run_sums
from .pfdr_simplex import d1_objective, loss_objective, pfdr_loss_d1_simplex


class CPSimplexState(NamedTuple):
    """Warm-restart state of the outer loop (host arrays)."""
    active: np.ndarray   # bool [E]
    cv: np.ndarray       # int32 [V]
    rp: np.ndarray       # [rV, K]


class CPSimplexResult(NamedTuple):
    cv: np.ndarray       # int32 [V]
    rp: np.ndarray       # [rV, K]
    it: int
    time: np.ndarray     # [it + 1] wall-clock seconds per CP iteration
    obj: np.ndarray      # [it + 1] objective trace (when monitored)
    dif: np.ndarray      # [it] evolution
    state: CPSimplexState


def _loss_grad_np(al, p_full, q):
    """Loss gradient of the full problem (``CP_PFDR_graph_loss_d1_simplex.cpp:
    327-354``), on numpy arrays (host loop) or tensors (``device_obs`` and
    the device loop) alike; the JAX package's ``_loss_grad_device`` is the
    same formula."""
    if al == 0.0:
        return -q
    if al == 1.0:
        return p_full - q
    al_k = al / q.shape[1]
    al_1 = 1.0 - al
    return -(al_k + al_1 * q) / (al_k / al_1 + p_full)


def _alpha_expansion_cuts(dfs, rdi, cv, eu, ev, la_d1, active, eps,
                          min_cut_fn=None):
    """Runs the K-1 binary expansion cuts; returns the per-vertex final
    descent counters ``djv`` (:522-606)."""
    if min_cut_fn is None:
        min_cut_fn = maxflow.min_cut
    num_v, k = dfs.shape
    djv = np.zeros(num_v, np.int32)
    # only inactive edges carry capacity; active ones get zero (:563-566)
    inact = np.nonzero(~active)[0]
    ieu, iev, ila = eu[inact], ev[inact], la_d1[inact]
    i_of_v = rdi[cv]  # confident label of each vertex's component
    rows = np.arange(num_v)
    dfs_i = dfs[rows, i_of_v]
    for n in range(1, k):
        j_of_v = np.where(n > i_of_v, n, n - 1)
        dfs_j = dfs[rows, j_of_v]
        cur = np.where(djv > i_of_v, djv, np.maximum(djv - 1, 0))
        dfs_cur = dfs[rows, cur]
        theta = np.where(
            djv == 0, dfs_j - dfs_i,
            np.where(djv == n, 0.0, dfs_j - dfs_cur))
        # pairwise: equal current directions -> symmetric 2 la; different ->
        # la with -la unary credits on both endpoints (KZ-equivalent)
        same = djv[ieu] == djv[iev]
        w = np.where(same, 2.0 * ila, ila)
        credit = np.where(same, 0.0, ila)
        np.subtract.at(theta, ieu, credit)
        np.subtract.at(theta, iev, credit)
        side = min_cut_fn(num_v, ieu, iev, w, theta)
        djv[side.astype(bool)] = n
    return djv


def _multi_process():
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def cp_loss_d1_simplex(graph: GraphD1, q, *, al: float,
                       opt: CPOptions = CPOptions(),
                       monitor: bool = False,
                       state: Optional[CPSimplexState] = None,
                       device_obs: bool = False) -> CPSimplexResult:
    """Multi-label cut-pursuit solve.

    Args:
      graph: the d1 graph, on the device of ``q``.
      q: [V, K] observation tensor (vertex-major); its dtype and device are
        the solve's.
      al: loss selector — 0 linear, 1 quadratic, in ]0,1[ smoothed-KL.
      opt: outer options; ``opt.dif_tol >= 1`` switches the stopping
        criterion to the number of changed maximum-likelihood labels.
      state: optional warm restart from a previous result's ``.state``
        (:func:`..convert.cp_simplex_state` builds one from the JAX
        package's).
      device_obs: keep the host loop but compute the O(V K) observation
        stages (loss gradient, reduced sums) on ``q``'s device; with
        ``cut="device"`` its cuts go through
        :func:`..maxflow.device.min_cut_device_with_fallback`.  Across
        processes (the JAX package's multi-host gather) it is not ported
        and raises.

    Returns component labels ``cv`` and [rV, K] component distributions
    ``rp`` (full solution ``p = rp[cv]``).
    """
    if opt.cut == "device" and not device_obs:
        # the whole iteration on the device (cuts, components, contraction,
        # merge): the multi-label twin of cut_pursuit_device
        from .cut_pursuit_simplex_device import cp_loss_d1_simplex_device
        return cp_loss_d1_simplex_device(graph, q, al=al, opt=opt,
                                         monitor=monitor, state=state)
    if device_obs and _multi_process():
        raise NotImplementedError(
            "device_obs across processes (the JAX package's multi-host "
            "gather of the gradient) is not ported yet: ROADMAP queue 1 "
            "item 11")
    t0 = _time.monotonic()
    eu, ev, la_d1 = graph.host_coo()
    num_v = graph.num_vertices
    num_e = graph.num_edges
    if q.shape[0] != num_v:
        raise ValueError(f"q has {q.shape[0]} rows for {num_v} vertices")
    k = q.shape[1]
    device = q.device
    dtype = numpy_dtype(q.dtype)
    q_np = None if device_obs else q.cpu().numpy()
    label_mode = opt.dif_tol >= 1.0

    tol_scale = opt.dif_tol / num_v if label_mode else opt.dif_tol
    ptol = (opt.pfdr.dif_tol / num_v if opt.pfdr.dif_tol >= 1
            else opt.pfdr.dif_tol)
    eps = machine_eps(dtype, min(tol_scale, ptol))

    if opt.cut == "device":
        from ..maxflow.device import min_cut_device_with_fallback
        min_cut_fn = partial(min_cut_device_with_fallback, tol=opt.cut_tol,
                             it_max=opt.cut_it_max, dtype=q.dtype,
                             device=device)
    else:
        min_cut_fn = maxflow.min_cut

    # only an explicit "on" moves reduced solves to the native host C++
    # ("auto" is off in the port)
    use_host = opt.host_small == "on"
    if use_host and not native.available():
        raise RuntimeError("host_small='on' needs the native PFDR, which did "
                           "not build")

    # -- initialization: unisimplicial solution (:66-148) -------------------
    if state is None:
        qsum = q.sum(dim=0).cpu().numpy() if device_obs else q_np.sum(axis=0)
        if al == 0.0:
            rp = np.zeros((1, k), dtype)
            rp[0, np.argmax(qsum)] = 1.0
        else:
            rp = (qsum / num_v)[None, :].astype(dtype)
        active = np.zeros(num_e, bool)
        cv = np.zeros(num_v, np.int32)
    else:
        active = np.array(state.active, bool)
        cv = np.array(state.cv, np.int32)
        rp = np.array(state.rp, dtype)

    times = [0.0]
    objs = []
    difs = []

    def objective(rp_, cv_):
        p_full = torch.as_tensor(rp_[cv_], device=device)
        return float(loss_objective(al, p_full, q, None)
                     + d1_objective(graph, p_full))

    def solve_reduced(rg, rq, rla_f, rp_start, host_reduce, rv_cap,
                      inner_it_max):
        """One reduced PFDR solve (:773-780): the native host C++ or the
        staged loop on the tensors' device; returns [rv_cap, K] rows."""
        if host_reduce:
            rp_new, _ = native.pfdr_loss_d1_simplex_host(
                np64(rq), al, rg.eu, rg.ev, np64(rg.la_d1),
                la_f=np64(rla_f) if rla_f is not None else None,
                rho=opt.pfdr.rho, cond_min=opt.pfdr.cond_min,
                dif_rcd=opt.pfdr.dif_rcd, dif_tol=opt.pfdr.dif_tol,
                it_max=inner_it_max, p0=rp_start)
            return rp_new.astype(dtype)
        reu, rev, rla = pad_reduced_graph(rg, rv_cap, bucket(len(rg.eu)))
        rgraph = make_reduced_container(reu, rev, rla, rv_cap, q.dtype,
                                        device)
        popt = (opt.pfdr if inner_it_max == opt.pfdr.it_max
                else dataclasses.replace(opt.pfdr, it_max=inner_it_max))
        res = pfdr_loss_d1_simplex(
            rgraph, torch.as_tensor(rq, device=device), al=al,
            la_f=(torch.as_tensor(rla_f, device=device)
                  if rla_f is not None else None),
            p0=torch.as_tensor(rp_start, device=device), opt=popt)
        return res.p.cpu().numpy().astype(dtype)

    if monitor:
        objs.append(objective(rp, cv))

    prev_labels = np.argmax(rp, axis=1)[cv]
    prev_p_full = rp[cv]
    it = 0
    dif = max(opt.dif_tol, 1.0)
    num_comp = rp.shape[0]

    # inexact outer loop (the quadratic family's schedule): capped
    # intermediate reduced solves + a full-accuracy polish on the settled
    # partition before returning
    inexact_on = (opt.inexact == "auto"
                  and opt.pfdr.it_max > opt.inexact_cap)
    last_capped = False
    while it < opt.it_max and dif >= opt.dif_tol:
        p_full = rp[cv]

        # -- gradient + active-edge d1 signs (:327-377) --------------------
        if device_obs:
            dfs = _loss_grad_np(
                al, torch.as_tensor(p_full, device=device), q).cpu().numpy()
        else:
            dfs = _loss_grad_np(al, p_full, q_np)
        ae = np.nonzero(active)[0]
        if len(ae):
            d = p_full[eu[ae]] - p_full[ev[ae]]
            s = np.where(d > eps, 1.0, np.where(d < -eps, -1.0, 0.0))
            s = s * la_d1[ae][:, None]
            np.add.at(dfs, eu[ae], s)
            np.add.at(dfs, ev[ae], -s)

        # -- alpha-expansion cuts (:522-606) -------------------------------
        rdi = np.argmax(rp, axis=1).astype(np.int32)
        djv = _alpha_expansion_cuts(dfs, rdi, cv, eu, ev, la_d1, active,
                                    eps, min_cut_fn=min_cut_fn)
        sep = ~active & (djv[eu] != djv[ev])
        n_new = int(sep.sum())
        active |= sep

        if n_new == 0:
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            if monitor:
                objs.append(objs[-1] if objs else float("nan"))
            continue

        # -- contraction (:643-731) ----------------------------------------
        num_comp, cv = connected_components(num_v, eu, ev,
                                            ~active & (la_d1 > 0))
        rg = build_reduced_graph(cv, num_comp, eu, ev, la_d1, active, eps)
        host_reduce = use_host and num_comp <= opt.host_small_max
        rv_cap = num_comp if host_reduce else bucket(num_comp)

        # -- reduced observations (:733-766) -------------------------------
        if device_obs:
            cv_t = torch.as_tensor(cv, device=device)
            qsum = _run_sums(q, cv_t, rv_cap).cpu().numpy().astype(dtype)
            sizes = torch.bincount(cv_t.to(torch.int64), minlength=rv_cap
                                   ).cpu().numpy().astype(dtype)
        else:
            qsum = np.zeros((rv_cap, k), dtype)
            np.add.at(qsum, cv, q_np)
            sizes = np.bincount(cv, minlength=rv_cap).astype(dtype)
        if al == 0.0:
            rq = qsum
            rp0 = np.zeros((rv_cap, k), dtype)
            rp0[np.arange(rv_cap), np.argmax(qsum, axis=1)] = 1.0
            rp0[num_comp:] = 1.0 / k  # inert uniform rows on padding
            rla_f = None
        else:
            safe = np.maximum(sizes, 1)[:, None]
            rq = qsum / safe
            rp0 = rq.copy()
            rp0[num_comp:] = 1.0 / k
            rq[num_comp:] = 1.0 / k
            rla_f = np.maximum(sizes, 0)

        # -- reduced PFDR solve (:773-780) ---------------------------------
        inner_cap = opt.inexact_cap if inexact_on else opt.pfdr.it_max
        rp = solve_reduced(rg, rq, rla_f, rp0, host_reduce, rv_cap,
                           inner_cap)[:num_comp]
        last_capped = inner_cap < opt.pfdr.it_max

        # -- merge almost-equal components (:782-804) ----------------------
        p_full = rp[cv]
        ae = np.nonzero(active)[0]
        if len(ae):
            d = np.abs(p_full[eu[ae]] - p_full[ev[ae]]).max(axis=1)
            active[ae[d <= eps]] = False

        # -- evolution + objective (:806-917) ------------------------------
        if label_mode:
            labels = np.argmax(rp, axis=1)[cv]
            dif = float((labels != prev_labels).sum())
            prev_labels = labels
        else:
            dif = float(np.abs(p_full - prev_p_full).sum()) / num_v
            prev_p_full = p_full
        difs.append(dif)
        it += 1
        times.append(_time.monotonic() - t0)
        if monitor:
            objs.append(objective(rp, cv))
        if opt.verbose:
            print(f"CP-simplex it {it}: {num_comp} components, "
                  f"{int(active.sum())} active edges, dif {dif:.3g}")

    if last_capped:
        # final full-accuracy solve on the settled partition, warm-started
        # from the capped solution; merge and trace tails recomputed
        rp_pad = rp
        if rp_pad.shape[0] < rv_cap:
            pad = np.full((rv_cap - rp_pad.shape[0], k), 1.0 / k, dtype)
            rp_pad = np.concatenate([rp_pad, pad])
        rp = solve_reduced(rg, rq, rla_f, rp_pad, host_reduce, rv_cap,
                           opt.pfdr.it_max)[:num_comp]
        p_full = rp[cv]
        ae = np.nonzero(active)[0]
        if len(ae):
            d = np.abs(p_full[eu[ae]] - p_full[ev[ae]]).max(axis=1)
            active[ae[d <= eps]] = False
        times[-1] = _time.monotonic() - t0
        if monitor:
            objs[-1] = objective(rp, cv)
    return CPSimplexResult(
        cv=cv, rp=rp, it=it,
        time=np.asarray(times),
        obj=np.asarray(objs) if monitor else np.zeros(0, dtype),
        dif=np.asarray(difs),
        state=CPSimplexState(active=active, cv=cv, rp=rp))
