"""Device-resident cut-pursuit iteration for the multi-label family
(counterpart of ``cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex_device``).

The host loop (:mod:`.cut_pursuit_simplex`) keeps the alpha-expansion
bookkeeping, the components and the contraction on the host.  Here the
whole iteration stays on the tensors' device, following the reference outer
loop ``CP_PFDR_graph_loss_d1_simplex.cpp:186-926``:

* loss gradient + active-edge d1 sign terms as edge/vertex maps
  (``:327-377``);
* the K-1 alpha-expansion binary cuts (``:522-606``) as certified PDHG
  min-cuts, warm-started per label from the previous CP iteration's cut: on
  a stencil graph through the kernel of :mod:`..ops.mincut_fused` (its
  plain version for CPU tensors), on a COO graph through the plain loop of
  :mod:`..maxflow.device`, on the CPU only (the JAX package runs that cut
  as plain jnp: there is no TPU kernel to port).  The Kolmogorov-Zabih
  pairwise decomposition is
  re-expressed as symmetric weights plus unary credits, as in the host
  loop.  The certificates stack on the device and are read once per CP
  iteration.  A cut that misses its certificate within ``cut_it_max``
  steps continues from its own iterates on the device for up to
  ``CONTINUE_FACTOR`` times as many more, and the cuts after it (they
  consumed its labels) are solved again; what is still uncertified raises
  on a CUDA device and, for CPU tensors, warns and redoes the whole
  expansion sequence on the host push-relabel, as the JAX package does;
* components, contraction: the device stages of the quadratic loop
  (:mod:`.cut_pursuit_device`), the components through
  :mod:`..ops.components_fused` on a stencil graph;
* reduced observations (component sums and sizes, ``:733-766``) as
  deterministic segment sums over the vertices sorted by component;
* the reduced solve: the staged loop of :mod:`.pfdr_simplex` on the
  contracted COO graph; merge and evolution tests elementwise on the device.
"""
from __future__ import annotations

import time as _time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import maxflow
from ..config import CPOptions, numpy_dtype
from ..graph import GraphD1
from ..maxflow.device import _pdhg_min_cut
from ..ops.mincut_fused import cut_problem, fused_pdhg_min_cut
from ..stencil import StencilGraphD1
from .cut_pursuit_common import (bucket, machine_eps,
                                 make_reduced_container)
from .cut_pursuit_device import (CONTINUE_FACTOR, _contract_pad,
                                 _contract_sort, _device_components,
                                 _run_sums, device_cut_supported)
from .cut_pursuit_simplex import (CPSimplexResult, CPSimplexState,
                                  _alpha_expansion_cuts, _loss_grad_np)
from .pfdr_simplex import d1_objective, loss_objective, pfdr_loss_d1_simplex


def _direction_costs_simplex(graph: GraphD1, q, p_full, active, al: float,
                             eps: float):
    """Loss gradient + active-edge d1 sign terms, [V, K] on the device
    (``CP_PFDR_graph_loss_d1_simplex.cpp:327-377``)."""
    dfs = _loss_grad_np(al, p_full, q)
    pu, pv = graph.gather_endpoints(p_full)
    d = pu - pv
    s = (d > eps).to(d.dtype) - (d < -eps).to(d.dtype)
    s = s * (graph.la_d1 * active)[:, None]
    return dfs + graph.edge_to_vertex_sum(s, -s)


def _sel_label(dfs, idx):
    """``dfs[v, idx[v]]``."""
    return torch.gather(dfs, 1, idx.to(torch.int64)[:, None])[:, 0]


def _expansion_capacities(graph: GraphD1, dfs, i_of_v, djv, active, n: int):
    """Unary costs and symmetric edge weights of expansion cut ``n``
    (``:539-595``; the KZ decomposition as weights + unary credits, see the
    host twin :func:`.cut_pursuit_simplex._alpha_expansion_cuts`)."""
    dfs_i = _sel_label(dfs, i_of_v)
    j_of_v = torch.where(i_of_v < n, n, n - 1)
    dfs_j = _sel_label(dfs, j_of_v)
    cur = torch.where(djv > i_of_v, djv, torch.clamp(djv - 1, min=0))
    dfs_cur = _sel_label(dfs, cur)
    theta = torch.where(djv == 0, dfs_j - dfs_i,
                        torch.where(djv == n, 0.0, dfs_j - dfs_cur))
    du, dv = graph.gather_endpoints(djv)
    same = du == dv
    la = graph.la_d1
    valid = ~active & (la > 0)
    w = torch.where(valid, torch.where(same, 2.0 * la, la), 0.0)
    credit = torch.where(valid & ~same, la, 0.0)
    return w, theta - graph.edge_to_vertex_sum(credit, credit)


def _device_side(graph: GraphD1, w, c, tol: float, it_max: int,
                 check_every: int, x0=None, z0=None, record=None, key=()):
    """One certified PDHG min-cut; returns ``(side [V] bool, gap, big, x,
    z, steps)``, the last three the warm start of the same label's cut in
    the next CP iteration and the steps taken (0-d tensors).  On a stencil
    graph, ``record`` (a list) receives ``("cut", *key, args)`` with the
    arguments of the kernel call."""
    if isinstance(graph, StencilGraphD1):
        args, big = cut_problem(graph, w, c, tol, x0, z0)
        if record is not None:
            record.append(("cut", *key, args))
        x, z, gap, t_best, steps = fused_pdhg_min_cut(
            *args, it_max, shifts=graph.shifts, check_every=check_every)
        return ((x > t_best).reshape(-1), gap, big, x.reshape(-1),
                z.reshape(-1), steps)
    big = 1.0 + 2.0 * (w.sum() + c.abs().sum())
    c_cl = torch.clamp(c, -big, big).to(w.dtype)
    side, gap, steps, x, z = _pdhg_min_cut(graph, w, c_cl,
                                           (tol * big).to(w.dtype), it_max,
                                           check_every, x0, z0)
    return side, gap, big, x, z, torch.tensor(steps, device=w.device)


def _expansion_sequence(graph: GraphD1, dfs, i_of_v, active, opt: CPOptions,
                        carry: dict, djv, first: int, it_max: int,
                        record=None, it: int = 0):
    """Expansion cuts ``first`` .. K-1, each of at most ``it_max`` steps
    from the same label's warm start in ``carry`` (updated in place).  Cut
    n's capacities depend on the labels the cuts before it assigned, so
    they run in order from ``djv``, the labels before cut ``first``.
    Returns the labels after each cut and the certificates ``[gap, big,
    steps]`` stacked on the device."""
    chk = min(250, opt.cut_it_max)
    djvs, certs = [], []
    for n in range(first, dfs.shape[1]):
        w, theta = _expansion_capacities(graph, dfs, i_of_v, djv, active, n)
        side, gap, big, xn, zn, steps = _device_side(
            graph, w, theta, opt.cut_tol, it_max, chk,
            *carry.get(n, (None, None)), record, (it, n))
        carry[n] = (xn, zn)
        certs.append(torch.stack([gap.to(torch.float64),
                                  big.to(torch.float64),
                                  steps.to(torch.float64)]))
        djv = torch.where(side, n, djv).to(torch.int32)
        djvs.append(djv)
    return djvs, torch.stack(certs)


def _separating(graph: GraphD1, djv, active):
    """Inactive nonzero-weight edges whose endpoints took different
    labels."""
    du, dv = graph.gather_endpoints(djv)
    return ~active & (graph.la_d1 > 0) & (du != dv)


def _certified_expansion(graph: GraphD1, dfs, rdi, cv, active,
                         opt: CPOptions, carry: dict, eps: float,
                         record=None, it: int = 0):
    """The K-1 alpha-expansion cuts of one CP iteration, certified
    (``:522-606``).  The certificates and the count of new separating edges
    are read once.  An uncertified cut continues from its own iterates for
    up to ``CONTINUE_FACTOR * cut_it_max`` more steps, and the cuts after it
    (they consumed its labels) are solved again with that budget, on the
    tensors' device.  What is still uncertified is redone on the host
    push-relabel for CPU tensors, and raises for CUDA tensors.  Returns
    ``(sep [E] bool, n_new, steps per cut, cuts continued)``."""
    num_v, k = dfs.shape
    if k < 2:
        return torch.zeros_like(active), 0, [], []
    i_of_v = rdi[cv.to(torch.int64)]
    djv0 = torch.zeros(num_v, dtype=torch.int32, device=dfs.device)

    def run(first, djv, it_max):
        djvs, cert = _expansion_sequence(graph, dfs, i_of_v, active, opt,
                                         carry, djv, first, it_max, record,
                                         it)
        sep = _separating(graph, djvs[-1], active)
        read = torch.cat([cert.reshape(-1),
                          sep.sum().to(torch.float64)[None]]).tolist()
        cert = np.asarray(read[:-1]).reshape(-1, 3)
        bad = np.nonzero(cert[:, 0] > opt.cut_tol * cert[:, 1])[0] + first
        return djvs, sep, int(read[-1]), [int(s) for s in cert[:, 2]], bad

    djvs, sep, n_new, steps, bad = run(1, djv0, opt.cut_it_max)
    continued = []
    if len(bad):
        first = int(bad[0])
        continued = list(range(first, k))
        _, sep, n_new, more, bad = run(
            first, djvs[first - 2] if first > 1 else djv0,
            CONTINUE_FACTOR * opt.cut_it_max)
        steps = steps[:first - 1] + [a + b for a, b in
                                     zip(steps[first - 1:], more)]
    if len(bad):
        if dfs.is_cuda:
            raise RuntimeError(
                f"expansion cuts {bad.tolist()} are uncertified after "
                f"{(1 + CONTINUE_FACTOR) * opt.cut_it_max} PDHG steps; "
                f"raise CPOptions.cut_it_max or cut_tol")
        # exactness guard: redo the whole expansion sequence on the host
        warnings.warn("falling back to the host min-cut solver for "
                      f"expansion cuts (uncertified: {bad.tolist()})",
                      UserWarning, stacklevel=3)
        djv = _host_expansion_fallback(graph, dfs, rdi, cv, active, eps)
        sep = _separating(graph, djv, active)
        n_new = int(sep.sum())
    return sep, n_new, steps, continued


def _reduced_problem(qsum, sizes, num_comp: int, al: float, rv_cap: int):
    """Reduced observations, warm start and per-component loss weights;
    padded rows (>= num_comp) are inert uniform distributions."""
    k = qsum.shape[1]
    live = (torch.arange(rv_cap, device=qsum.device) < num_comp)[:, None]
    unif = torch.full((), 1.0 / k, dtype=qsum.dtype, device=qsum.device)
    if al == 0.0:
        rp0 = torch.nn.functional.one_hot(torch.argmax(qsum, dim=1),
                                          k).to(qsum.dtype)
        return qsum, torch.where(live, rp0, unif), sizes
    safe = torch.clamp(sizes, min=1)[:, None]
    rq = torch.where(live, qsum / safe, unif)
    return rq, rq, sizes


def _device_merge_simplex(graph: GraphD1, p_full, active, eps: float):
    """Deactivates active edges whose endpoint distributions are equal to
    within eps in max-norm (``:782-804``)."""
    pu, pv = graph.gather_endpoints(p_full)
    d = (pu - pv).abs().amax(dim=1)
    return active & ~(d <= eps)


def _host_expansion_fallback(graph: GraphD1, dfs, rdi, cv, active,
                             eps: float):
    """Host push-relabel rerun of the whole K-1 expansion sequence
    (certificate failure: later cuts consumed uncertified labels), with the
    host twin :func:`.cut_pursuit_simplex._alpha_expansion_cuts`."""
    eu, ev, la = graph.host_coo()
    djv = _alpha_expansion_cuts(
        dfs.cpu().numpy().astype(np.float64), rdi.cpu().numpy(),
        cv.cpu().numpy(), eu, ev, np.asarray(la, np.float64),
        active.cpu().numpy(), float(eps), min_cut_fn=maxflow.min_cut)
    return torch.as_tensor(djv.astype(np.int32), device=cv.device)


def cp_loss_d1_simplex_device(graph: GraphD1, q, *, al: float,
                              opt: CPOptions = CPOptions(),
                              monitor: bool = False,
                              state: Optional[CPSimplexState] = None,
                              record: Optional[list] = None,
                              ) -> CPSimplexResult:
    """Device-resident multi-label cut-pursuit solve (same contract as
    :func:`.cut_pursuit_simplex.cp_loss_d1_simplex`); see the module
    docstring.  ``opt.verbose`` prints, per CP iteration, the components,
    the reduced edges, the reduced graph's container, the PFDR
    iterations, the PDHG steps of each cut, the cuts continued past
    ``cut_it_max`` and the host time of the cuts and of the reduced solve.
    ``record`` (a list, stencil graphs) receives the inputs of the
    kernels: ``("cut", it, n, args)`` for expansion cut n of CP iteration
    ``it`` (0-based) with the arguments of its ``fused_pdhg_min_cut``
    call, and ``("components", it, active)`` with the active-edge mask of
    its components call."""
    device_cut_supported(graph, q, False)
    t0 = _time.monotonic()
    num_v, k = q.shape
    device = q.device
    dtype = numpy_dtype(q.dtype)
    label_mode = opt.dif_tol >= 1.0
    tol_scale = opt.dif_tol / num_v if label_mode else opt.dif_tol
    ptol = (opt.pfdr.dif_tol / num_v if opt.pfdr.dif_tol >= 1
            else opt.pfdr.dif_tol)
    eps = machine_eps(dtype, min(tol_scale, ptol))

    # -- initialization: unisimplicial solution (:66-148) -------------------
    if state is None:
        qsum0 = q.sum(dim=0).cpu().numpy()
        if al == 0.0:
            rp = np.zeros((1, k), dtype)
            rp[0, np.argmax(qsum0)] = 1.0
        else:
            rp = (qsum0 / num_v)[None, :].astype(dtype)
        active = torch.zeros(graph.num_edges, dtype=torch.bool,
                             device=device)
        cv = torch.zeros(num_v, dtype=torch.int32, device=device)
        rp_dev = torch.as_tensor(rp, device=device)
    else:
        active = torch.as_tensor(np.asarray(state.active, bool),
                                 device=device)
        cv = torch.as_tensor(np.asarray(state.cv, np.int32), device=device)
        rp_dev = torch.as_tensor(np.asarray(state.rp, dtype), device=device)

    times = [0.0]
    objs = []
    difs = []

    def objective(p_full):
        return float(loss_objective(al, p_full, q, None)
                     + d1_objective(graph, p_full))

    p_full = rp_dev[cv.to(torch.int64)]
    if monitor:
        objs.append(objective(p_full))
    prev_labels = torch.argmax(p_full, dim=1)
    prev_p_full = p_full
    it = 0
    dif = max(opt.dif_tol, 1.0)
    num_comp = rp_dev.shape[0]

    cut_carry = {}
    while it < opt.it_max and dif >= opt.dif_tol:
        p_full = rp_dev[cv.to(torch.int64)]

        # -- gradient + active-edge signs (:327-377) ------------------------
        dfs = _direction_costs_simplex(graph, q, p_full, active, float(al),
                                       eps)

        # -- K-1 alpha-expansion cuts (:522-606) ----------------------------
        t_cut = _time.monotonic()
        sep, n_new, cut_steps, continued = _certified_expansion(
            graph, dfs, torch.argmax(rp_dev, dim=1).to(torch.int32), cv,
            active, opt, cut_carry, eps, record, it)
        t_cut = _time.monotonic() - t_cut
        active = active | sep

        if n_new == 0:  # nothing to recompute (:620-641)
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            if monitor:
                objs.append(objs[-1] if objs else float("nan"))
            continue

        # -- contraction, on the device (:643-731) ---------------------------
        if record is not None:
            record.append(("components", it, active.clone()))
        cv, num_comp_t, _ = _device_components(graph, active)
        lo_s, hi_s, w_s, flags, re_count = _contract_sort(cv, graph, active)
        num_comp, re_count = (int(v) for v in torch.stack(
            [num_comp_t.to(torch.int64), re_count.to(torch.int64)]).cpu())
        rv_cap = bucket(num_comp)
        reu, rev, rla = _contract_pad(lo_s, hi_s, w_s, flags, num_comp, eps,
                                      rv_cap, bucket(re_count))
        rgraph = make_reduced_container(reu, rev, rla, rv_cap, q.dtype,
                                        q.device)

        # -- reduced observations (:733-766) --------------------------------
        qsum = _run_sums(q, cv, rv_cap)
        sizes = torch.bincount(cv.to(torch.int64),
                               minlength=rv_cap).to(q.dtype)
        rq, rp0, rla_f = _reduced_problem(qsum, sizes, num_comp, float(al),
                                          rv_cap)

        # -- reduced PFDR solve (:773-780) -----------------------------------
        t_red = _time.monotonic()
        res = pfdr_loss_d1_simplex(
            rgraph, rq, al=al, la_f=None if al == 0.0 else rla_f, p0=rp0,
            opt=opt.pfdr)
        t_red = _time.monotonic() - t_red
        rp_dev = res.p
        p_full = rp_dev[cv.to(torch.int64)]

        # -- merge + evolution (:782-917) ------------------------------------
        active = _device_merge_simplex(graph, p_full, active, eps)
        if label_mode:
            labels = torch.argmax(p_full, dim=1)
            dif = float((labels != prev_labels).sum())
            prev_labels = labels
        else:
            dif = float((p_full - prev_p_full).abs().sum()) / num_v
            prev_p_full = p_full
        difs.append(dif)
        it += 1
        times.append(_time.monotonic() - t0)
        if monitor:
            objs.append(objective(p_full))
        if opt.verbose:
            print(f"CP-simplex it {it} (device): {num_comp} components, "
                  f"{re_count} reduced edges, {type(rgraph).__name__}, "
                  f"PFDR it {res.it}, cut "
                  f"steps {cut_steps}, cuts continued {continued}, "
                  f"{int(active.sum())} active edges, dif {dif:.3g}; cuts "
                  f"{t_cut * 1e3:.1f} ms, reduced solve {t_red * 1e3:.1f} "
                  f"ms", flush=True)

    cv_host = cv.cpu().numpy().astype(np.int32)
    rp_host = rp_dev.cpu().numpy().astype(dtype)[:num_comp]
    active_host = active.cpu().numpy()
    return CPSimplexResult(
        cv=cv_host, rp=rp_host, it=it,
        time=np.asarray(times),
        obj=np.asarray(objs) if monitor else np.zeros(0, dtype),
        dif=np.asarray(difs),
        state=CPSimplexState(active=active_host, cv=cv_host, rp=rp_host))
