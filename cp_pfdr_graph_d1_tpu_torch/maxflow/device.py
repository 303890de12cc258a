"""Min-cut as a certified binary-TV relaxation solved by PDHG
(counterpart of ``cp_pfdr_graph_d1_tpu.maxflow.device``).

The steepest-cut objective ``min_U sum_{v in U} c_v + sum_{e in
boundary(U)} w_e`` is the binary restriction of ``min_{x in [0,1]^V} <c,x>
+ sum_e w_e |x_u - x_v|``, whose relaxation is tight (coarea formula): every
super-level set of a relaxed minimizer is an optimal cut.  The relaxation
is solved with diagonally preconditioned primal-dual steps (Pock &
Chambolle 2011); a feasible dual point lower-bounds every cut, and the
iteration stops when the best of 15 thresholded cuts meets that bound
within ``tol`` — a certificate, not a heuristic.

:func:`_pdhg_min_cut` is the plain PyTorch loop on any graph container and
the plain version of the stencil kernel :mod:`..ops.mincut_fused`; it runs
on the tensors' device, CUDA or CPU, as the JAX package runs its cut as
plain jnp.  :func:`_pdhg_min_cut_directed` takes per-direction capacities
and :func:`_pdhg_min_cut_duplex` solves the two-layer (duplex) ternary cut
of cut-pursuit; neither has a TPU kernel, so both are plain loops.  Each
loop runs ``check_every`` steps, then reads the certificate once.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..graph import GraphD1
from ..ops.mincut_fused import cut_problem, fused_pdhg_min_cut, thresholds


def _chunked(step, certificate, state, tol, it_max: int, check_every: int,
             ts):
    """The loop of the PDHG cuts (the JAX ``while_loop`` over ``scan``
    chunks): ``check_every`` calls of ``step`` on the state tuple, then
    ``certificate`` gives the objectives of the thresholded cuts and the
    dual bound; it stops once the gap is at most ``tol`` or ``it_max``
    steps are done.  Returns ``(state, gap, steps, t_best)``."""
    it = 0
    gap = torch.tensor(float("inf"), dtype=ts.dtype, device=ts.device)
    t_best = ts[0]
    while it < it_max and bool(gap > tol):
        for _ in range(check_every):
            state = step(*state)
        vals, dual = certificate(*state)
        best = int(torch.argmin(vals))
        gap = vals[best] - dual
        t_best = ts[best]
        it += check_every
    return state, gap, it, t_best


def _steps(deg, c_abs, w):
    """Diagonal preconditioning (alpha = 1): ``tau_v = 1 / deg_v`` and
    ``sigma_e = 1 / (2 w_e)``; a vertex with no weighted edge gets the step
    that solves its linear subproblem at once."""
    tau = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-30),
                      1.0 / torch.clamp(c_abs, min=1e-12))
    sigma = torch.where(w > 0, 0.5 / torch.clamp(w, min=1e-30), 0.0)
    return tau, sigma


def _pdhg_min_cut(graph: GraphD1, w, c, tol, it_max: int, check_every: int,
                  x0=None, z0=None):
    """PDHG loop; returns ``(side [V] bool, gap, it, x, z)``.

    ``x0``/``z0`` warm-start the primal and dual state (the previous
    cut-pursuit iteration's cut on the same graph, as the reference reuses
    its max-flow graph, ``graph.hpp:280``); the certificate is computed
    afresh for the given capacities, so a warm start only saves
    iterations."""
    dtype = w.dtype
    v = graph.num_vertices
    tau, sigma = _steps(graph.vertex_degree_weighted(w), c.abs(), w)
    ts = thresholds(dtype, w.device)

    def ktz(z):
        return graph.edge_to_vertex_sum(w * z, -(w * z))

    def step(x, xb, z):
        xbu, xbv = graph.gather_endpoints(xb)
        z = torch.clamp(z + sigma * w * (xbu - xbv), -1, 1)
        x_new = torch.clamp(x - tau * (ktz(z) + c), 0, 1)
        return x_new, 2 * x_new - x, z

    def certificate(x, xb, z):
        dual = torch.clamp(c + ktz(z), max=0).sum()
        side = x[:, None] > ts[None, :]                    # [V, T]
        lin = torch.where(side, c[:, None], 0).sum(dim=0)
        su, sv = graph.gather_endpoints(side)              # [E, T]
        return lin + torch.where(su != sv, w[:, None], 0).sum(dim=0), dual

    if x0 is None:
        x0 = torch.full((v,), 0.5, dtype=dtype, device=w.device)
    if z0 is None:
        z0 = torch.zeros_like(w)
    (x, _, z), gap, it, t_best = _chunked(step, certificate, (x0, x0, z0),
                                          tol, it_max, check_every, ts)
    return x > t_best, gap, it, x, z


def _pdhg_min_cut_directed(graph: GraphD1, w_uv, w_vu, c, tol,
                           it_max: int, check_every: int):
    """Directed-capacity twin of :func:`_pdhg_min_cut`: minimizes
    ``sum_{v in U} c_v + sum_e w_uv [u in U, v not] + w_vu [v in U, u not]``
    through the tight relaxation with the one-sided dual box ``z_e in
    [-w_vu, w_uv] / max(w_uv, w_vu)`` (``w_uv max(0, d) + w_vu max(0, -d) =
    max_{-w_vu <= z <= w_uv} z d``).  Same coarea tightness and certificate
    as the undirected loop.  Returns ``(side [V] bool, gap, it)``."""
    dtype = w_uv.dtype
    v = graph.num_vertices
    wbar = torch.maximum(w_uv, w_vu)                       # K row scale
    lo = -torch.where(wbar > 0, w_vu / torch.clamp(wbar, min=1e-30), 0.0)
    hi = torch.where(wbar > 0, w_uv / torch.clamp(wbar, min=1e-30), 0.0)
    tau, sigma = _steps(graph.vertex_degree_weighted(wbar), c.abs(), wbar)
    ts = thresholds(dtype, w_uv.device)

    def ktz(z):
        return graph.edge_to_vertex_sum(wbar * z, -(wbar * z))

    def step(x, xb, z):
        xbu, xbv = graph.gather_endpoints(xb)
        z = torch.clamp(z + sigma * wbar * (xbu - xbv), lo, hi)
        x_new = torch.clamp(x - tau * (ktz(z) + c), 0, 1)
        return x_new, 2 * x_new - x, z

    def certificate(x, xb, z):
        dual = torch.clamp(c + ktz(z), max=0).sum()
        side = x[:, None] > ts[None, :]                    # [V, T]
        lin = torch.where(side, c[:, None], 0).sum(dim=0)
        su, sv = graph.gather_endpoints(side)              # [E, T]
        bnd = (torch.where(su & ~sv, w_uv[:, None], 0)
               + torch.where(sv & ~su, w_vu[:, None], 0)).sum(dim=0)
        return lin + bnd, dual

    x0 = torch.full((v,), 0.5, dtype=dtype, device=w_uv.device)
    (x, _, _), gap, it, t_best = _chunked(
        step, certificate, (x0, x0, torch.zeros_like(w_uv)), tol, it_max,
        check_every, ts)
    return x > t_best, gap, it


def _pdhg_min_cut_duplex(graph: GraphD1, w, c1, c2, m, tol, it_max: int,
                         check_every: int, x0=None, z0=None, zv0=None):
    """Two-layer (duplex) ternary cut on any container: the relaxation of
    the reference's 2V-node graph (``CP_PFDR_graph_quadratic_d1_l1_duplex
    .cpp:88-115,470-545``) with the layers as a trailing axis.  The d1
    weights ``w`` act on both layers, a per-vertex inter-layer term
    ``m_v max(0, x2_v - x1_v)`` encodes the ternary direction, and
    ``c1``/``c2`` are the layers' unary costs.  Thresholding both layers at
    a common level is a valid cut (coarea), so the certificate carries
    over.  ``x0`` [V, 2], ``z0`` [E, 2] and ``zv0`` [V] warm-start the
    state.  Returns ``(side [V, 2] bool, gap, it, x, z, zv)``."""
    dtype = w.dtype
    v = graph.num_vertices
    cc = torch.stack([c1, c2], dim=1)                      # [V, 2]
    tau, sigma_e = _steps(graph.vertex_degree_weighted(w) + m,
                          cc.abs().amax(dim=1), w)
    tau = tau[:, None]
    sigma_e = sigma_e[:, None]
    sigma_v = torch.where(m > 0, 0.5 / torch.clamp(m, min=1e-30), 0.0)
    layer_sign = torch.tensor([-1.0, 1.0], dtype=dtype, device=w.device)
    ts = thresholds(dtype, w.device)

    def kt(z, zv):
        """Adjoint: the d1 rows on both layers and the inter-layer rows."""
        wz = w[:, None] * z                                # [E, 2]
        return (graph.edge_to_vertex_sum(wz, -wz)
                + (m * zv)[:, None] * layer_sign)

    def step(x, xb, z, zv):
        xbu, xbv = graph.gather_endpoints(xb)              # [E, 2]
        z = torch.clamp(z + sigma_e * w[:, None] * (xbu - xbv), -1, 1)
        zv = torch.clamp(zv + sigma_v * m * (xb[:, 1] - xb[:, 0]), 0, 1)
        x_new = torch.clamp(x - tau * (kt(z, zv) + cc), 0, 1)
        return x_new, 2 * x_new - x, z, zv

    def certificate(x, xb, z, zv):
        dual = torch.clamp(cc + kt(z, zv), max=0).sum()
        side = x[:, :, None] > ts[None, None, :]           # [V, 2, T]
        lin = torch.where(side, cc[:, :, None], 0).sum(dim=(0, 1))
        inter = torch.where(side[:, 1, :] & ~side[:, 0, :], m[:, None],
                            0).sum(dim=0)
        su, sv = graph.gather_endpoints(side)              # [E, 2, T]
        bnd = torch.where(su != sv, w[:, None, None], 0).sum(dim=(0, 1))
        return lin + inter + bnd, dual

    if x0 is None:
        x0 = torch.full((v, 2), 0.5, dtype=dtype, device=w.device)
    if z0 is None:
        z0 = torch.zeros((graph.num_edges, 2), dtype=dtype, device=w.device)
    if zv0 is None:
        zv0 = torch.zeros(v, dtype=dtype, device=w.device)
    (x, _, z, zv), gap, it, t_best = _chunked(
        step, certificate, (x0, x0, z0, zv0), tol, it_max, check_every, ts)
    return x > t_best, gap, it, x, z, zv


def _clip_capacities(c, *ws):
    """Infinite entries of ``c`` clamped beyond any finite cut, as the host
    solver does: ``(big, c, *ws)`` in float64 numpy."""
    c = np.asarray(c, np.float64)
    ws = [np.asarray(w, np.float64) for w in ws]
    big = 1.0 + 2.0 * (sum(float(np.sum(w[np.isfinite(w)])) for w in ws)
                       + float(np.sum(np.abs(c[np.isfinite(c)]))))
    return big, np.clip(c, -big, big), *(np.minimum(w, big) for w in ws)


def _certified(gap, tol_abs: float, it_max: int, what: str):
    """``gap <= tol_abs``, warning when the cut is not certified."""
    if gap <= tol_abs:
        return True
    warnings.warn(
        f"device {what} exited at it_max={it_max} with duality gap "
        f"{gap:.3g} > certificate {tol_abs:.3g}; the returned cut is not "
        "certified optimal", UserWarning, stacklevel=3)
    return False


def min_cut_device(num_vertices: int, eu, ev, w, c, *, graph=None,
                   tol: float = 1e-6, it_max: int = 200_000,
                   check_every: int = 250, dtype=torch.float32,
                   device="cuda", return_gap: bool = False):
    """Drop-in for :func:`..maxflow.min_cut` by the PDHG relaxation.

    Returns ``side`` (uint8 [V], 1 for vertices in the minimizing U), or
    ``(side, gap, certified)`` with ``return_gap``.  Infinite entries of
    ``c`` are clamped beyond any finite cut.  ``tol`` is the duality-gap
    certificate relative to the problem's cost scale; a cut that exits at
    ``it_max`` above it is not certified, and a :class:`UserWarning` says so.
    ``graph`` may be a container with the weights ``w`` in its edge order,
    on its own device: a :class:`~..stencil.StencilGraphD1` whose kernels
    take it (``supports_fused``) runs the stencil kernel, any other the
    plain loop.  Without ``graph`` a COO graph is built on ``device``.
    """
    from ..stencil import StencilGraphD1
    big, c, w = _clip_capacities(c, w)
    tol_abs = tol * max(big, 1.0)
    if isinstance(graph, StencilGraphD1) and graph.supports_fused:
        dev = graph.la_d1.device
        args, _ = cut_problem(graph, torch.as_tensor(w, dtype=dtype,
                                                     device=dev),
                              torch.as_tensor(c, dtype=dtype, device=dev),
                              tol)
        x, _, gap, t_best, _ = fused_pdhg_min_cut(
            *args, it_max, shifts=graph.shifts, check_every=check_every)
        side = (x > t_best).reshape(-1)
        tol_abs = float(args[6])
    else:
        if graph is None:
            graph = GraphD1.create(eu, ev, w, num_vertices=num_vertices,
                                   dtype=dtype, device=device)
        dev = graph.la_d1.device
        side, gap, _, _, _ = _pdhg_min_cut(
            graph, torch.as_tensor(w, dtype=dtype, device=dev),
            torch.as_tensor(c, dtype=dtype, device=dev),
            torch.tensor(tol_abs, dtype=dtype, device=dev), it_max,
            check_every)
    side = side.cpu().numpy().astype(np.uint8)
    gap = float(gap)
    certified = _certified(gap, tol_abs, it_max, "min-cut")
    if return_gap:
        return side, gap, certified
    return side


def min_cut_device_with_fallback(num_vertices: int, eu, ev, w, c, *,
                                 graph=None, tol: float = 1e-6,
                                 it_max: int = 200_000,
                                 check_every: int = 250,
                                 dtype=torch.float32,
                                 device="cuda") -> np.ndarray:
    """Device min-cut that falls back to the host push-relabel when the
    duality-gap certificate fails: cut-pursuit's steepest cut must be
    exact, so an uncertified relaxation result is never used silently."""
    side, _, certified = min_cut_device(
        num_vertices, eu, ev, w, c, graph=graph, tol=tol, it_max=it_max,
        check_every=min(check_every, it_max), dtype=dtype, device=device,
        return_gap=True)
    if certified:
        return side
    warnings.warn("falling back to the host min-cut solver for this cut",
                  UserWarning, stacklevel=2)
    from . import min_cut
    return min_cut(num_vertices, eu, ev, w, c)


def min_cut_directed_device(num_vertices: int, eu, ev, w_uv, w_vu, c, *,
                            tol: float = 1e-6, it_max: int = 200_000,
                            check_every: int = 250, dtype=torch.float32,
                            device="cuda", return_gap: bool = False):
    """Drop-in for :func:`..maxflow.min_cut_directed` (per-direction arc
    capacities) by :func:`_pdhg_min_cut_directed` on a COO graph built on
    ``device``; returns as :func:`min_cut_device` does."""
    big, c, w_uv, w_vu = _clip_capacities(c, w_uv, w_vu)
    tol_abs = tol * max(big, 1.0)
    graph = GraphD1.create(eu, ev, np.maximum(w_uv, w_vu),
                           num_vertices=num_vertices, dtype=dtype,
                           device=device)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    side, gap, _ = _pdhg_min_cut_directed(
        graph, tensor(w_uv), tensor(w_vu), tensor(c), tensor(tol_abs),
        it_max, check_every)
    side = side.cpu().numpy().astype(np.uint8)
    gap = float(gap)
    certified = _certified(gap, tol_abs, it_max, "directed min-cut")
    if return_gap:
        return side, gap, certified
    return side


def cut_value(eu, ev, w, c, side) -> float:
    """Objective ``sum_{v in U} c_v + boundary weight`` of a given cut."""
    side = np.asarray(side, bool)
    w = np.asarray(w, np.float64)
    c = np.asarray(c, np.float64)
    fin_c = np.where(np.isfinite(c), c, 0)
    val = float(np.sum(fin_c[side]))
    val += float(np.sum(w[side[np.asarray(eu)] != side[np.asarray(ev)]]))
    return val
