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
the plain version of the stencil kernel :mod:`..ops.mincut_fused`.  On a
CUDA device a cut runs only through that kernel, so a COO graph on the card
raises: the JAX package runs the cut on a COO graph as plain jnp, with no
TPU kernel to port; on the CPU this loop is the route.  The directed and
duplex relaxations are not ported yet (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..graph import GraphD1
from ..ops.mincut_fused import cut_problem, fused_pdhg_min_cut, thresholds


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
    # tau_v = 1 / sum_{e ~ v} w_e, sigma_e = 1 / (2 w_e); a vertex with no
    # weighted edge gets the step that solves its linear subproblem at once
    deg_w = graph.vertex_degree_weighted(w)
    tau = torch.where(deg_w > 0, 1.0 / torch.clamp(deg_w, min=1e-30),
                      1.0 / torch.clamp(c.abs(), min=1e-12))
    sigma = torch.where(w > 0, 0.5 / torch.clamp(w, min=1e-30), 0.0)
    ts = thresholds(dtype, w.device)

    def ktz(z):
        return graph.edge_to_vertex_sum(w * z, -(w * z))

    if x0 is None:
        x0 = torch.full((v,), 0.5, dtype=dtype, device=w.device)
    if z0 is None:
        z0 = torch.zeros_like(w)
    x, xb, z = x0, x0, z0
    it = 0
    gap = torch.tensor(float("inf"), dtype=dtype, device=w.device)
    t_best = ts[0]
    while it < it_max and bool(gap > tol):
        for _ in range(check_every):
            xbu, xbv = graph.gather_endpoints(xb)
            z = torch.clamp(z + sigma * w * (xbu - xbv), -1, 1)
            x_new = torch.clamp(x - tau * (ktz(z) + c), 0, 1)
            xb = 2 * x_new - x
            x = x_new
        dual = torch.clamp(c + ktz(z), max=0).sum()
        side = x[:, None] > ts[None, :]                    # [V, T]
        lin = torch.where(side, c[:, None], 0).sum(dim=0)
        su, sv = graph.gather_endpoints(side)              # [E, T]
        vals = lin + torch.where(su != sv, w[:, None], 0).sum(dim=0)
        best = int(torch.argmin(vals))
        gap = vals[best] - dual
        t_best = ts[best]
        it += check_every
    return x > t_best, gap, it, x, z


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
    ``graph`` may be a :class:`~..stencil.StencilGraphD1` with the weights
    ``w`` in its edge order: the cut then runs through the stencil kernel.
    Otherwise a COO graph is built, whose cut runs only on the CPU.
    """
    from ..stencil import StencilGraphD1
    w = np.asarray(w, np.float64)
    c = np.asarray(c, np.float64)
    big = 1.0 + 2.0 * (float(np.sum(w[np.isfinite(w)]))
                       + float(np.sum(np.abs(c[np.isfinite(c)]))))
    c = np.clip(c, -big, big)
    w = np.minimum(w, big)
    if isinstance(graph, StencilGraphD1):
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
        if torch.device(device).type == "cuda":
            raise NotImplementedError(
                "a device min-cut on a COO graph has no kernel on the card "
                "(the JAX package runs it as plain jnp, with no TPU kernel "
                "to port); pass a StencilGraphD1 or device='cpu'")
        g = GraphD1.create(eu, ev, w, num_vertices=num_vertices,
                           dtype=dtype, device=device)
        tol_abs = tol * max(big, 1.0)
        side, gap, _, _, _ = _pdhg_min_cut(
            g, g.la_d1, torch.as_tensor(c, dtype=dtype, device=device),
            torch.tensor(tol_abs, dtype=dtype, device=device), it_max,
            check_every)
    side = side.cpu().numpy().astype(np.uint8)
    gap = float(gap)
    certified = gap <= tol_abs
    if not certified:
        warnings.warn(
            f"device min-cut exited at it_max={it_max} with duality gap "
            f"{gap:.3g} > certificate {tol_abs:.3g}; the returned cut "
            "is not certified optimal", UserWarning, stacklevel=2)
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


def cut_value(eu, ev, w, c, side) -> float:
    """Objective ``sum_{v in U} c_v + boundary weight`` of a given cut."""
    side = np.asarray(side, bool)
    w = np.asarray(w, np.float64)
    c = np.asarray(c, np.float64)
    fin_c = np.where(np.isfinite(c), c, 0)
    val = float(np.sum(fin_c[side]))
    val += float(np.sum(w[side[np.asarray(eu)] != side[np.asarray(ev)]]))
    return val
