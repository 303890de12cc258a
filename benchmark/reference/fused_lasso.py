"""Plain reference of the EEG fused LASSO with positivity.

    P(x) = 1/2 ||y - Phi x||^2 + lam * sum_e |x_u - x_v| + lam * sum_i x_i,
    x >= 0,

on the theta-phi grid of the configuration's sphere: edges to the right
(wrapping in phi), down, and down-right (wrapping in phi), as upstream's
example builds its mesh; ``lam = scale * mean |Phi^t y_0|`` from the run's
first sample, worked out here again from the handed inputs.

Two numbers describe an answer ``x``; the configuration's ``check.limits``
says which are compared:

* ``objective_excess``: ``(P(x) - P_ref) / P_ref``, with ``P_ref`` the
  objective of the reference's own solution, preconditioned PDHG
  (Chambolle & Pock; Pock & Chambolle's diagonal steps) run for a fixed
  number of iterations in float64 on the device, a batch of samples at
  once.  ``P_ref`` lies above the optimum, so a sound answer can read
  below 0.  ``objective_excess`` is the widest over the solves judged;
  ``objective_excess_total`` is the excess of their summed objectives
  over the summed ``P_ref``.  Upstream's stopping rule (``CP_difTol``)
  leaves a rare sound answer about 1e-4 above ``P_ref``, as far as the
  TF32 control's mildest widest reading, so the EEG configuration compares
  the total, over which such an answer is one of many;
* ``stationarity``: the optimality of the answer's values on its own
  partition.  The partition is read from ``x`` itself (edges whose two ends
  hold the same value).  On each part ``C`` the derivative of ``P`` along
  ``C``, ``sum_C Phi^t (Phi x - y) + lam |C| + lam * sum over the edges
  leaving C of sign(x_C - x_other)``, has to vanish where ``x_C`` is
  positive, and may not be negative where ``x_C`` lies at the positivity
  bound (at or below ``bound_rel`` times the largest value: float32 leaves
  parts that belong at 0 a few ulps above it).  Edges to a part whose
  value equals ``x_C`` to within ``free_rel`` times the largest value may
  carry any sign (float32 solves leave parts that belong together a few
  ulps apart, and a single vertex at such a tie reads up to 0.2).  The
  number is the sum of these derivatives' sizes over the sum of their
  terms' magnitudes, over the parts off the bound: the widest single part
  (``stationarity_widest``, printed, not compared) swings with parts of a few vertices and values near 0, which the reduced
  solve's stopping rule, an evolution relative to the whole vector, leaves
  less converged than the rest.

Plain NumPy, SciPy and PyTorch; it imports nothing of the port.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components


def sphere_edges(n_theta: int, n_phi: int):
    """``(eu, ev)`` of the sphere grid: right and down-right wrap in phi."""
    idx = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    right = np.roll(idx, -1, axis=1)
    eu = np.concatenate([idx.ravel(), idx[:-1].ravel(), idx[:-1].ravel()])
    ev = np.concatenate([right.ravel(), idx[1:].ravel(),
                         right[1:].ravel()])
    return eu.astype(np.int64), ev.astype(np.int64)


def penalty(config: dict, phi32, y0_32) -> float:
    return float(config["lambda_scale"]) * float(
        np.abs(np.asarray(phi32, np.float64).T
               @ np.asarray(y0_32, np.float64)).mean())


def objective(x, phi, y, eu, ev, lam: float) -> float:
    """P(x) in float64 (``inf`` when x has a negative entry)."""
    if np.min(x) < 0:
        return float("inf")
    r = y - phi @ x
    return float(0.5 * r @ r + lam * np.abs(x[eu] - x[ev]).sum()
                 + lam * x.sum())


def pdhg(phi, ys, eu, ev, lam: float, iters: int, device,
         dtype=torch.float64):
    """Preconditioned PDHG for a batch of samples ``ys`` [B, N]; returns
    the primal iterates [B, V] (float64 numpy)."""
    a = torch.as_tensor(np.asarray(phi), dtype=dtype, device=device)
    y = torch.as_tensor(np.asarray(ys), dtype=dtype, device=device)
    u = torch.as_tensor(eu, device=device)
    v = torch.as_tensor(ev, device=device)
    num_v, b = a.shape[1], y.shape[0]
    ones = torch.ones(len(eu), dtype=dtype, device=device)
    deg = torch.zeros(num_v, dtype=dtype, device=device)
    deg.index_add_(0, u, ones).index_add_(0, v, ones)
    tau = 1.0 / (a.abs().sum(0) + deg)
    sig_r = 1.0 / a.abs().sum(1)
    sig_p = 0.5
    x = torch.zeros((b, num_v), dtype=dtype, device=device)
    r = torch.zeros_like(y)
    p = torch.zeros((b, len(eu)), dtype=dtype, device=device)
    for _ in range(iters):
        dtp = torch.zeros_like(x)
        dtp.index_add_(1, u, p).index_add_(1, v, -p)
        x_new = torch.clamp(x - tau * (r @ a + dtp + lam), min=0)
        xb = 2 * x_new - x
        x = x_new
        r = (r + sig_r * (xb @ a.T - y)) / (1 + sig_r)
        p = torch.clamp(p + sig_p * (xb[:, u] - xb[:, v]), -lam, lam)
    return x.double().cpu().numpy()


def stationarity_parts(x, phi, y, eu, ev, lam: float, free_rel: float,
                       bound_rel: float):
    """Per part of the answer's partition: ``(residual, scale, size, value,
    smallest gap to a neighbouring part relative to the largest value)``,
    the residual being
    the derivative of ``P`` along the part beyond what its free edges
    absorb (at the positivity bound: only a negative derivative)."""
    num_v = len(x)
    same = x[eu] == x[ev]
    n, part = connected_components(
        coo_matrix((np.ones(int(same.sum())), (eu[same], ev[same])),
                   shape=(num_v, num_v)), directed=False)
    size = np.bincount(part, minlength=n).astype(np.float64)
    z = np.bincount(part, x, n) / size
    fit = phi.T @ (phi @ x)
    aty = phi.T @ y
    grad = np.bincount(part, fit - aty, n) + lam * size
    scale = (np.bincount(part, np.abs(fit), n)
             + np.bincount(part, np.abs(aty), n) + lam * size)
    pu, pv = part[eu[~same]], part[ev[~same]]
    d = z[pu] - z[pv]
    rel = np.abs(d) / max(float(np.abs(z).max()), 1e-300)
    free = rel <= free_rel
    s = np.where(free, 0.0, np.sign(d)) * lam
    grad += np.bincount(pu, s, n) - np.bincount(pv, s, n)
    slack = lam * (np.bincount(pu, free, n) + np.bincount(pv, free, n))
    scale += lam * (np.bincount(pu, minlength=n)
                    + np.bincount(pv, minlength=n))
    gap = np.full(n, np.inf)
    np.minimum.at(gap, pu, rel)
    np.minimum.at(gap, pv, rel)
    at_bound = z <= bound_rel * max(float(z.max()), 0.0)
    res = np.where(at_bound, np.maximum(-grad - slack, 0.0),
                   np.maximum(np.abs(grad) - slack, 0.0))
    return res, scale, size, z, gap


def stationarity(x, phi, y, eu, ev, lam: float, free_rel: float,
                 bound_rel: float):
    """``(summed, widest)``: the residuals' sum over the scales' sum, over
    the parts off the positivity bound, and the widest part's residual over
    its scale, over all parts."""
    res, scale, _, z, _ = stationarity_parts(x, phi, y, eu, ev, lam,
                                             free_rel, bound_rel)
    inner = z > bound_rel * max(float(z.max()), 0.0)
    summed = float(res[inner].sum() / scale[inner].sum()) \
        if inner.any() else 0.0
    return summed, float((res / scale).max())


def judge(config: dict, handed: list, answers: list, device) -> dict:
    """``objective_excess`` and ``stationarity`` (each the widest over the
    batch of solves), ``objective_excess_total`` and
    ``stationarity_widest``.  ``handed``: dicts with ``phi`` [N, V], ``y``
    [N] and ``y0`` (float32 numpy); ``answers``: the program's ``x``
    (float64 numpy)."""
    chk = config["check"]
    m = config["mesh"]
    phi = np.asarray(handed[0]["phi"], np.float64)
    lam = penalty(config, handed[0]["phi"], handed[0]["y0"])
    eu, ev = sphere_edges(int(m["n_theta"]), int(m["n_phi"]))
    ys = np.stack([np.asarray(h["y"], np.float64) for h in handed])
    refs = pdhg(phi, ys, eu, ev, lam, int(chk["reference_iters"]), device)
    excess, summed, widest, p_x, p_refs = [], [], [], [], []
    for x, y, xr in zip(answers, ys, refs):
        p_refs.append(objective(xr, phi, y, eu, ev, lam))
        p_x.append(objective(x, phi, y, eu, ev, lam))
        excess.append((p_x[-1] - p_refs[-1]) / p_refs[-1])
        s, w = stationarity(x, phi, y, eu, ev, lam, float(chk["free_rel"]),
                            float(chk["bound_rel"]))
        summed.append(s)
        widest.append(w)
    return dict(objective_excess=max(excess),
                objective_excess_total=(sum(p_x) - sum(p_refs)) / sum(p_refs),
                stationarity=max(summed), stationarity_widest=max(widest))

