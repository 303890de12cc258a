"""Proximal operators (counterpart of ``cp_pfdr_graph_d1_tpu.ops.prox``).

Soft-thresholding with optional positivity
(``PFDR_graph_quadratic_d1_l1.cpp:499-512``), box clamp
(``PFDR_graph_quadratic_d1_bounds.cpp:472-489``) and the pairwise d1 prox
(``PFDR_graph_quadratic_d1_l1.cpp:466-489``), and the simplex projection in
a diagonal metric (``proj_simplex_metric.cpp:19-83``).
"""
from __future__ import annotations

import torch


def soft_threshold(x, thresh, positivity: bool = False):
    """``prox`` of ``thresh * |.|`` (+ indicator of R+ when ``positivity``)."""
    pos = torch.clamp(x - thresh, min=0)
    if positivity:
        return pos
    return pos + torch.clamp(x + thresh, max=0)


def box_clamp(x, lo, hi):
    """Projection onto ``[lo, hi]``; infinite bounds are no-ops."""
    return torch.clamp(x, lo, hi)


def vertex_prox_plain(a, th_l1, vkind: str, positivity: bool, lo: float,
                      hi: float):
    """Vertex prox of the quadratic PFDR stage as the kernels take it: l1
    soft threshold (+ positivity), box clamp, or none (+ positivity)."""
    if vkind == "l1":
        return soft_threshold(a, th_l1, positivity)
    if vkind == "bounds":
        return box_clamp(a, lo, hi)
    if positivity:
        return torch.clamp(a, min=0)
    return a


def d1_pair_prox(pu, pv, w_u, w_v, thresh):
    """Backward step of the pairwise d1 term on a coupled pair with
    normalized weights ``w_u + w_v == 1``: the weighted average plus a
    soft-thresholded share of the difference."""
    avg = w_u * pu + w_v * pv
    diff = pu - pv
    shrunk = torch.sign(diff) * torch.clamp(diff.abs() - thresh, min=0)
    return avg + w_v * shrunk, avg - w_u * shrunk


def proj_simplex_metric(x, metric, target=1.0):
    """Projects rows of ``x`` [..., K] onto ``{p >= 0, sum(p) = target}`` in
    the diagonal metric ``diag(1/metric)``.

    Solves ``min_p 1/2 sum_k (p_k - x_k)^2 / m_k  s.t.  p >= 0, sum p = a``.
    KKT gives ``p_k = max(0, x_k - la * m_k)`` with ``la`` the root of
    ``sum_k max(0, x_k - la m_k) = a``, found by the Michelot active-set
    iteration: start all-active, recompute ``la = (sum_active x - a) /
    sum_active m`` and drop the coordinates with ``x - la m <= 0``.  It ends
    after at most K - 1 removals, so K passes are exact; that is the
    reference's scheme (``proj_simplex_metric.cpp:46-72``), kept as K passes
    so that the rounding is the JAX package's.
    """
    m = torch.as_tensor(metric, dtype=x.dtype, device=x.device).expand_as(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    active = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    la = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for _ in range(x.shape[-1]):
        sx = torch.where(active, x, zero).sum(dim=-1, keepdim=True)
        sm = torch.where(active, m, zero).sum(dim=-1, keepdim=True)
        la = (sx - target) / torch.where(sm > 0, sm, one)
        active = active & (x - la * m > 0)
    return torch.clamp(x - la * m, min=0)
