"""Proximal operators (counterpart of ``cp_pfdr_graph_d1_tpu.ops.prox``).

Soft-thresholding with optional positivity
(``PFDR_graph_quadratic_d1_l1.cpp:499-512``), box clamp
(``PFDR_graph_quadratic_d1_bounds.cpp:472-489``) and the pairwise d1 prox
(``PFDR_graph_quadratic_d1_l1.cpp:466-489``).  The simplex projection comes
with the multi-label slice.
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


def d1_pair_prox(pu, pv, w_u, w_v, thresh):
    """Backward step of the pairwise d1 term on a coupled pair with
    normalized weights ``w_u + w_v == 1``: the weighted average plus a
    soft-thresholded share of the difference."""
    avg = w_u * pu + w_v * pv
    diff = pu - pv
    shrunk = torch.sign(diff) * torch.clamp(diff.abs() - thresh, min=0)
    return avg + w_v * shrunk, avg - w_u * shrunk
