"""Unstructured-graph container whose transfers run in hand-written kernels
(counterpart of ``cp_pfdr_graph_d1_tpu.banded_graph``).

:class:`BandedGraphD1` keeps the JAX container's edge order: edges sorted
stably by their smaller endpoint and padded to a multiple of the tile with
weight-0 copies of the last edge (:func:`.ops.banded.build_banded_plan`),
which the solvers treat as absent.  On a CUDA device its endpoint gathers
and edge -> vertex sums go through the kernels of :mod:`.ops.banded`, one
PFDR edge + vertex stage through :mod:`.ops.banded_fused`, and an
unmonitored quadratic PFDR solve through :mod:`.ops.solve_fused`.  It keeps
no ``V x max degree`` table, so a hub vertex costs memory in proportion to
its degree only: cut-pursuit hands it its hub-heavy reduced graphs
(:func:`.solvers.cut_pursuit_common.make_reduced_container`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import numpy_dtype
from .graph import GraphD1
from .ops.banded import (banded_gather, banded_gather_plain, banded_scatter,
                         banded_scatter_plain, build_banded_plan, edge_index)
from .ops.banded_fused import fused_banded_iteration


class BandedGraphD1(GraphD1):
    """d1 graph in banded edge order, with kernel transfers.

    ``mode``: "auto" runs the kernels for tensors on a CUDA device (their
    plain versions on the CPU); "jnp" runs the plain versions everywhere
    and takes no kernel route of the solvers.
    """

    def __init__(self, eu, ev, la_d1, num_vertices: int, mode: str = "auto"):
        if mode not in ("auto", "jnp"):
            raise ValueError(f"unknown mode {mode!r} (auto or jnp)")
        super().__init__(eu, ev, la_d1, num_vertices)
        self.mode = mode
        self._edge_index = None
        self._banded_plans = {}  # ops.banded's launch plans
        self._stage_plans = {}   # ops.banded_fused's launch plans

    @classmethod
    def create(cls, eu, ev, la_d1, num_vertices: Optional[int] = None,
               dtype=torch.float32, tile: int = 1024, mode: str = "auto",
               device="cuda") -> "BandedGraphD1":
        """Builds the container from host edge arrays: edges re-sorted by
        smaller endpoint and padded to a multiple of ``tile`` with weight-0
        copies of the last edge."""
        eu = np.asarray(eu, np.int32)
        ev = np.asarray(ev, np.int32)
        la = np.asarray(la_d1, numpy_dtype(dtype))
        if la.ndim == 0:
            la = np.full(eu.shape, la, dtype=la.dtype)
        if num_vertices is None:
            num_vertices = int(max(eu.max(initial=-1),
                                   ev.max(initial=-1)) + 1)
        _, perm, epad = build_banded_plan(eu, ev, num_vertices, tile)
        e = len(eu)
        eu_p = np.concatenate([eu[perm], np.full(epad - e, eu[perm][-1],
                                                 np.int32)])
        ev_p = np.concatenate([ev[perm], np.full(epad - e, ev[perm][-1],
                                                 np.int32)])
        la_p = np.concatenate([la[perm], np.zeros(epad - e, la.dtype)])
        g = cls(torch.as_tensor(eu_p, dtype=torch.int64, device=device),
                torch.as_tensor(ev_p, dtype=torch.int64, device=device),
                torch.as_tensor(la_p, device=device), num_vertices, mode)
        g._host_coo = (eu_p, ev_p, la_p)
        return g

    @property
    def supports_fused(self) -> bool:
        """Whether the solvers' kernel routes (the fused stage, the whole
        solve) apply."""
        return self.mode != "jnp"

    def edge_index(self):
        """int32 endpoints, incidence list and long rows on the graph's
        device (:func:`.ops.banded.edge_index`), built once."""
        if self._edge_index is None:
            self._edge_index = edge_index(self.eu, self.ev, self.num_vertices)
        return self._edge_index

    # -- edge <-> vertex transfer ------------------------------------------

    def gather_endpoints(self, x):
        if self.mode == "jnp":
            return banded_gather_plain(self, x)
        return banded_gather(self, x if x.is_contiguous() else x.contiguous())

    def edge_to_vertex_sum(self, vals_u, vals_v):
        if self.mode == "jnp":
            return banded_scatter_plain(self, vals_u, vals_v)
        if not (vals_u.is_contiguous() and vals_v.is_contiguous()):
            vals_u, vals_v = vals_u.contiguous(), vals_v.contiguous()
        return banded_scatter(self, vals_u, vals_v)

    def edge_to_vertex_min(self, vals_u, vals_v, init):
        """Scatter-min (a minimum does not depend on the order, so it is
        deterministic as it stands); the padding edges carry weight 0, so
        callers' masks must map them to ``init``."""
        out = vals_u.new_full((self.num_vertices,) + tuple(vals_u.shape[1:]),
                              init)
        for idx, vals in ((self.eu, vals_u), (self.ev, vals_v)):
            index = idx.reshape((-1,) + (1,) * (vals.ndim - 1)).expand_as(vals)
            out = out.scatter_reduce(0, index, vals, "amin")
        return out

    # -- fused iteration ------------------------------------------------------

    def fused_iteration(self, x, grad, pre, zu, zv, rho: float, vprox):
        """One fused edge + vertex PFDR step (see
        :func:`.ops.banded_fused.fused_banded_iteration`)."""
        return fused_banded_iteration(
            self, x, grad, pre.ga, pre.th_l1, zu, zv, pre.wu, pre.wv,
            pre.w_d1u, pre.w_d1v, pre.th_d1, rho=rho, vkind=vprox.kind,
            positivity=vprox.positivity, lo=float(vprox.lo),
            hi=float(vprox.hi))
