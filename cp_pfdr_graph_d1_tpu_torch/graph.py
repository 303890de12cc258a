"""Graph container (counterpart of ``cp_pfdr_graph_d1_tpu.graph``).

The edge->vertex accumulation keeps the JAX package's design: a padded
incidence table ``inc[v, d]`` lists the endpoint slots incident to each
vertex (slot ``e`` is edge ``e``'s u-endpoint, slot ``E + e`` its
v-endpoint, the sentinel ``2E`` selects a zero pad), and the accumulation is
a gather plus a row sum.  It is deterministic: ``index_add_`` on CUDA sums
with float atomics in an order that changes from run to run, which would
change PFDR iteration counts between runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import numpy_dtype


def build_incidence(eu: np.ndarray, ev: np.ndarray,
                    num_vertices: int) -> np.ndarray:
    """int64 [V, D] slot indices (sentinel 2E), sorted per vertex."""
    num_edges = eu.shape[0]
    slots_vertex = np.concatenate([eu, ev]).astype(np.int64)
    order = np.argsort(slots_vertex, kind="stable")
    degrees = np.bincount(slots_vertex, minlength=num_vertices)
    max_deg = max(int(degrees.max(initial=0)), 1)
    inc = np.full((num_vertices, max_deg), 2 * num_edges, dtype=np.int64)
    offsets = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    within = np.arange(2 * num_edges, dtype=np.int64) - offsets[
        slots_vertex[order]]
    inc[slots_vertex[order], within] = order
    return inc


class GraphD1:
    """Undirected graph with per-edge d1 (total-variation) weights.

    Attributes:
      eu, ev: int64 [E] endpoint tensors (0-based).
      la_d1: [E] nonnegative edge weights.
      num_vertices, num_edges: Python ints.
      incidence: int64 [V, D] endpoint-slot table, built on first use.
    """

    def __init__(self, eu, ev, la_d1, num_vertices: int, incidence=None):
        self.eu = eu
        self.ev = ev
        self.la_d1 = la_d1
        self.num_vertices = int(num_vertices)
        self.num_edges = int(eu.shape[0])
        self._incidence = incidence
        self._host_coo = None

    @classmethod
    def create(cls, eu, ev, la_d1, num_vertices: Optional[int] = None,
               dtype=torch.float32, device="cuda") -> "GraphD1":
        """Builds a graph from host arrays, validating shapes."""
        eu = np.array(eu, dtype=np.int32)
        ev = np.array(ev, dtype=np.int32)
        la = np.array(la_d1, dtype=numpy_dtype(dtype))
        if la.ndim == 0:
            la = np.full(eu.shape, la, dtype=la.dtype)
        if eu.shape != ev.shape or eu.shape != la.shape:
            raise ValueError(
                f"edge arrays disagree: eu{eu.shape} ev{ev.shape} la{la.shape}")
        if num_vertices is None:
            num_vertices = int(max(eu.max(initial=-1), ev.max(initial=-1)) + 1)
        if eu.size and (eu.min() < 0 or ev.min() < 0
                        or max(eu.max(), ev.max()) >= num_vertices):
            raise ValueError("edge endpoint out of range")
        g = cls(torch.as_tensor(eu, dtype=torch.int64, device=device),
                torch.as_tensor(ev, dtype=torch.int64, device=device),
                torch.as_tensor(la, device=device), num_vertices)
        g._host_coo = (eu, ev, la)
        return g

    @property
    def device(self):
        return self.la_d1.device

    def host_coo(self):
        """``(eu, ev, la_d1)`` as numpy arrays, for the host stages of
        cut-pursuit."""
        if self._host_coo is None:
            self._host_coo = (self.eu.cpu().numpy().astype(np.int32),
                              self.ev.cpu().numpy().astype(np.int32),
                              self.la_d1.cpu().numpy())
        return self._host_coo

    @property
    def incidence(self):
        if self._incidence is None:
            eu, ev, _ = self.host_coo()
            self._incidence = torch.as_tensor(
                build_incidence(eu, ev, self.num_vertices),
                device=self.device)
        return self._incidence

    # -- edge <-> vertex transfer ------------------------------------------

    def gather_endpoints(self, x):
        """Per-edge endpoint values ``(x[eu], x[ev])``; x is [V] or [V, K]."""
        return x[self.eu], x[self.ev]

    def edge_to_vertex_sum(self, vals_u, vals_v):
        """``out[v] = sum_{eu[e]==v} vals_u[e] + sum_{ev[e]==v} vals_v[e]``,
        by gather + row sum over the incidence table."""
        pad = vals_u.new_zeros((1,) + tuple(vals_u.shape[1:]))
        vals = torch.cat([vals_u, vals_v, pad], dim=0)
        return vals[self.incidence].sum(dim=1)

    def edge_allsum(self, vals):
        return vals.sum()

    def vertex_allsum(self, vals):
        return vals.sum()

    def vertex_degree_weighted(self, edge_w):
        """Sum of ``edge_w`` over the edges incident to each vertex."""
        return self.edge_to_vertex_sum(edge_w, edge_w)
