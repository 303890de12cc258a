"""Graph container (counterpart of ``cp_pfdr_graph_d1_tpu.graph``).

The edge->vertex accumulation keeps the JAX package's design: a padded
incidence table ``inc[v, d]`` lists the endpoint slots incident to each
vertex (slot ``e`` is edge ``e``'s u-endpoint, slot ``E + e`` its
v-endpoint, the sentinel ``2E`` selects a pad), and the accumulation is a
gather plus a row reduction.  It is deterministic: ``index_add_`` on CUDA
sums with float atomics in an order that changes from run to run, which
would change PFDR iteration counts between runs.

The table is built on the tensors' device from the per-vertex incidence
list (:func:`incidence_csr`).  It holds ``V x max degree`` entries, so a
hub vertex makes it wide: a contracted cut-pursuit graph of ``rv``
components with one component adjacent to all others holds ``rv**2``
(4096 components: 134 MB of int64).  Cut-pursuit hands such reduced
graphs to :class:`~.banded_graph.BandedGraphD1`, whose kernels walk the
incidence list itself (``solvers/cut_pursuit_common
.make_reduced_container``), as the JAX package does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import numpy_dtype


def incidence_csr(eu, ev, num_vertices: int):
    """Per-vertex incidence list of the endpoint slots (slot ``s < E`` is
    edge ``s``'s u-end, ``E + s`` its v-end), sorted by slot within each
    vertex: ``(offsets int32 [V + 1], slots int32 [2E])``, on the device of
    ``eu``.  Raises on an endpoint outside ``[0, num_vertices)``: the
    kernels index vertex arrays by endpoint."""
    slot_vertex = torch.cat([eu, ev]).to(torch.int64)
    if slot_vertex.numel():
        lo, hi = (int(v) for v in torch.aminmax(slot_vertex))
        if lo < 0 or hi >= num_vertices:
            raise ValueError(f"edge endpoints span [{lo}, {hi}], outside "
                             f"the {num_vertices} vertices")
    order = torch.sort(slot_vertex, stable=True).indices
    counts = torch.bincount(slot_vertex, minlength=num_vertices)
    offsets = torch.zeros(num_vertices + 1, dtype=torch.int64,
                          device=eu.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets.to(torch.int32), order.to(torch.int32)


def csr_table(offsets, slots):
    """Padded [V, max degree] int64 table of a CSR incidence list; the
    sentinel ``len(slots)`` marks a pad."""
    offsets = offsets.to(torch.int64)
    deg = offsets[1:] - offsets[:-1]
    width = max(int(deg.max()) if deg.numel() else 0, 1)
    k = torch.arange(width, device=offsets.device)
    pos = (offsets[:-1, None] + k[None]).clamp(max=max(slots.numel() - 1, 0))
    return torch.where(k[None] < deg[:, None], slots.to(torch.int64)[pos],
                       slots.numel())


class GraphD1:
    """Undirected graph with per-edge d1 (total-variation) weights.

    Attributes:
      eu, ev: int64 [E] endpoint tensors (0-based).
      la_d1: [E] nonnegative edge weights.
      num_vertices, num_edges: Python ints.
    """

    def __init__(self, eu, ev, la_d1, num_vertices: int):
        self.eu = eu
        self.ev = ev
        self.la_d1 = la_d1
        self.num_vertices = int(num_vertices)
        self.num_edges = int(eu.shape[0])
        self._incidence = None
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
        """int64 [V, max degree] endpoint-slot table (sentinel ``2E``),
        built once on the graph's device."""
        if self._incidence is None:
            self._incidence = csr_table(*incidence_csr(self.eu, self.ev,
                                                       self.num_vertices))
        return self._incidence

    def _gather_slots(self, vals_u, vals_v, pad_value):
        pad = vals_u.new_full((1,) + tuple(vals_u.shape[1:]), pad_value)
        return torch.cat([vals_u, vals_v, pad], dim=0)[self.incidence]

    # -- edge <-> vertex transfer ------------------------------------------

    def gather_endpoints(self, x):
        """Per-edge endpoint values ``(x[eu], x[ev])``; x is [V] or [V, K]."""
        return x[self.eu], x[self.ev]

    def edge_to_vertex_sum(self, vals_u, vals_v):
        """``out[v] = sum_{eu[e]==v} vals_u[e] + sum_{ev[e]==v} vals_v[e]``,
        by gather + row sum over the incidence table."""
        return self._gather_slots(vals_u, vals_v, 0).sum(dim=1)

    def edge_to_vertex_min(self, vals_u, vals_v, init):
        """``out[v] = min(init, min_{eu[e]==v} vals_u[e],
        min_{ev[e]==v} vals_v[e])``: the min-reduction twin of
        :meth:`edge_to_vertex_sum` (device connected components), by
        gather + row minimum over the incidence table.  Entries the caller
        wants ignored must carry ``init``."""
        out = self._gather_slots(vals_u, vals_v, init).amin(dim=1)
        return torch.clamp(out, max=init)

    def edge_allsum(self, vals):
        return vals.sum()

    def vertex_allsum(self, vals):
        return vals.sum()

    def vertex_degree_weighted(self, edge_w):
        """Sum of ``edge_w`` over the edges incident to each vertex
        (self-loops count twice)."""
        return self.edge_to_vertex_sum(edge_w, edge_w)
