"""Circulant-decomposition graph container: unstructured graphs as offset
families (counterpart of ``cp_pfdr_graph_d1_tpu.circulant``).

After a locality-preserving vertex order (:func:`strip_order` on mesh
coordinates, or :func:`.ops.banded.rcm_order`), most edges of a mesh fall
on a few dozen distinct index offsets ``d = ev - eu``.  Edges are bucketed
by offset into dense families: family ``f`` owns one slot per padded vertex
``u`` for the potential edge ``(u, u + d_f)``.  Offsets too rare for a
family go to a remainder held by a :class:`.banded_graph.BandedGraphD1`.

Edge order, as in the JAX package: edge ``e = f * VV + u`` is family
``f``'s slot ``u`` (``VV`` the vertex count padded to a multiple of 1024;
empty slots are inert weight-0 edges ``(0, 0)``), followed by the
remainder's edges in its own order.  Per-edge solver quantities follow this
order.  The staged transfers are plain gathers and a sum over the incidence
table of the real edges only (:func:`_masked_incidence`); the fused PFDR
stages are the hand-written kernels of :mod:`.ops.circulant_fused` and
:mod:`.ops.circulant_fused_simplex`, which read the offsets ``d_f`` from an
int32 device array.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .banded_graph import BandedGraphD1
from .config import numpy_dtype
from .graph import GraphD1
from .ops.circulant_fused import fused_circulant_iteration
from .ops.circulant_fused_simplex import (MAX_LABELS,
                                          fused_circulant_simplex_iteration)


def strip_order(coords, nstrips: Optional[int] = None):
    """Locality-preserving vertex order from mesh coordinates.

    Rotates to principal axes, cuts the first axis into equal-population
    strips (``~sqrt(V)/2`` of them) and orders vertices strip-major (within
    a strip by the second axis), so mesh neighbours land a near-constant
    index offset apart.  Returns ``order`` (position -> old vertex index);
    relabel with ``inv[order] = arange(V)`` and permute every per-vertex
    quantity.
    """
    c = np.asarray(coords, np.float64)
    if c.ndim != 2 or c.shape[0] < 2:
        raise ValueError("coords must be [V, dim] with V >= 2")
    c = c - c.mean(axis=0)
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    proj = c @ vt.T
    v = c.shape[0]
    if nstrips is None:
        nstrips = max(1, int(round(np.sqrt(v) / 2)))
    rank = np.argsort(np.argsort(proj[:, 0], kind="stable"), kind="stable")
    strip = np.minimum(rank // max(v // nstrips, 1), nstrips - 1)
    b = proj[:, 1] if proj.shape[1] > 1 else np.zeros(v)
    return np.lexsort((b, strip))


def offset_coverage(eu, ev, max_families: int = 64) -> float:
    """Fraction of edges whose index offset ``|ev - eu|`` falls on the
    ``max_families`` most frequent offsets: what the families would hold.
    The ``container="auto"`` rule reads it."""
    d = np.abs(np.asarray(ev, np.int64) - np.asarray(eu, np.int64))
    if d.size == 0:
        return 0.0
    _, counts = np.unique(d, return_counts=True)
    counts = np.sort(counts)[::-1]
    return float(counts[:max_families].sum()) / float(counts.sum())


def _masked_incidence(eu, ev, real, num_vertices: int):
    """Incidence table over the real edges only (int32 ``[V, D]``, the
    layout of :func:`.graph.csr_table`, sentinel ``2E``): virtual family
    slots and remainder padding are left out."""
    e = len(eu)
    slots_vertex = np.concatenate([eu, ev]).astype(np.int64)
    realm = np.concatenate([real, real])
    idx = np.nonzero(realm)[0]
    sv = slots_vertex[idx]
    order = np.argsort(sv, kind="stable")
    degrees = np.bincount(sv, minlength=num_vertices)
    max_deg = max(int(degrees.max(initial=0)), 1)
    inc = np.full((num_vertices, max_deg), 2 * e, dtype=np.int32)
    offsets = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    within = np.arange(len(idx), dtype=np.int64) - offsets[sv[order]]
    inc[sv[order], within] = idx[order].astype(np.int32)
    return inc


class CirculantGraphD1(GraphD1):
    """d1 graph decomposed into dense offset families plus a remainder."""

    def __init__(self, eu, ev, la_d1, num_vertices: int, incidence,
                 offsets_dev, rem_graph, offsets, vv8: int):
        super().__init__(eu, ev, la_d1, num_vertices)
        self._incidence = incidence
        self.offsets_dev = offsets_dev
        self.rem_graph = rem_graph
        self.offsets = tuple(int(d) for d in offsets)
        self.vv8 = int(vv8)
        self.num_rem = 0 if rem_graph is None else rem_graph.num_edges
        self._stage_plans = {}  # ops.circulant_fused's launch plans

    @property
    def vv(self) -> int:
        """Padded vertex count: the slots of one family."""
        return self.vv8 * 128

    @classmethod
    def create(cls, eu, ev, la_d1, num_vertices: Optional[int] = None,
               dtype=torch.float32, max_families: int = 64,
               min_count: Optional[int] = None,
               device="cuda") -> "CirculantGraphD1":
        """Builds the decomposition from host edge arrays, as the JAX
        package does.

        Args:
          max_families: cap on dense families (most frequent offsets
            first).
          min_count: offsets with fewer edges than this go to the remainder
            (default ``max(16, V // 512)``).
        """
        eu = np.asarray(eu, np.int64)
        ev = np.asarray(ev, np.int64)
        la = np.asarray(la_d1)
        if la.ndim == 0:
            la = np.full(eu.shape, la)
        la = la.astype(numpy_dtype(dtype))
        if num_vertices is None:
            num_vertices = int(max(eu.max(initial=-1), ev.max(initial=-1))
                               + 1)
        v = int(num_vertices)
        if min_count is None:
            min_count = max(16, v // 512)
        # orient every edge toward the positive offset
        flip = ev < eu
        eu2 = np.where(flip, ev, eu)
        ev2 = np.where(flip, eu, ev)
        d = ev2 - eu2
        offs, counts = np.unique(d, return_counts=True)
        # at least one family: when even the most frequent offset is rarer
        # than min_count, the floor drops to keep the densest offset
        keep = counts >= min(min_count, int(counts.max(initial=1)))
        offs, counts = offs[keep], counts[keep]
        top = np.argsort(counts, kind="stable")[::-1][:max_families]
        fam_offsets = offs[top]
        nf = len(fam_offsets)
        if nf == 0:
            raise ValueError("empty edge set")

        vv8 = -(-v // 1024) * 8
        vv = vv8 * 128
        la_f = np.zeros((nf, vv), la.dtype)
        assigned = np.zeros((nf, vv), bool)
        rem_mask = np.ones(len(eu2), bool)
        for f, dd in enumerate(fam_offsets):
            sel = np.nonzero(d == dd)[0]
            uniq, first = np.unique(eu2[sel], return_index=True)
            la_f[f, uniq] = la[sel[first]]
            assigned[f, uniq] = True
            rem_mask[sel[first]] = False
        eu_r = eu2[rem_mask].astype(np.int32)
        ev_r = ev2[rem_mask].astype(np.int32)
        la_r = la[rem_mask]
        coverage = 1.0 - len(eu_r) / max(len(eu2), 1)
        if coverage < 0.5:
            warnings.warn(
                f"circulant decomposition covers only {coverage:.0%} of "
                f"edges with dense families ({len(eu_r)} of {len(eu2)} "
                "edges fall to the remainder); relabel vertices with a "
                "locality-preserving order (strip_order on coordinates, or "
                "ops.banded.rcm_order) before building the graph",
                stacklevel=2)

        if len(eu_r):
            rem_graph = BandedGraphD1.create(eu_r, ev_r, la_r,
                                             num_vertices=v, dtype=dtype,
                                             device=device)
            eu_r, ev_r, la_r = rem_graph.host_coo()
        else:
            rem_graph = None

        u_grid = np.broadcast_to(np.arange(vv, dtype=np.int64), (nf, vv))
        eu_fam = np.where(assigned, u_grid, 0)
        ev_fam = np.where(assigned, u_grid + fam_offsets[:, None], 0)
        eu_full = np.concatenate([eu_fam.ravel(), eu_r]).astype(np.int32)
        ev_full = np.concatenate([ev_fam.ravel(), ev_r]).astype(np.int32)
        la_full = np.concatenate([la_f.ravel(), la_r])
        real = np.concatenate([assigned.ravel(), la_r != 0])
        incidence = _masked_incidence(eu_full, ev_full, real, v)
        g = cls(torch.as_tensor(eu_full, dtype=torch.int64, device=device),
                torch.as_tensor(ev_full, dtype=torch.int64, device=device),
                torch.as_tensor(la_full, device=device), v,
                torch.as_tensor(incidence, dtype=torch.int64, device=device),
                torch.as_tensor(fam_offsets.astype(np.int32), device=device),
                rem_graph, fam_offsets, vv8)
        g._host_coo = (eu_full, ev_full, la_full)
        return g

    # -- fused iterations -----------------------------------------------------

    def supports_fused_simplex(self, k: int) -> bool:
        """Whether ``circulant_fused_simplex`` takes ``k`` labels: at most
        ``MAX_LABELS``."""
        return k <= MAX_LABELS

    def fused_iteration(self, x, grad, pre, zu, zv, rho: float, vprox):
        """One fused edge + vertex PFDR step over the families and the
        remainder (see
        :func:`.ops.circulant_fused.fused_circulant_iteration`)."""
        return fused_circulant_iteration(
            self, x, grad, pre.ga, pre.th_l1, zu, zv, pre.wu, pre.wv,
            pre.w_d1u, pre.w_d1v, pre.th_d1, rho=rho, vkind=vprox.kind,
            positivity=vprox.positivity, lo=float(vprox.lo),
            hi=float(vprox.hi))

    def fused_simplex_iteration(self, p, q, la_f, ga, ga_proj, prev, zu, zv,
                                wu, wv, w_d1u, w_d1v, th_d1, *, rho: float,
                                al: float, has_laf: bool, label_mode: bool):
        """One fused multi-label PFDR step on ``[K, V]`` label planes and
        ``[K, E]`` edge planes (see
        :func:`.ops.circulant_fused_simplex
        .fused_circulant_simplex_iteration`)."""
        return fused_circulant_simplex_iteration(
            self, p, q, la_f, ga, ga_proj, prev, zu, zv, wu, wv, w_d1u,
            w_d1v, th_d1, rho=rho, al=al, has_laf=has_laf,
            label_mode=label_mode)

    # label planes of the multi-label kernel loop: a [V, n] or [E, K] row
    # field is the transpose of its [n, V] or [K, E] planes

    def vertex_planes(self, a):
        return a.T.contiguous()

    def vertex_rows(self, a):
        return a.T.contiguous()

    edge_planes = vertex_planes
    edge_rows = vertex_rows
