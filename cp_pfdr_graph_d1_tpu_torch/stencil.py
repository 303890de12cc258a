"""Stencil graph container (counterpart of ``cp_pfdr_graph_d1_tpu.stencil``).

Vertices are the row-major cells of an ``(H, W)`` field; shift family ``f``
with offset ``(dy, dx)`` holds one edge per cell ``(i, j)`` towards
``((i + dy) mod H, (j + dx) mod W)``, so per-edge arrays have length
``F * H * W`` (family-major).  Endpoint gathers are ``torch.roll``s and the
edge->vertex accumulation is the inverse roll plus adds.  Every axis rolls
circularly; edges whose head leaves a non-wrapping axis carry weight zero,
which the solvers treat as absent.  The COO view is built lazily for the
host stages of cut-pursuit and keeps those zero-weight slots.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .config import numpy_dtype
from .graph import GraphD1
from .ops.stencil_fused import fused_stencil_iteration
from .ops.stencil_fused_simplex import fused_stencil_simplex_iteration


class StencilGraphD1(GraphD1):
    """d1 graph whose edges are shift families over a 2-D field."""

    def __init__(self, la_d1, field_shape: Tuple[int, int],
                 shifts: Tuple[Tuple[int, int], ...],
                 wrap: Tuple[bool, bool] = (False, False)):
        h, w = field_shape
        self.field_shape = (int(h), int(w))
        self.shifts = tuple((int(dy), int(dx)) for dy, dx in shifts)
        self.wrap = (bool(wrap[0]), bool(wrap[1]))
        self.la_d1 = la_d1
        self.num_vertices = self.field_shape[0] * self.field_shape[1]
        self.num_edges = len(self.shifts) * self.num_vertices
        self._coo = None
        self._host_coo = None
        self._incidence = None

    @classmethod
    def create(cls, field_shape, shift_weights, wrap=(False, False),
               dtype=torch.float32, device="cuda"):
        """Builds a stencil graph from ``{(dy, dx): weight}`` where weight is
        a scalar or an (H, W) array; positions whose head leaves a
        non-wrapping axis get weight zero."""
        h, w = field_shape
        np_dtype = numpy_dtype(dtype)
        shifts = tuple(shift_weights.keys())
        las = []
        for (dy, dx) in shifts:
            la = np.broadcast_to(
                np.asarray(shift_weights[(dy, dx)], np_dtype), (h, w)).copy()
            if not wrap[0]:
                if dy > 0:
                    la[h - dy:, :] = 0
                elif dy < 0:
                    la[:-dy, :] = 0
            if not wrap[1]:
                if dx > 0:
                    la[:, w - dx:] = 0
                elif dx < 0:
                    la[:, :-dx] = 0
            las.append(la)
        flat = torch.as_tensor(np.stack(las).reshape(-1), device=device)
        return cls(flat, (h, w), shifts, wrap)

    # -- COO view for host stages -------------------------------------------

    def _coo_arrays(self):
        if self._coo is None:
            h, w = self.field_shape
            idx = np.arange(h * w, dtype=np.int32).reshape(h, w)
            eus, evs = [], []
            for (dy, dx) in self.shifts:
                eus.append(idx.ravel())
                evs.append(np.roll(idx, (-dy, -dx), axis=(0, 1)).ravel())
            self._coo = (np.concatenate(eus), np.concatenate(evs))
        return self._coo

    @property
    def eu(self):
        """int32 numpy [E] tails of the COO view."""
        return self._coo_arrays()[0]

    @property
    def ev(self):
        """int32 numpy [E] heads of the COO view."""
        return self._coo_arrays()[1]

    def host_coo(self):
        if self._host_coo is None:
            eu, ev = self._coo_arrays()
            self._host_coo = (eu, ev, self.la_d1.cpu().numpy())
        return self._host_coo

    # -- gather-free edge access --------------------------------------------

    def gather_endpoints(self, x):
        f = len(self.shifts)
        h, w = self.field_shape
        rest = tuple(x.shape[1:])
        x3 = x.reshape((h, w) + rest)
        xu = x3.unsqueeze(0).expand((f, h, w) + rest)
        xv = torch.stack([torch.roll(x3, (-dy, -dx), dims=(0, 1))
                          for (dy, dx) in self.shifts])
        flat = (self.num_edges,) + rest
        return xu.reshape(flat), xv.reshape(flat)

    def edge_to_vertex_sum(self, vals_u, vals_v):
        f = len(self.shifts)
        h, w = self.field_shape
        rest = tuple(vals_u.shape[1:])
        vu = vals_u.reshape((f, h, w) + rest)
        vv = vals_v.reshape((f, h, w) + rest)
        out = vu.sum(dim=0)
        for k, (dy, dx) in enumerate(self.shifts):
            out = out + torch.roll(vv[k], (dy, dx), dims=(0, 1))
        return out.reshape((self.num_vertices,) + rest)

    def edge_to_vertex_min(self, vals_u, vals_v, init):
        """Roll-based min-reduction twin of :meth:`edge_to_vertex_sum`.
        Masked edges (the zero-weight slots of non-wrapping axes included)
        must carry ``init`` so that their wrapped-around positions are
        inert."""
        f = len(self.shifts)
        h, w = self.field_shape
        rest = tuple(vals_u.shape[1:])
        vu = vals_u.reshape((f, h, w) + rest)
        vv = vals_v.reshape((f, h, w) + rest)
        out = torch.clamp(vu.amin(dim=0), max=init)
        for k, (dy, dx) in enumerate(self.shifts):
            out = torch.minimum(out, torch.roll(vv[k], (dy, dx), dims=(0, 1)))
        return out.reshape((self.num_vertices,) + rest)

    # -- fused iteration ------------------------------------------------------

    def fused_iteration(self, x, grad, pre, zu, zv, rho: float, vprox):
        """One fused edge+vertex PFDR step (see
        :func:`..ops.stencil_fused.fused_stencil_iteration`)."""
        h, w = self.field_shape
        f = len(self.shifts)

        def rv(a):
            return a.reshape(h, w)

        def re(a):
            return a.reshape(f, h, w)

        xn, zun, zvn, num, den = fused_stencil_iteration(
            rv(x), rv(grad), rv(pre.ga), rv(pre.th_l1),
            re(zu), re(zv), re(pre.wu), re(pre.wv),
            re(pre.w_d1u), re(pre.w_d1v), re(pre.th_d1),
            shifts=self.shifts, rho=rho, vkind=vprox.kind,
            positivity=vprox.positivity, lo=float(vprox.lo),
            hi=float(vprox.hi))
        e = self.num_edges
        return xn.reshape(-1), zun.reshape(e), zvn.reshape(e), num, den

    def fused_simplex_iteration(self, p, q, la_f, ga, ga_proj, prev, zu, zv,
                                wu, wv, w_d1u, w_d1v, th_d1, *, rho: float,
                                al: float, has_laf: bool, label_mode: bool):
        """One fused multi-label PFDR step on ``[K, H, W]`` label planes and
        ``[F, K, H, W]`` edge planes (see
        :func:`..ops.stencil_fused_simplex.fused_stencil_simplex_iteration`)."""
        return fused_stencil_simplex_iteration(
            p, q, la_f, ga, ga_proj, prev, zu, zv, wu, wv, w_d1u, w_d1v,
            th_d1, shifts=self.shifts, rho=rho, al=al, has_laf=has_laf,
            label_mode=label_mode)

    # label planes of the multi-label kernel loop

    def vertex_planes(self, a):
        """[V, n] rows -> [n, H, W] planes."""
        return a.T.reshape(-1, *self.field_shape).contiguous()

    def vertex_rows(self, a):
        """[n, H, W] planes -> [V, n] rows."""
        return a.reshape(-1, self.num_vertices).T.contiguous()

    def edge_planes(self, a):
        """[E, K] rows (family-major E = F V) -> [F, K, H, W] planes."""
        f, k = len(self.shifts), a.shape[-1]
        return (a.reshape(f, self.num_vertices, k).permute(0, 2, 1)
                .reshape(f, k, *self.field_shape).contiguous())

    def edge_rows(self, a):
        """[F, K, H, W] planes -> [E, K] rows."""
        f, k = a.shape[:2]
        return (a.reshape(f, k, self.num_vertices).permute(0, 2, 1)
                .reshape(-1, k).contiguous())
