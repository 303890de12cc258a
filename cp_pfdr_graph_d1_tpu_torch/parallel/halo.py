"""Vertex-block (halo-exchange) distribution of stencil-graph PFDR
(counterpart of ``cp_pfdr_graph_d1_tpu.parallel.halo``).

The vertex field is cut into contiguous row blocks, one per rank; per-edge
work is local except at block boundaries, where each rank exchanges a halo
of ``max |dy|`` rows with its ring neighbours.  The iterate itself is
sharded, so the graph can exceed one card's memory; the only per-iteration
communication is the halo exchange (O(W) words), the ``[N]`` sum of the
column-sharded ``A x`` and the scalar sums of the stopping test.

The dense operator is column-sharded to match (:class:`ColShardDenseOp`):
each rank holds the columns of ``A`` for its vertex rows; ``A x`` is a
local product plus a sum over the ring, the adjoint and the Gram diagonal
are local.  On a CUDA device the quadratic loop runs each iteration's edge
and vertex stage through the hand-written kernels of
:mod:`..ops.halo_fused` (three steps around the two exchanges); the
multi-label loop runs the staged loop, as in the JAX package.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import Lipsch, PFDROptions
from ..operators import DenseOp
from ..ops.halo_fused import halo_fused_iteration
from ..solvers.pfdr_quadratic import (PFDRResult, VertexProx,
                                      pfdr_quadratic_d1)
from ..solvers.pfdr_simplex import SimplexResult, pfdr_loss_d1_simplex
from ..stencil import StencilGraphD1
from .mesh import Mesh, RingExchange, all_gather, all_sum, put_sharded


class HaloStencilGraphD1(StencilGraphD1):
    """One row-block shard of a stencil graph, in one rank of ``mesh``.

    ``field_shape`` is the *local* block ``(H_loc, W)``; endpoint access
    and edge->vertex accumulation exchange ``halo`` boundary rows with the
    ring neighbours.  The ring realizes a wrapped global axis 0; for a
    non-wrapped global field the boundary families carry zero weight in
    the first and last blocks, which makes the wrapped halo inert.
    """

    def __init__(self, la_d1, field_shape, shifts, wrap, mesh: Mesh):
        super().__init__(la_d1, field_shape, shifts, wrap)
        self.mesh = mesh
        self.halo = max((abs(dy) for dy, _ in self.shifts), default=0)

    # -- halo exchange ------------------------------------------------------

    def _extend_rows(self, x3):
        """``x3`` with ``halo`` rows of the ring neighbours before and after
        it along axis 0."""
        hd = self.halo
        if hd == 0:
            return x3
        top, bot = RingExchange(self.mesh, x3[-hd:], x3[:hd]).wait()
        return torch.cat([top, x3, bot], dim=0)

    def gather_endpoints(self, x):
        h, w = self.field_shape
        rest = tuple(x.shape[1:])
        x3 = x.reshape((h, w) + rest)
        ext = self._extend_rows(x3)
        hd = self.halo
        xu = x3.unsqueeze(0).expand((len(self.shifts),) + x3.shape)
        xv = torch.stack([torch.roll(ext[hd + dy:hd + dy + h], -dx, dims=1)
                          for (dy, dx) in self.shifts])
        flat = (self.num_edges,) + rest
        return xu.reshape(flat), xv.reshape(flat)

    def edge_to_vertex_sum(self, vals_u, vals_v):
        f = len(self.shifts)
        h, w = self.field_shape
        hd = self.halo
        rest = tuple(vals_u.shape[1:])
        vu = vals_u.reshape((f, h, w) + rest)
        vv = vals_v.reshape((f, h, w) + rest)
        out = vu.sum(dim=0)
        # vv lands at (i + dy, j + dx): extend each family's field by the
        # neighbours' rows (one exchange for all families) and take the
        # inversely shifted window
        ext = self._extend_rows(vv.movedim(0, 1)).movedim(1, 0)
        for k, (dy, dx) in enumerate(self.shifts):
            out = out + torch.roll(ext[k, hd - dy:hd - dy + h], dx, dims=1)
        return out.reshape((self.num_vertices,) + rest)

    def edge_to_vertex_min(self, vals_u, vals_v, init):
        raise NotImplementedError(
            "HaloStencilGraphD1 has no min-reduction; the sharded "
            "cut-pursuit runs its components on the block-internal graph")

    def vertex_allsum(self, vals):
        return all_sum(self.mesh, vals.sum())

    def edge_allsum(self, vals):
        return all_sum(self.mesh, vals.sum())

    def vertex_count_global(self):
        return self.num_vertices * self.mesh.size

    @property
    def supports_fused(self):
        # boundary rolls cross shard boundaries: the single-block kernels
        # do not apply (the quadratic loop takes the halo kernels instead)
        return False

    @property
    def supports_halo_fused(self):
        """Whether the halo kernels of :mod:`..ops.halo_fused` take this
        block: ``1 <= halo <= H_loc``."""
        return 1 <= self.halo <= self.field_shape[0]

    def fused_iteration(self, x, grad, pre, zu, zv, rho: float, vprox):
        """One edge+vertex PFDR step on this row block
        (:func:`..ops.halo_fused.halo_fused_iteration`); the stopping-test
        sums are summed over the ring, in rank order."""
        h, w = self.field_shape
        f = len(self.shifts)

        def rv(a):
            return a.reshape(h, w)

        def re(a):
            return a.reshape(f, h, w)

        xn, zun, zvn, num, den = halo_fused_iteration(
            rv(x), rv(grad), rv(pre.ga), rv(pre.th_l1),
            re(zu), re(zv), re(pre.wu), re(pre.wv),
            re(pre.w_d1u), re(pre.w_d1v), re(pre.th_d1),
            shifts=self.shifts, hd=self.halo, rho=rho, vkind=vprox.kind,
            positivity=vprox.positivity, lo=float(vprox.lo),
            hi=float(vprox.hi), exchange=partial(RingExchange, self.mesh))
        sums = all_sum(self.mesh, torch.stack([num, den]))
        e = self.num_edges
        return (xn.reshape(-1), zun.reshape(e), zvn.reshape(e), sums[0],
                sums[1])


class ColShardDenseOp(DenseOp):
    """Dense operator with its V (column) axis sharded to match a
    vertex-sharded iterate: ``A x`` sums the partial products over the
    ring; the adjoint and the Gram diagonal are local."""

    def __init__(self, a, mesh: Mesh):
        super().__init__(a)
        self.mesh = mesh

    def apply(self, x):
        return all_sum(self.mesh, self.a @ x)

    def residual(self, x, obs):
        return obs - self.apply(x)

    def gram_apply(self, x):
        return self.a.T @ self.apply(x)

    def ones_image(self, num_vertices, obs):
        a1 = all_sum(self.mesh, self.a.sum(dim=1))
        return torch.dot(a1, obs), torch.dot(a1, a1)


class HaloShardedProblem(NamedTuple):
    a: np.ndarray        # [P, N, V_loc] column blocks
    obs: np.ndarray      # [N]
    la_d1: np.ndarray    # [P, F * H_loc * W]
    field_shape: tuple   # global (H, W)
    shifts: tuple
    wrap: tuple


def _row_blocks(h: int, shifts, num_shards: int) -> int:
    """Block height; raises unless H divides and blocks hold the halo."""
    if h % num_shards:
        raise ValueError(f"H={h} not divisible by {num_shards} shards")
    h_loc = h // num_shards
    hd = max((abs(dy) for dy, _ in shifts), default=0)
    if h_loc < hd:
        raise ValueError(f"block height {h_loc} smaller than halo {hd}")
    return h_loc


def _la_blocks(graph: StencilGraphD1, h_loc: int, num_shards: int):
    h, w = graph.field_shape
    f = len(graph.shifts)
    la = graph.la_d1
    la = (la.cpu().numpy() if isinstance(la, torch.Tensor)
          else np.asarray(la)).reshape(f, h, w)
    return np.stack([la[:, p * h_loc:(p + 1) * h_loc, :].reshape(-1)
                     for p in range(num_shards)])


def shard_stencil_problem(a, obs, graph: StencilGraphD1,
                          num_shards: int) -> HaloShardedProblem:
    """Splits the field's rows (and the dense operator's columns) into
    ``num_shards`` blocks.  Requires H divisible by ``num_shards`` and a
    block height of at least the halo depth.  ``a`` may be a numpy array or
    a tensor (kept on its device)."""
    h, w = graph.field_shape
    h_loc = _row_blocks(h, graph.shifts, num_shards)
    n = a.shape[0]
    blocks = a.reshape(n, num_shards, h_loc * w)
    a_s = (blocks.permute(1, 0, 2) if isinstance(a, torch.Tensor)
           else np.ascontiguousarray(np.asarray(blocks).transpose(1, 0, 2)))
    return HaloShardedProblem(a_s, obs, _la_blocks(graph, h_loc, num_shards),
                              (h, w), graph.shifts, graph.wrap)


def _vertex_block(v, h: int, w: int, h_loc: int, rank: int, dtype, device):
    """This rank's rows of a per-vertex array (scalar broadcast)."""
    v = (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
    v = np.broadcast_to(v, (h * w,)).reshape(h, w)
    return torch.as_tensor(np.array(v[rank * h_loc:(rank + 1) * h_loc])
                           .reshape(-1), dtype=dtype, device=device)


def pfdr_quadratic_d1_halo(problem: HaloShardedProblem, mesh: Mesh, *,
                           la_l1=None, vprox: VertexProx = VertexProx(),
                           lipsch=None, ltype: Lipsch = Lipsch.SCAL,
                           opt: PFDROptions = PFDROptions(),
                           axis: str = "dp", device="cuda") -> PFDRResult:
    """Runs the PFDR solve with a row-sharded iterate, in every rank of
    ``mesh`` (each passes the whole problem and takes its block); returns
    the result with ``x`` gathered back to the full [V] on every rank."""
    h, w = problem.field_shape
    h_loc = _row_blocks(h, problem.shifts, mesh.size)
    a_loc = put_sharded(problem.a, mesh, device).contiguous()
    dtype = a_loc.dtype
    obs = torch.as_tensor(problem.obs, dtype=dtype, device=device)
    op = ColShardDenseOp(a_loc, mesh)
    graph = HaloStencilGraphD1(
        put_sharded(problem.la_d1, mesh, device).to(dtype), (h_loc, w),
        problem.shifts, problem.wrap, mesh)
    if la_l1 is not None:
        la_l1 = _vertex_block(la_l1, h, w, h_loc, mesh.rank, dtype, device)
    res = pfdr_quadratic_d1(op, obs, graph, la_l1=la_l1, vprox=vprox,
                            lipsch=lipsch, ltype=ltype, opt=opt)
    return res._replace(x=all_gather(mesh, res.x).reshape(-1))


class HaloSimplexProblem(NamedTuple):
    q: np.ndarray        # [P, H_loc * W, K] row blocks of the observation
    la_d1: np.ndarray    # [P, F * H_loc * W]
    la_f: np.ndarray     # [P, H_loc * W] or None
    field_shape: tuple   # global (H, W)
    shifts: tuple
    wrap: tuple


def shard_stencil_simplex_problem(q, graph: StencilGraphD1,
                                  num_shards: int,
                                  la_f=None) -> HaloSimplexProblem:
    """Row-block partition of a multi-label stencil problem: both the
    [V, K] observation and iterate and the per-(edge, label) work are
    sharded; per-iteration communication is the O(W K) halo exchange."""
    h, w = graph.field_shape
    h_loc = _row_blocks(h, graph.shifts, num_shards)
    q = np.asarray(q)
    k = q.shape[-1]
    q_s = q.reshape(num_shards, h_loc * w, k)
    if la_f is not None:
        la_f = np.asarray(np.broadcast_to(la_f, (h * w,)), q.dtype)
        la_f = la_f.reshape(num_shards, h_loc * w)
    return HaloSimplexProblem(q_s, _la_blocks(graph, h_loc, num_shards),
                              la_f, (h, w), graph.shifts, graph.wrap)


def pfdr_loss_d1_simplex_halo(problem: HaloSimplexProblem, mesh: Mesh, *,
                              al: float, opt: PFDROptions = PFDROptions(),
                              monitor: bool = False, axis: str = "dp",
                              device="cuda") -> SimplexResult:
    """Runs the multi-label PFDR solve with a row-sharded [V, K] iterate in
    every rank of ``mesh`` (the staged loop, as in the JAX package);
    returns the result with ``p`` gathered to [V, K] on every rank."""
    h, w = problem.field_shape
    h_loc = _row_blocks(h, problem.shifts, mesh.size)
    q_loc = put_sharded(problem.q, mesh, device)
    graph = HaloStencilGraphD1(
        put_sharded(problem.la_d1, mesh, device).to(q_loc.dtype),
        (h_loc, w), problem.shifts, problem.wrap, mesh)
    la_f = (put_sharded(problem.la_f, mesh, device)
            if problem.la_f is not None else None)
    res = pfdr_loss_d1_simplex(graph, q_loc, al=al, la_f=la_f, opt=opt,
                               monitor=monitor)
    return res._replace(p=all_gather(mesh, res.p).reshape(h * w, -1))
