"""Multi-rank PFDR: observation- and edge-sharded data parallelism
(counterpart of ``cp_pfdr_graph_d1_tpu.parallel.dp``).

Partitioning of the full-graph PFDR solve, as in the JAX package:

* the observation axis ``N`` of the dense operator is sharded across the
  ranks (each holds a row block of ``A`` and of ``y``): the gradient
  ``A^t r`` is one sum over the ranks per iteration;
* the edge set is sharded (each rank holds an edge block and its *local*
  incidence table): the edge prox is local, and the edge->vertex averaging
  is a local gather plus row sum followed by a sum over the ranks;
* the iterate ``x`` ([V]) is replicated: every rank computes the same
  vertex work on the same summed values (the sums are added in rank order,
  so the replicas keep the same bits).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Lipsch, PFDROptions
from ..graph import GraphD1, csr_table, incidence_csr
from ..operators import DenseOp
from ..solvers.pfdr_quadratic import (PFDRResult, VertexProx,
                                      pfdr_quadratic_d1)
from ..solvers.pfdr_simplex import SimplexResult, pfdr_loss_d1_simplex
from .mesh import Mesh, all_sum, put_sharded


class DistDenseOp(DenseOp):
    """Dense operator whose N (observation) axis is sharded over the ranks
    of ``mesh``: adjoint applications and scalar reductions sum over
    them."""

    def __init__(self, a, mesh: Mesh):
        super().__init__(a)
        self.mesh = mesh

    def apply_t(self, r):
        return all_sum(self.mesh, self.a.T @ r)

    def gram_diag(self, num_vertices, dtype, device):
        return all_sum(self.mesh, (self.a * self.a).sum(dim=0)).to(dtype)

    def quad_obj(self, x, obs):
        r = self.residual(x, obs)
        return 0.5 * all_sum(self.mesh, torch.dot(r, r))

    def ones_image(self, num_vertices, obs):
        a1 = self.a.sum(dim=1)
        s = all_sum(self.mesh, torch.stack([torch.dot(a1, obs),
                                            torch.dot(a1, a1)]))
        return s[0], s[1]


class EdgeShardGraphD1(GraphD1):
    """One rank's block of the edges of a graph whose vertex arrays are
    replicated: the edge->vertex sum and the edge sums add the ranks'
    partial results; vertex sums are local (every rank holds them all)."""

    def __init__(self, eu, ev, la_d1, num_vertices: int, mesh: Mesh,
                 incidence=None):
        super().__init__(eu, ev, la_d1, num_vertices)
        self.mesh = mesh
        self._incidence = incidence

    def edge_to_vertex_sum(self, vals_u, vals_v):
        return all_sum(self.mesh, super().edge_to_vertex_sum(vals_u, vals_v))

    def edge_allsum(self, vals):
        return all_sum(self.mesh, vals.sum())


class ShardedQuadraticProblem(NamedTuple):
    """Host-prepared shards (leading axis = rank)."""
    a: np.ndarray          # [P, N/P, V]
    obs: np.ndarray        # [P, N/P]
    eu: np.ndarray         # [P, E/P]
    ev: np.ndarray         # [P, E/P]
    la_d1: np.ndarray      # [P, E/P]
    incidence: np.ndarray  # [P, V, D] local slot tables
    num_vertices: int


def _pad_to(x, n, axis=0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def _incidence(eu, ev, num_vertices: int) -> np.ndarray:
    """int32 [V, D] endpoint-slot table of an edge block (sentinel 2E)."""
    t = csr_table(*incidence_csr(torch.as_tensor(eu), torch.as_tensor(ev),
                                 num_vertices))
    return t.numpy().astype(np.int32)


def _shard_edges(eu, ev, la_d1, num_shards: int, num_vertices: int,
                 dtype=np.float32):
    """Splits the edge set into ``num_shards`` balanced blocks and builds
    each block's local incidence table (padded to a common width with the
    local sentinel ``2 E_loc``).  Zero-weight spread self-loops pad the
    remainder: inert in the solvers."""
    eu = np.asarray(eu, np.int32)
    ev = np.asarray(ev, np.int32)
    la = np.asarray(np.broadcast_to(la_d1, eu.shape), dtype)
    v = num_vertices
    e = eu.shape[0]
    e_pad = -(-e // num_shards) * num_shards
    extra = e_pad - e
    if extra:
        spread = (np.arange(extra) % v).astype(np.int32)
        eu = np.concatenate([eu, spread])
        ev = np.concatenate([ev, spread])
        la = np.concatenate([la, np.zeros(extra, dtype)])
    e_loc = e_pad // num_shards
    eu_s = eu.reshape(num_shards, e_loc)
    ev_s = ev.reshape(num_shards, e_loc)
    la_s = la.reshape(num_shards, e_loc)
    incs = [_incidence(eu_s[p], ev_s[p], v) for p in range(num_shards)]
    d = max(i.shape[1] for i in incs)
    inc_s = np.stack([np.pad(i, ((0, 0), (0, d - i.shape[1])),
                             constant_values=2 * e_loc) for i in incs])
    return eu_s, ev_s, la_s, inc_s


def shard_quadratic_problem(a, obs, eu, ev, la_d1, num_shards: int,
                            dtype=np.float32) -> ShardedQuadraticProblem:
    """Splits observations and edges into ``num_shards`` balanced blocks.
    Zero rows and zero-weight spread self-loops pad the remainders: both
    are inert in the solver."""
    a = np.asarray(a, dtype)
    obs = np.asarray(obs, dtype)
    n, v = a.shape
    n_pad = -(-n // num_shards) * num_shards
    a = _pad_to(a, n_pad)
    obs = _pad_to(obs, n_pad)
    eu_s, ev_s, la_s, inc_s = _shard_edges(eu, ev, la_d1, num_shards, v,
                                           dtype)
    return ShardedQuadraticProblem(
        a.reshape(num_shards, n_pad // num_shards, v),
        obs.reshape(num_shards, n_pad // num_shards),
        eu_s, ev_s, la_s, inc_s, v)


def _edge_graph(problem, mesh: Mesh, device) -> EdgeShardGraphD1:
    return EdgeShardGraphD1(
        put_sharded(problem.eu, mesh, device).to(torch.int64),
        put_sharded(problem.ev, mesh, device).to(torch.int64),
        put_sharded(problem.la_d1, mesh, device), problem.num_vertices,
        mesh, incidence=put_sharded(problem.incidence, mesh,
                                    device).to(torch.int64))


def pfdr_quadratic_d1_sharded(problem: ShardedQuadraticProblem, mesh: Mesh,
                              *, la_l1=None,
                              vprox: VertexProx = VertexProx(),
                              lipsch=None, ltype: Lipsch = Lipsch.SCAL,
                              opt: PFDROptions = PFDROptions(),
                              axis: str = "dp",
                              device="cuda") -> PFDRResult:
    """Runs the full PFDR solve in every rank of ``mesh`` (each passes the
    whole problem and takes its blocks); the result is replicated.

    Communication per iteration: one sum for the gradient adjoint, one for
    the edge->vertex averaging, and the scalar sums of the stopping test's
    edge terms."""
    a_loc = put_sharded(problem.a, mesh, device)
    obs_loc = put_sharded(problem.obs, mesh, device)
    if la_l1 is not None:
        la_l1 = torch.as_tensor(np.array(np.broadcast_to(
            la_l1, (problem.num_vertices,))), dtype=a_loc.dtype,
            device=device)
    return pfdr_quadratic_d1(DistDenseOp(a_loc, mesh), obs_loc,
                             _edge_graph(problem, mesh, device), la_l1=la_l1,
                             vprox=vprox, lipsch=lipsch, ltype=ltype, opt=opt)


class ShardedSimplexProblem(NamedTuple):
    """Host-prepared edge shards of a multi-label problem; the [V, K]
    observation (and iterate) stay replicated."""
    q: np.ndarray          # [V, K]
    eu: np.ndarray         # [P, E/P]
    ev: np.ndarray         # [P, E/P]
    la_d1: np.ndarray      # [P, E/P]
    incidence: np.ndarray  # [P, V, D]
    num_vertices: int


def shard_simplex_problem(q, eu, ev, la_d1, num_shards: int,
                          dtype=np.float32) -> ShardedSimplexProblem:
    """Edge partition of a loss + d1 + simplex problem: the per-(edge,
    label) prox work is split across the ranks; the [V, K] state is
    replicated."""
    q = np.asarray(q, dtype)
    v = q.shape[0]
    eu_s, ev_s, la_s, inc_s = _shard_edges(eu, ev, la_d1, num_shards, v,
                                           dtype)
    return ShardedSimplexProblem(q, eu_s, ev_s, la_s, inc_s, v)


def pfdr_loss_d1_simplex_sharded(problem: ShardedSimplexProblem,
                                 mesh: Mesh, *, al: float, la_f=None,
                                 opt: PFDROptions = PFDROptions(),
                                 monitor: bool = False, axis: str = "dp",
                                 device="cuda") -> SimplexResult:
    """Runs the multi-label PFDR solve in every rank of ``mesh``.
    Communication per iteration: one [V, K] sum for the edge->vertex
    averaging (the loss gradient and the simplex projection act on the
    replicated state)."""
    q = torch.as_tensor(problem.q, device=device)
    if la_f is not None:
        la_f = torch.as_tensor(np.array(np.broadcast_to(
            la_f, (problem.num_vertices,))), dtype=q.dtype, device=device)
    return pfdr_loss_d1_simplex(_edge_graph(problem, mesh, device), q, al=al,
                                la_f=la_f, opt=opt, monitor=monitor)
