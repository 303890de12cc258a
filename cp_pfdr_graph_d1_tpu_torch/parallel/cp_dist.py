"""Distributed cut-pursuit with the operator sharded over the ranks
(counterpart of ``cp_pfdr_graph_d1_tpu.parallel.cp_dist``).

The JAX package places the operator with a ``NamedSharding`` and lets the
SPMD partitioner insert the collectives.  PyTorch has no such placement,
so the port writes them out, in operators that the cut-pursuit loop of
:mod:`..solvers.cut_pursuit` takes like any other:

* dense mode (:class:`DistCPDenseOp`): the observation axis N is sharded,
  each rank holding an [N/P, V] row block of A and the matching y block (N
  zero-padded to a multiple of P: a zero row is inert in every product the
  solver forms).  The gradient ``A^t (A x - y)`` is a local product and a
  [V] sum over the ranks; the reduced-operator contraction (the one-hot
  product of ``CP_PFDR_graph_quadratic_d1_l1.cpp:663-772``) runs on the
  local rows and the [N/P, rV] blocks are gathered into the whole
  [N, rV] product;
* Gram mode (:class:`DistGramOp`, the reference's premultiplied path): the
  V-by-V Gram is row-sharded (``V %% P == 0``); ``A^t A x`` gathers the row
  blocks and the reduced Gram is a sum of the ranks' [rV, rV] parts;
* diagonal and identity modes: the operator is replicated.

In the device loop and the chain the dense contraction takes the device
loop's size rule: one-hot products up to ``ONEHOT_MAX`` components,
segment sums over the rank's rows beyond (never premultiplied there); a
Gram beyond it raises, as on one device.

The reduced problem is then the same on every rank, and every rank solves
it the same way (the ``solve_small`` / ``solve_fused`` kernels on a CUDA
device, which cannot sum across ranks inside).  The combinatorial stages
(min-cut, components, contraction, merge) run on replicated arrays, as in
the single-device solver: on the host with ``cut="host"``, on the device
(the per-iteration device loop or the chained loop) with ``cut="device"``.
The sums over the ranks are added in rank order (:func:`.mesh.all_sum`)
and the cut and components kernels repeat bit for bit, so every rank holds
the same bits and takes the same decisions: the same partition at every
cut-pursuit iteration, which the next collective relies on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CPOptions
from ..graph import GraphD1
from ..operators import (DenseOp, DiagOp, GramOp, IdentityOp, QuadOp,
                         RankShardedOp)
from ..solvers.cut_pursuit import (CPResult, CPState, cp_quadratic_d1,
                                   reduced_dense, reduced_gram)
from ..solvers.cut_pursuit_common import one_hot, run_sums
from ..solvers.cut_pursuit_simplex import cp_loss_d1_simplex
from .dp import DistDenseOp
from .mesh import Mesh, all_gather, all_sum


class DistCPDenseOp(DistDenseOp, RankShardedOp):
    """Observation-sharded dense operator of the distributed cut-pursuit:
    :class:`.dp.DistDenseOp` plus the reduced-problem contraction.
    ``num_obs`` is the padded global N."""

    def __init__(self, a, mesh: Mesh):
        super().__init__(a, mesh)
        self.num_obs = a.shape[0] * mesh.size

    def reduced(self, obs, cv, rv_cap: int, pre_at: bool, onehot_max: int):
        """``(r_op, mat, ry, lipsch)`` of the problem contracted onto
        ``cv``, the same on every rank: the local [N/P, rV] component
        column sums (a one-hot product up to ``onehot_max`` components,
        segment sums over the sorted vertices beyond, never premultiplied
        there), gathered to [N, rV]."""
        if rv_cap <= onehot_max:
            ra_loc = self.a @ one_hot(cv, rv_cap, self.a.dtype)
        else:
            ra_loc = run_sums(self.a.T, cv, rv_cap).T
            pre_at = False
        ra = all_gather(self.mesh, ra_loc).reshape(self.num_obs, rv_cap)
        y = all_gather(self.mesh, obs).reshape(-1)
        mat, ry, lipsch = reduced_dense(ra, y, rv_cap, pre_at)
        return (GramOp(mat) if pre_at else DenseOp(mat)), mat, ry, lipsch


class DistGramOp(GramOp, RankShardedOp):
    """Row-sharded premultiplied Gram ``A^t A``: each rank holds the
    [V/P, V] rows of its vertex block; the observation ``A^t y`` is
    replicated."""

    def __init__(self, gram, mesh: Mesh):
        super().__init__(gram)
        self.mesh = mesh
        self.row0 = gram.shape[0] * mesh.rank

    def gram_apply(self, x):
        return all_gather(self.mesh, self.gram @ x).reshape(-1)

    def gram_diag(self, num_vertices, dtype, device):
        rows = self.gram.shape[0]
        loc = torch.diagonal(self.gram[:, self.row0:self.row0 + rows])
        return all_gather(self.mesh, loc).reshape(-1).to(dtype)

    def grad(self, x, obs):
        return self.gram_apply(x) - obs

    def quad_obj(self, x, obs):
        return torch.dot(x, 0.5 * self.gram_apply(x) - obs)

    def ones_image(self, num_vertices, obs):
        return obs.sum(), all_sum(self.mesh, self.gram.sum())

    def reduced(self, obs, cv, rv_cap: int, pre_at: bool, onehot_max: int):
        """The reduced Gram as the sum of the ranks' ``S_loc^t (G_loc S)``
        parts, the same on every rank (one-hot at every size: beyond
        ``onehot_max`` the device loop raises before it gets here, as for a
        single-device Gram)."""
        s = one_hot(cv, rv_cap, self.gram.dtype)
        s_loc = s[self.row0:self.row0 + self.gram.shape[0]]
        raa = all_sum(self.mesh, s_loc.T @ (self.gram @ s))
        mat, ry, lipsch = reduced_gram(raa, obs @ s, rv_cap)
        return GramOp(mat), mat, ry, lipsch


def _array(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def shard_cp_quadratic_problem(op: QuadOp, obs, mesh: Mesh,
                               axis: str = "dp", device="cuda"):
    """This rank's share of the quadratic operator and observation:
    ``(op, obs)`` ready for :func:`cp_quadratic_d1_dist`.  Dense operators
    are zero-padded along the observation axis to a multiple of the ranks
    and row-sharded; Gram operators require the vertex count to divide
    evenly; diagonal and identity operators are replicated."""
    n_dev = mesh.size
    r = mesh.rank
    if isinstance(op, DenseOp):
        a, y = _array(op.a), _array(obs)
        n = a.shape[0]
        n_pad = -(-n // n_dev) * n_dev
        if n_pad != n:
            a = np.pad(a, ((0, n_pad - n), (0, 0)))
            y = np.pad(y, (0, n_pad - n))
        rows = n_pad // n_dev
        return (DistCPDenseOp(torch.as_tensor(a[r * rows:(r + 1) * rows],
                                              device=device), mesh),
                torch.as_tensor(y[r * rows:(r + 1) * rows], device=device))
    if isinstance(op, GramOp):
        g = _array(op.gram)
        v = g.shape[0]
        if v % n_dev:
            raise ValueError(
                f"gram mode needs num_vertices ({v}) divisible by the mesh "
                f"size ({n_dev}); pad the graph with isolated vertices")
        rows = v // n_dev
        return (DistGramOp(torch.as_tensor(g[r * rows:(r + 1) * rows],
                                           device=device), mesh),
                torch.as_tensor(_array(obs), device=device))
    if isinstance(op, (DiagOp, IdentityOp)):
        if isinstance(op, DiagOp):
            op = DiagOp(torch.as_tensor(_array(op.diag), device=device))
        return op, torch.as_tensor(_array(obs), device=device)
    raise TypeError(f"unsupported operator type {type(op).__name__}")


def cp_quadratic_d1_dist(op: QuadOp, obs, graph: GraphD1, mesh: Mesh, *,
                         la_l1=None, positivity: bool = False,
                         bounds=None, duplex: bool = False,
                         opt: CPOptions = CPOptions(),
                         monitor: bool = False,
                         state: CPState | None = None,
                         axis: str = "dp", device="cuda") -> CPResult:
    """Cut-pursuit solve with the operator sharded over the ranks of
    ``mesh``, run in every rank (each passes the whole problem).

    Same contract as :func:`..solvers.cut_pursuit.cp_quadratic_d1`; the
    result is the same on every rank.  The operator and observation are
    placed by :func:`shard_cp_quadratic_problem` unless ``op`` is already a
    sharded operator (then ``obs`` is its share).  ``cut``, ``chain`` and
    ``duplex`` pass through as in the JAX package: ``cut="host"`` runs the
    host loop; ``cut="device"`` the per-iteration device loop or, where
    :func:`..solvers.cut_pursuit_chain.chain_admissible` admits the
    problem, the chained loop, with the sharded operator (its gradient and
    contraction summed over the ranks, the cuts and components replicated).
    The host-small route stays off: it would run the sharded stages on one
    host, as in the JAX package."""
    if not isinstance(op, RankShardedOp) and isinstance(
            op, (DenseOp, GramOp, DiagOp, IdentityOp)):
        op, obs = shard_cp_quadratic_problem(op, obs, mesh, axis, device)
    opt = dataclasses.replace(opt, host_small="off")
    return cp_quadratic_d1(op, obs, graph, la_l1=la_l1,
                           positivity=positivity, bounds=bounds,
                           duplex=duplex, opt=opt, monitor=monitor,
                           state=state)


def cp_loss_d1_simplex_dist(graph: GraphD1, q, mesh: Mesh, *, al: float,
                            opt: CPOptions = CPOptions(),
                            monitor: bool = False, state=None,
                            axis: str = "dp", device="cuda"):
    """Multi-label cut-pursuit with the [V, K] observation row-sharded over
    the ranks of ``mesh`` (V zero-padded to a multiple of the ranks; zero
    rows are inert in every stage), run in every rank.

    The O(V K) stages, the loss gradient
    (``CP_PFDR_graph_loss_d1_simplex.cpp:327-354``) and the reduced
    observation sums (``:733-766``), run on each rank's rows: the gradient
    is gathered, the [rV, K] sums are summed over the ranks; the
    alpha-expansion cuts and the reduced solve run on replicated arrays.
    Same contract as :func:`..solvers.cut_pursuit_simplex
    .cp_loss_d1_simplex`."""
    q_np = _array(q)
    rows = -(-q_np.shape[0] // mesh.size)
    q_np = np.pad(q_np, ((0, rows * mesh.size - q_np.shape[0]), (0, 0)))
    q_loc = torch.as_tensor(q_np[mesh.rank * rows:(mesh.rank + 1) * rows],
                            device=device)
    opt = dataclasses.replace(opt, host_small="off")
    return cp_loss_d1_simplex(graph, q_loc, al=al, opt=opt, monitor=monitor,
                              state=state, device_obs=True, mesh=mesh)
