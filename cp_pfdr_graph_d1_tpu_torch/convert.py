"""Carry-over of the JAX package's objects into the port.

The port cannot import ``jax``, so the caller hands over numpy arrays and
plain values (``np.asarray`` on each JAX array, ``dataclasses.asdict`` on an
options object); these functions build the port's objects from them.  The
tests feed both packages the same problem this way, and a solve started in
the JAX package resumes in the port from its :class:`PFDRSolveState`,
:class:`CPState`, :class:`SimplexSolveState` or :class:`CPSimplexState`,
and the sharded problems of :mod:`.parallel` carry over field by field.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .banded_graph import BandedGraphD1
from .circulant import CirculantGraphD1
from .config import CPOptions, PFDROptions
from .graph import GraphD1
from .operators import DenseOp, DiagOp, GramOp, IdentityOp
from .parallel.dp import ShardedQuadraticProblem, ShardedSimplexProblem
from .parallel.halo import HaloShardedProblem, HaloSimplexProblem
from .solvers.cut_pursuit import CPState
from .solvers.cut_pursuit_simplex import CPSimplexState
from .solvers.pfdr_quadratic import Precond, PFDRSolveState
from .solvers.pfdr_simplex import SimplexPrecond, SimplexSolveState
from .stencil import StencilGraphD1


def _tensor(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _torch_dtype(a: np.ndarray):
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


def graph(eu, ev, la_d1, num_vertices: int, device="cuda") -> GraphD1:
    """:class:`GraphD1` from a JAX ``GraphD1``'s ``eu``, ``ev``, ``la_d1``
    and ``num_vertices``; the weights keep their dtype."""
    la = np.asarray(la_d1)
    return GraphD1.create(np.asarray(eu), np.asarray(ev), la,
                          num_vertices=int(num_vertices),
                          dtype=_torch_dtype(la), device=device)


def stencil_graph(la_d1, field_shape, shifts, wrap,
                  device="cuda") -> StencilGraphD1:
    """:class:`StencilGraphD1` from a JAX ``StencilGraphD1``'s flat
    ``la_d1`` (zero-weight slots included), ``field_shape``, ``shifts`` and
    ``wrap``."""
    return StencilGraphD1(_tensor(la_d1, device), tuple(field_shape),
                          tuple(tuple(s) for s in shifts), tuple(wrap))


def banded_graph(eu, ev, la_d1, num_vertices: int, tile: int = 1024,
                 mode: str = "auto", device="cuda") -> BandedGraphD1:
    """:class:`BandedGraphD1` from the host edge arrays and creation
    arguments of a JAX ``BandedGraphD1`` (``BandedGraphD1.create``'s
    ``eu``, ``ev``, ``la_d1``, ``num_vertices``, ``tile``; its
    ``round_wd8`` shapes only the TPU window and has no counterpart); the
    edge order, which a solve state follows, is the JAX container's.
    Passing the JAX container's own (sorted, padded) ``eu``/``ev``/``la_d1``
    gives the same container.  The JAX modes "full" and "interpret" mean
    "auto" here."""
    la = np.asarray(la_d1)
    return BandedGraphD1.create(
        np.asarray(eu), np.asarray(ev), la, num_vertices=int(num_vertices),
        dtype=_torch_dtype(la), tile=int(tile),
        mode="jnp" if mode == "jnp" else "auto", device=device)


def circulant_graph(eu, ev, la_d1, num_vertices: int, max_families: int = 64,
                    min_count=None, device="cuda") -> CirculantGraphD1:
    """:class:`CirculantGraphD1` from the host edge arrays and creation
    arguments of a JAX ``CirculantGraphD1`` (``CirculantGraphD1.create``'s
    ``eu``, ``ev``, ``la_d1``, ``num_vertices``, ``max_families``,
    ``min_count``); the edge order is the JAX container's."""
    la = np.asarray(la_d1)
    return CirculantGraphD1.create(
        np.asarray(eu), np.asarray(ev), la, num_vertices=int(num_vertices),
        dtype=_torch_dtype(la),
        max_families=int(max_families), min_count=min_count, device=device)


def operator(kind: str, array=None, device="cuda"):
    """Operator from a JAX operator's class name (``"DenseOp"``,
    ``"GramOp"``, ``"DiagOp"``, ``"IdentityOp"``) and array (``a``,
    ``gram`` or ``diag``; none for the identity)."""
    if kind == "IdentityOp":
        return IdentityOp()
    cls = {"DenseOp": DenseOp, "GramOp": GramOp, "DiagOp": DiagOp}.get(kind)
    if cls is None:
        raise ValueError(f"unknown operator kind {kind!r}")
    return cls(_tensor(array, device))


def pfdr_options(fields: dict) -> PFDROptions:
    """:class:`PFDROptions` from ``dataclasses.asdict`` of the JAX one."""
    return PFDROptions(**fields)


def cp_options(fields: dict) -> CPOptions:
    """:class:`CPOptions` from ``dataclasses.asdict`` of the JAX one (its
    nested ``pfdr`` a dict); the routes the port lacks raise
    :class:`NotImplementedError`."""
    fields = dict(fields)
    pfdr = fields.pop("pfdr", None)
    if isinstance(pfdr, dict):
        fields["pfdr"] = pfdr_options(pfdr)
    elif pfdr is not None:
        fields["pfdr"] = pfdr_options(dataclasses.asdict(pfdr))
    return CPOptions(**fields)


def pfdr_solve_state(x, zu, zv, pre, x_prev, dif, dif_rcd2, it,
                     device="cuda") -> PFDRSolveState:
    """:class:`PFDRSolveState` from the fields of the JAX one; ``pre`` is
    the sequence of its seven ``Precond`` arrays (ga, wu, wv, w_d1u, w_d1v,
    th_d1, th_l1).  The edge arrays keep the JAX container's edge order,
    so resume on the same kind of container."""
    return PFDRSolveState(
        x=_tensor(x, device), zu=_tensor(zu, device),
        zv=_tensor(zv, device),
        pre=Precond(*(_tensor(a, device) for a in pre)),
        x_prev=_tensor(x_prev, device), dif=_tensor(dif, device),
        dif_rcd2=_tensor(dif_rcd2, device), it=int(np.asarray(it)))


def cp_state(active, cv, rx) -> CPState:
    """:class:`CPState` (host arrays) from the fields of the JAX one."""
    return CPState(active=np.array(active, bool),
                   cv=np.array(cv, np.int32), rx=np.array(rx))


def simplex_solve_state(p, zu, zv, pre, prev, dif, dif_rcd, it,
                        device="cuda") -> SimplexSolveState:
    """:class:`SimplexSolveState` from the fields of the JAX one; ``pre`` is
    the sequence of its seven ``SimplexPrecond`` arrays (ga, ga_proj, wu,
    wv, w_d1u, w_d1v, th_d1).  The edge arrays keep the JAX container's
    edge order, so resume on the same kind of container."""
    return SimplexSolveState(
        p=_tensor(p, device), zu=_tensor(zu, device), zv=_tensor(zv, device),
        pre=SimplexPrecond(*(_tensor(a, device) for a in pre)),
        prev=_tensor(prev, device), dif=_tensor(dif, device),
        dif_rcd=_tensor(dif_rcd, device), it=int(np.asarray(it)))


def cp_simplex_state(active, cv, rp) -> CPSimplexState:
    """:class:`CPSimplexState` (host arrays) from the fields of the JAX
    one."""
    return CPSimplexState(active=np.array(active, bool),
                          cv=np.array(cv, np.int32), rp=np.array(rp))


def halo_problem(a, obs, la_d1, field_shape, shifts,
                 wrap) -> HaloShardedProblem:
    """:class:`..parallel.halo.HaloShardedProblem` from the fields of the
    JAX one (``a`` [P, N, V_loc], ``obs`` [N], ``la_d1`` [P, F V_loc])."""
    return HaloShardedProblem(np.asarray(a), np.asarray(obs),
                              np.asarray(la_d1), _shape(field_shape),
                              _shifts(shifts), _shape(wrap, bool))


def halo_simplex_problem(q, la_d1, la_f, field_shape, shifts,
                         wrap) -> HaloSimplexProblem:
    """:class:`..parallel.halo.HaloSimplexProblem` from the fields of the
    JAX one (``q`` [P, V_loc, K], ``la_f`` [P, V_loc] or None)."""
    return HaloSimplexProblem(np.asarray(q), np.asarray(la_d1),
                              None if la_f is None else np.asarray(la_f),
                              _shape(field_shape), _shifts(shifts),
                              _shape(wrap, bool))


def sharded_quadratic_problem(a, obs, eu, ev, la_d1, incidence,
                              num_vertices) -> ShardedQuadraticProblem:
    """:class:`..parallel.dp.ShardedQuadraticProblem` from the fields of
    the JAX one; its local incidence tables (sentinel ``2 E_loc``) are used
    as they are."""
    return ShardedQuadraticProblem(
        np.asarray(a), np.asarray(obs), np.asarray(eu, np.int32),
        np.asarray(ev, np.int32), np.asarray(la_d1),
        np.asarray(incidence, np.int32), int(num_vertices))


def sharded_simplex_problem(q, eu, ev, la_d1, incidence,
                            num_vertices) -> ShardedSimplexProblem:
    """:class:`..parallel.dp.ShardedSimplexProblem` from the fields of the
    JAX one."""
    return ShardedSimplexProblem(
        np.asarray(q), np.asarray(eu, np.int32), np.asarray(ev, np.int32),
        np.asarray(la_d1), np.asarray(incidence, np.int32),
        int(num_vertices))


def _shape(t, kind=int):
    return tuple(kind(v) for v in t)


def _shifts(shifts):
    return tuple((int(dy), int(dx)) for dy, dx in shifts)
