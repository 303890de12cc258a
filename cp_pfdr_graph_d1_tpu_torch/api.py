"""Reference-parity functional API (counterpart of
``cp_pfdr_graph_d1_tpu.api``): the quadratic entries of the l1 and bounds
families, for the dense, ``AtA`` and ``l22`` operators.

Cut-pursuit entries return ``(Cv, rX, it, Time, Obj, Dif, state)`` with
the full solution ``x = rX[Cv]`` (``rX`` of shape [rV, K] for the
multi-label entry); PFDR entries return ``(X, it, Obj, Dif)`` with ``X`` a
tensor.  Every entry takes ``device`` (default ``"cuda"``); the CPU must be
asked for by name.  The dtype is float64 when an input is float64, float32
otherwise.  The PFDR entries take ``container``: "coo", "circulant"
(:class:`~.circulant.CirculantGraphD1`), or "auto", which picks the
circulant container for tensors on a CUDA device when the graph has at
least 4096 edges and at least 70 % of them fall on the 64 most frequent
index offsets (:func:`~.circulant.offset_coverage`), and COO otherwise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .circulant import CirculantGraphD1, offset_coverage
from .config import CPOptions, Lipsch, PFDROptions
from .graph import GraphD1
from .operators import DenseOp, DiagOp, GramOp, IdentityOp
from .solvers.cut_pursuit import cp_quadratic_d1
from .solvers.cut_pursuit_simplex import cp_loss_d1_simplex as _cp_simplex
from .solvers.pfdr_quadratic import VertexProx, pfdr_quadratic_d1
from .solvers.pfdr_simplex import pfdr_loss_d1_simplex


class CPOutput(NamedTuple):
    Cv: np.ndarray
    rX: np.ndarray
    it: int
    Time: np.ndarray
    Obj: np.ndarray
    Dif: np.ndarray
    state: object


class PFDROutput(NamedTuple):
    X: torch.Tensor
    it: int
    Obj: torch.Tensor
    Dif: torch.Tensor


def _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin, PFDR_difRcd,
                PFDR_difTol, PFDR_itMax, verbose,
                inexact: str = "auto") -> CPOptions:
    """Cut-pursuit options of the compatibility wrappers; ``inexact="off"``
    reproduces the reference trajectory (every reduced solve at full
    accuracy)."""
    return CPOptions(
        dif_tol=float(CP_difTol), it_max=int(CP_itMax),
        pfdr=PFDROptions(rho=float(PFDR_rho), cond_min=float(PFDR_condMin),
                         dif_rcd=float(PFDR_difRcd),
                         dif_tol=float(PFDR_difTol), it_max=int(PFDR_itMax)),
        verbose=int(verbose), inexact=inexact)


def _graph(Eu, Ev, La_d1, num_vertices, dtype, device,
           container: str = "coo"):
    """Builds the graph container: "coo" (:class:`GraphD1`), "circulant"
    (:class:`CirculantGraphD1`) or "auto" (the circulant container for a
    CUDA device, at least 4096 edges and an offset coverage of at least
    0.7, as the JAX package's rule with "TPU" read as "CUDA device"; COO
    otherwise)."""
    if container == "auto":
        if (torch.device(device).type == "cuda"
                and len(np.asarray(Eu)) >= 4096
                and offset_coverage(Eu, Ev) >= 0.7):
            container = "circulant"
        else:
            container = "coo"
    if container == "circulant":
        return CirculantGraphD1.create(Eu, Ev, La_d1,
                                       num_vertices=num_vertices,
                                       dtype=dtype, device=device)
    if container != "coo":
        raise ValueError(f"unknown container {container!r}")
    return GraphD1.create(Eu, Ev, La_d1, num_vertices=num_vertices,
                          dtype=dtype, device=device)


def _dtype_of(*arrays):
    for a in arrays:
        if a is not None and np.asarray(a).dtype == np.float64:
            return torch.float64
    return torch.float32


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _cp_run(op, obs, graph, la_l1, positivity, bounds, duplex, opt,
            monitor, state):
    res = cp_quadratic_d1(op, obs, graph, la_l1=la_l1,
                          positivity=bool(positivity), bounds=bounds,
                          duplex=duplex, opt=opt, monitor=monitor,
                          state=state)
    return CPOutput(res.cv, res.rx, res.it, res.time, res.obj, res.dif,
                    res.state)


def _l22_operator(Y, La_l2, num_v, dtype, device):
    """Identity or weighted-diagonal operator of the l22 entries, the
    premultiplied observation and the constant ``1/2 ||y||^2_{La_l2}``."""
    if La_l2 is None:
        return (IdentityOp(), _tensor(Y, dtype, device),
                0.5 * float(np.dot(Y, Y)))
    w = np.broadcast_to(np.asarray(La_l2), (num_v,))
    return (DiagOp(_tensor(w, dtype, device)), _tensor(w * Y, dtype, device),
            0.5 * float(np.dot(w * Y, Y)))


# ---------------------------------------------------------------------------
# cut-pursuit entries, l1 family
# ---------------------------------------------------------------------------

def cp_quadratic_d1_l1(Y, A, Eu, Ev, La_d1, La_l1=None, positivity=False,
                       CP_difTol=1e-3, CP_itMax=10, PFDR_rho=1.0,
                       PFDR_condMin=1e-3, PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                       PFDR_itMax=10_000, verbose=0, duplex=False,
                       monitor=False, state=None, graph=None,
                       inexact="auto", device="cuda") -> CPOutput:
    """Fused LASSO ``1/2||y - A x||^2 + d1 + l1`` with dense N-by-V ``A``
    (``CP_PFDR_graph_quadratic_d1_l1_mex.cpp:12``; ``duplex=True`` selects
    the two-layer ternary cut).  Pass a prebuilt ``graph`` (e.g. a
    :class:`~.stencil.StencilGraphD1` on ``device``) to skip the COO
    construction; ``Eu``/``Ev``/``La_d1`` are then ignored."""
    dtype = _dtype_of(Y, A)
    a = _tensor(A, dtype, device)
    g = graph if graph is not None else _graph(Eu, Ev, La_d1, a.shape[1],
                                               dtype, device)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    return _cp_run(DenseOp(a), _tensor(Y, dtype, device), g, La_l1,
                   positivity, None, duplex, opt, monitor, state)


def cp_quadratic_d1_l1_AtA(AtY, AtA, Eu, Ev, La_d1, La_l1=None,
                           positivity=False, CP_difTol=1e-3, CP_itMax=10,
                           PFDR_rho=1.0, PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                           PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                           duplex=False, monitor=False, state=None,
                           inexact="auto", device="cuda") -> CPOutput:
    """Premultiplied variant: arguments are ``A^t Y`` and ``A^t A``."""
    dtype = _dtype_of(AtY, AtA)
    gram = _tensor(AtA, dtype, device)
    g = _graph(Eu, Ev, La_d1, gram.shape[1], dtype, device)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    return _cp_run(GramOp(gram), _tensor(AtY, dtype, device), g, La_l1,
                   positivity, None, duplex, opt, monitor, state)


def cp_l22_d1_l1(Y, La_l2, Eu, Ev, La_d1, La_l1=None, positivity=False,
                 CP_difTol=1e-3, CP_itMax=10, PFDR_rho=1.0,
                 PFDR_condMin=1e-3, PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                 PFDR_itMax=10_000, verbose=0, duplex=False, monitor=False,
                 state=None, inexact="auto", device="cuda") -> CPOutput:
    """Weighted-distance case ``1/2||y - x||^2_{La_l2} + d1 + l1``
    (``CP_PFDR_graph_l22_d1_l1_mex.cpp:65-94``); ``La_l2=None`` means the
    identity."""
    Y = np.asarray(Y)
    dtype = _dtype_of(Y, La_l2)
    num_v = Y.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype, device)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    op, obs, y2 = _l22_operator(Y, La_l2, num_v, dtype, device)
    out = _cp_run(op, obs, g, La_l1, positivity, None, duplex, opt, monitor,
                  state)
    if monitor and len(out.Obj):
        out = out._replace(Obj=out.Obj + y2)
    return out


# ---------------------------------------------------------------------------
# cut-pursuit entries, bounds family
# ---------------------------------------------------------------------------

def cp_quadratic_d1_bounds(Y, A, Eu, Ev, La_d1, m=-np.inf, M=np.inf,
                           CP_difTol=1e-3, CP_itMax=10, PFDR_rho=1.0,
                           PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                           PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                           monitor=False, state=None, inexact="auto",
                           device="cuda") -> CPOutput:
    """Box-constrained variant
    (``CP_PFDR_graph_quadratic_d1_bounds_mex.cpp``)."""
    dtype = _dtype_of(Y, A)
    a = _tensor(A, dtype, device)
    g = _graph(Eu, Ev, La_d1, a.shape[1], dtype, device)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    return _cp_run(DenseOp(a), _tensor(Y, dtype, device), g, None, False,
                   (float(m), float(M)), False, opt, monitor, state)


def cp_quadratic_d1_bounds_AtA(AtY, AtA, Eu, Ev, La_d1, m=-np.inf,
                               M=np.inf, CP_difTol=1e-3, CP_itMax=10,
                               PFDR_rho=1.0, PFDR_condMin=1e-3,
                               PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                               PFDR_itMax=10_000, verbose=0, monitor=False,
                               state=None, inexact="auto",
                               device="cuda") -> CPOutput:
    dtype = _dtype_of(AtY, AtA)
    gram = _tensor(AtA, dtype, device)
    g = _graph(Eu, Ev, La_d1, gram.shape[1], dtype, device)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    return _cp_run(GramOp(gram), _tensor(AtY, dtype, device), g, None,
                   False, (float(m), float(M)), False, opt, monitor, state)


def cp_l22_d1_bounds(Y, La_l2, Eu, Ev, La_d1, m=-np.inf, M=np.inf,
                     CP_difTol=1e-3, CP_itMax=10, PFDR_rho=1.0,
                     PFDR_condMin=1e-3, PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                     PFDR_itMax=10_000, verbose=0, monitor=False,
                     state=None, inexact="auto", device="cuda") -> CPOutput:
    Y = np.asarray(Y)
    dtype = _dtype_of(Y, La_l2)
    num_v = Y.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype, device)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    op, obs, y2 = _l22_operator(Y, La_l2, num_v, dtype, device)
    out = _cp_run(op, obs, g, None, False, (float(m), float(M)), False, opt,
                  monitor, state)
    if monitor and len(out.Obj):
        out = out._replace(Obj=out.Obj + y2)
    return out


# ---------------------------------------------------------------------------
# cut-pursuit entry, simplex family
# ---------------------------------------------------------------------------

def cp_loss_d1_simplex(Q, al, Eu, Ev, La_d1, CP_difTol=1e-3, CP_itMax=10,
                       PFDR_rho=1.0, PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                       PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                       monitor=False, state=None, inexact="auto",
                       device="cuda") -> CPOutput:
    """Multi-label solve
    (``octave/mex/CP_PFDR_graph_loss_d1_simplex_mex.cpp:12``); ``Q`` is
    [V, K] vertex-major; returns ``rX`` of shape [rV, K]."""
    Q = np.asarray(Q)
    dtype = _dtype_of(Q)
    g = _graph(Eu, Ev, La_d1, Q.shape[0], dtype, device)
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    res = _cp_simplex(g, _tensor(Q, dtype, device), al=float(al), opt=opt,
                      monitor=monitor, state=state)
    return CPOutput(res.cv, res.rp, res.it, res.time, res.obj, res.dif,
                    res.state)


# ---------------------------------------------------------------------------
# PFDR-only entries
# ---------------------------------------------------------------------------

def _l1_prox(La_l1, positivity, num_v):
    """Vertex prox and l1 weights of the l1-family PFDR entries."""
    if La_l1 is not None:
        return VertexProx(kind="l1", positivity=bool(positivity)), La_l1
    if positivity:
        return VertexProx(kind="l1", positivity=True), np.zeros(num_v)
    return VertexProx(), None


def _pfdr_run(op, obs, g, la_l1, vprox, L, rho, condMin, difRcd, difTol,
              itMax, monitor, x0=None, verbose=0):
    ltype = Lipsch.SCAL
    lipsch = None
    if L is not None:
        L = np.asarray(L)
        if L.ndim == 0 or L.size == 1:
            lipsch = float(L)
        else:
            lipsch = torch.as_tensor(L, dtype=obs.dtype, device=obs.device)
            ltype = Lipsch.DIAG
    if la_l1 is not None:
        la_l1 = torch.as_tensor(
            np.array(np.broadcast_to(np.asarray(la_l1), (g.num_vertices,))),
            dtype=obs.dtype, device=obs.device)
    if x0 is not None:
        x0 = torch.as_tensor(np.asarray(x0), dtype=obs.dtype,
                             device=obs.device)
    res = pfdr_quadratic_d1(
        op, obs, g, la_l1=la_l1, vprox=vprox, lipsch=lipsch, ltype=ltype,
        x0=x0, opt=PFDROptions(rho=float(rho), cond_min=float(condMin),
                               dif_rcd=float(difRcd), dif_tol=float(difTol),
                               it_max=int(itMax), verbose=int(verbose)),
        monitor=monitor)
    empty = obs.new_zeros(0)
    return PFDROutput(res.x, res.it,
                      res.obj[:res.it + 1] if monitor else empty,
                      res.dif[:res.it] if monitor else empty)


def pfdr_quadratic_d1_l1(Y, A, Eu, Ev, La_d1, La_l1=None, positivity=False,
                         L=None, PFDR_rho=1.0, PFDR_condMin=1e-3,
                         PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                         PFDR_itMax=10_000, verbose=0, monitor=False,
                         x0=None, container="auto",
                         device="cuda") -> PFDROutput:
    """Inner solver alone on the full graph
    (``PFDR_graph_quadratic_d1_l1_mex.cpp``).  ``L`` is the Lipschitz
    information: scalar = SCAL, [V] array = DIAG."""
    dtype = _dtype_of(Y, A)
    a = _tensor(A, dtype, device)
    g = _graph(Eu, Ev, La_d1, a.shape[1], dtype, device, container)
    vprox, la_l1 = _l1_prox(La_l1, positivity, a.shape[1])
    return _pfdr_run(DenseOp(a), _tensor(Y, dtype, device), g, la_l1, vprox,
                     L, PFDR_rho, PFDR_condMin, PFDR_difRcd, PFDR_difTol,
                     PFDR_itMax, monitor, x0, verbose)


def pfdr_quadratic_d1_l1_AtA(AtY, AtA, Eu, Ev, La_d1, La_l1=None,
                             positivity=False, L=None, PFDR_rho=1.0,
                             PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                             PFDR_difTol=1e-4, PFDR_itMax=10_000,
                             verbose=0, monitor=False, x0=None,
                             container="auto", device="cuda") -> PFDROutput:
    dtype = _dtype_of(AtY, AtA)
    gram = _tensor(AtA, dtype, device)
    g = _graph(Eu, Ev, La_d1, gram.shape[1], dtype, device, container)
    vprox, la_l1 = _l1_prox(La_l1, positivity, gram.shape[1])
    return _pfdr_run(GramOp(gram), _tensor(AtY, dtype, device), g, la_l1,
                     vprox, L, PFDR_rho, PFDR_condMin, PFDR_difRcd,
                     PFDR_difTol, PFDR_itMax, monitor, x0, verbose)


def pfdr_l22_d1_l1(Y, La_l2, Eu, Ev, La_d1, La_l1=None, positivity=False,
                   L=None, PFDR_rho=1.0, PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                   PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                   monitor=False, x0=None, container="auto",
                   device="cuda") -> PFDROutput:
    Y = np.asarray(Y)
    dtype = _dtype_of(Y, La_l2)
    num_v = Y.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype, device, container)
    vprox, la_l1 = _l1_prox(La_l1, positivity, num_v)
    op, obs, _ = _l22_operator(Y, La_l2, num_v, dtype, device)
    return _pfdr_run(op, obs, g, la_l1, vprox, L, PFDR_rho, PFDR_condMin,
                     PFDR_difRcd, PFDR_difTol, PFDR_itMax, monitor, x0,
                     verbose)


def pfdr_quadratic_d1_bounds(Y, A, Eu, Ev, La_d1, m=-np.inf, M=np.inf,
                             L=None, PFDR_rho=1.0, PFDR_condMin=1e-3,
                             PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                             PFDR_itMax=10_000, verbose=0, monitor=False,
                             x0=None, container="auto",
                             device="cuda") -> PFDROutput:
    dtype = _dtype_of(Y, A)
    a = _tensor(A, dtype, device)
    g = _graph(Eu, Ev, La_d1, a.shape[1], dtype, device, container)
    return _pfdr_run(DenseOp(a), _tensor(Y, dtype, device), g, None,
                     VertexProx(kind="bounds", lo=float(m), hi=float(M)),
                     L, PFDR_rho, PFDR_condMin, PFDR_difRcd, PFDR_difTol,
                     PFDR_itMax, monitor, x0, verbose)


def pfdr_quadratic_d1_bounds_AtA(AtY, AtA, Eu, Ev, La_d1, m=-np.inf,
                                 M=np.inf, L=None, PFDR_rho=1.0,
                                 PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                                 PFDR_difTol=1e-4, PFDR_itMax=10_000,
                                 verbose=0, monitor=False, x0=None,
                                 container="auto",
                                 device="cuda") -> PFDROutput:
    dtype = _dtype_of(AtY, AtA)
    gram = _tensor(AtA, dtype, device)
    g = _graph(Eu, Ev, La_d1, gram.shape[1], dtype, device, container)
    return _pfdr_run(GramOp(gram), _tensor(AtY, dtype, device), g, None,
                     VertexProx(kind="bounds", lo=float(m), hi=float(M)),
                     L, PFDR_rho, PFDR_condMin, PFDR_difRcd, PFDR_difTol,
                     PFDR_itMax, monitor, x0, verbose)


def pfdr_l22_d1_bounds(Y, La_l2, Eu, Ev, La_d1, m=-np.inf, M=np.inf,
                       L=None, PFDR_rho=1.0, PFDR_condMin=1e-3,
                       PFDR_difRcd=0.0, PFDR_difTol=1e-4, PFDR_itMax=10_000,
                       verbose=0, monitor=False, x0=None, container="auto",
                       device="cuda") -> PFDROutput:
    Y = np.asarray(Y)
    dtype = _dtype_of(Y, La_l2)
    num_v = Y.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype, device, container)
    op, obs, _ = _l22_operator(Y, La_l2, num_v, dtype, device)
    return _pfdr_run(op, obs, g, None,
                     VertexProx(kind="bounds", lo=float(m), hi=float(M)),
                     L, PFDR_rho, PFDR_condMin, PFDR_difRcd, PFDR_difTol,
                     PFDR_itMax, monitor, x0, verbose)


def pfdr_loss_d1_simplex_api(Q, al, Eu, Ev, La_d1, La_f=None, PFDR_rho=1.0,
                             PFDR_condMin=1e-3, PFDR_difRcd=0.0,
                             PFDR_difTol=1e-4, PFDR_itMax=10_000, verbose=0,
                             monitor=False, P0=None,
                             device="cuda") -> PFDROutput:
    """Standalone multi-label inner solver
    (``octave/mex/PFDR_graph_loss_d1_simplex_mex.cpp``)."""
    Q = np.asarray(Q)
    dtype = _dtype_of(Q)
    num_v = Q.shape[0]
    g = _graph(Eu, Ev, La_d1, num_v, dtype, device)
    res = pfdr_loss_d1_simplex(
        g, _tensor(Q, dtype, device), al=float(al),
        la_f=None if La_f is None else _tensor(
            np.broadcast_to(np.asarray(La_f), (num_v,)), dtype, device),
        p0=None if P0 is None else _tensor(P0, dtype, device),
        opt=PFDROptions(rho=float(PFDR_rho), cond_min=float(PFDR_condMin),
                        dif_rcd=float(PFDR_difRcd),
                        dif_tol=float(PFDR_difTol), it_max=int(PFDR_itMax),
                        verbose=int(verbose)),
        monitor=monitor)
    empty = res.p.new_zeros(0)
    return PFDROutput(res.p, res.it,
                      res.obj[:res.it + 1] if monitor else empty,
                      res.dif[:res.it] if monitor else empty)


# ---------------------------------------------------------------------------
# Boost.Python-compatible entry
# ---------------------------------------------------------------------------

def CP_quadratic_l1(obs, source, target, edge_weight, A, l1_weight=0.0,
                    positivity=0, PFDR_rho=1.0, PFDR_condMin=1e-3,
                    CP_difTol=1e-3, PFDR_difRcd=0.0, PFDR_difTol=1e-4,
                    CP_itMax=10, PFDR_itMax=10_000, verbose=0,
                    inexact="auto", device="cuda"):
    """Analog of the reference Python binding
    (``python/CP_quadratic_l1_py.cpp:368-420``): infers the operator mode
    from the shape of ``A`` — scalar = identity (or scaled diagonal);
    length-N vector = diagonal (squares ``A`` and premultiplies ``obs``);
    (N, V) matrix = dense — and returns ``(Cv, rX)``."""
    obs = np.asarray(obs)
    a = np.asarray(A)
    n = obs.shape[0]
    dtype = _dtype_of(obs, a)
    if a.ndim == 0 or a.size == 1:
        num_v = n
        op = IdentityOp()
        obs_dev = obs
        scale = float(np.ravel(a)[0]) if a.size else 1.0
        if scale != 1.0:
            op = DiagOp(_tensor(np.full(num_v, scale * scale), dtype,
                                device))
            obs_dev = scale * obs
    elif a.ndim == 1:
        if a.shape[0] != n:
            raise ValueError("A should be a scalar, a vector of size N, "
                             "or an N-by-V matrix")
        num_v = n
        op = DiagOp(_tensor(a * a, dtype, device))
        obs_dev = a * obs
    else:
        if a.shape[0] != n:
            raise ValueError("A should be a scalar, a vector of size N, "
                             "or an N-by-V matrix")
        num_v = a.shape[1]
        op = DenseOp(_tensor(a, dtype, device))
        obs_dev = obs
    g = _graph(np.asarray(source), np.asarray(target), edge_weight, num_v,
               dtype, device)
    la_l1 = np.broadcast_to(np.asarray(l1_weight), (num_v,))
    opt = _cp_options(CP_difTol, CP_itMax, PFDR_rho, PFDR_condMin,
                      PFDR_difRcd, PFDR_difTol, PFDR_itMax, verbose,
                      inexact)
    res = cp_quadratic_d1(op, _tensor(obs_dev, dtype, device), g,
                          la_l1=la_l1, positivity=bool(positivity), opt=opt)
    return res.cv, res.rx
