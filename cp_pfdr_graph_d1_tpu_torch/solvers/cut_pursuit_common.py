"""Host-side machinery of the cut-pursuit outer solver (counterpart of
``cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_common``; numpy and scipy, as
there).

Connected components and reduced-graph contraction run vectorized on the
host: they are O(E) index manipulation.  Reference structures reproduced:
DFS connected components over inactive edges
(``CP_PFDR_graph_quadratic_d1_l1.cpp:570-596``), reduced connectivity with
parallel-edge merging, self-loops for same-component active edges, and eps
self-loops for isolated components (``:607-661``).  Reduced shapes are
padded to power-of-two capacities as in the JAX package, so that both
packages solve the same padded reduced problems.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse import csgraph

from ..banded_graph import BandedGraphD1
from ..graph import GraphD1


def bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def connected_components(num_vertices: int, eu, ev, inactive_mask):
    """Labels vertices by connectivity over inactive edges.

    Matches the reference's DFS labeling order (components numbered by their
    smallest vertex, ``CP_PFDR_graph_quadratic_d1_l1.cpp:570-596``) because
    scipy also assigns labels in order of first encounter over 0..V-1.

    Returns (num_components, labels[V] int32).
    """
    iu = eu[inactive_mask]
    iv = ev[inactive_mask]
    m = sp.coo_matrix(
        (np.ones(len(iu), np.int8), (iu, iv)),
        shape=(num_vertices, num_vertices))
    n, labels = csgraph.connected_components(m, directed=False)
    return int(n), labels.astype(np.int32)


@dataclasses.dataclass
class ReducedGraph:
    """Contracted graph over components (host arrays)."""
    num_components: int
    eu: np.ndarray        # int32 [rE]
    ev: np.ndarray        # int32 [rE]
    la_d1: np.ndarray     # [rE]


def build_reduced_graph(labels: np.ndarray, num_components: int,
                        eu: np.ndarray, ev: np.ndarray, la_d1: np.ndarray,
                        active_mask: np.ndarray, eps: float) -> ReducedGraph:
    """Contracts active nonzero-weight edges onto components.

    Parallel edges merge with summed weights; active edges internal to one
    component become self-loops; components touched by no nonzero active
    edge get an ``eps`` self-loop so PFDR's preconditioner stays definite
    (``CP_PFDR_graph_quadratic_d1_l1.cpp:607-661``).
    """
    sel = active_mask & (la_d1 > 0)
    ru = labels[eu[sel]]
    rv = labels[ev[sel]]
    w = la_d1[sel]
    lo = np.minimum(ru, rv)
    hi = np.maximum(ru, rv)
    keys = lo.astype(np.int64) * num_components + hi
    uniq, inv = np.unique(keys, return_inverse=True)
    wsum = np.bincount(inv, weights=w, minlength=len(uniq))
    r_eu = (uniq // num_components).astype(np.int32)
    r_ev = (uniq % num_components).astype(np.int32)
    # isolated components: incident to no nonzero active edge
    touched = np.zeros(num_components, bool)
    touched[r_eu] = True
    touched[r_ev] = True
    iso = np.nonzero(~touched)[0].astype(np.int32)
    if len(iso):
        r_eu = np.concatenate([r_eu, iso])
        r_ev = np.concatenate([r_ev, iso])
        wsum = np.concatenate([wsum, np.full(len(iso), eps)])
    return ReducedGraph(num_components, r_eu, r_ev,
                        wsum.astype(la_d1.dtype))


def pad_reduced_graph(rg: ReducedGraph, rv_cap: int, re_cap: int):
    """Pads the reduced edge set to capacity with inert zero-weight
    self-loops — spread across vertices so the incidence table's max degree
    stays flat.  The PFDR solvers treat zero-weight edges as absent."""
    pad = re_cap - len(rg.eu)
    spread = (np.arange(pad, dtype=np.int32) % rv_cap).astype(np.int32)
    eu = np.concatenate([rg.eu, spread])
    ev = np.concatenate([rg.ev, spread])
    la = np.concatenate([rg.la_d1, np.zeros(pad, rg.la_d1.dtype)])
    return eu, ev, la


def make_reduced_container(reu, rev, rla, rv_cap: int, dtype, device):
    """Graph container of a reduced PFDR solve, from numpy arrays or from
    tensors on ``device``.

    :class:`~..graph.GraphD1` builds a ``[rV, max degree]`` incidence
    table, which a contracted graph with a hub component (one component
    adjacent to thousands) makes ``rV**2`` entries.  When that table would
    hold more than a few times the edge count, the degree-agnostic
    :class:`~..banded_graph.BandedGraphD1` takes the graph, as in the JAX
    package."""
    on_device = isinstance(reu, torch.Tensor)
    if on_device:
        deg = torch.bincount(torch.cat([reu, rev]), minlength=rv_cap)
        max_deg = int(deg.max()) if deg.numel() else 1
    else:
        deg = np.bincount(np.concatenate([reu, rev]), minlength=rv_cap)
        max_deg = int(deg.max(initial=1))
    scan = rv_cap * max(max_deg, 1)
    if scan <= max(4 * len(reu), 1 << 16):
        if on_device:
            return GraphD1(reu, rev, rla, rv_cap)
        return GraphD1.create(reu, rev, rla, num_vertices=rv_cap,
                              dtype=dtype, device=device)
    if on_device:
        reu, rev, rla = (a.cpu().numpy() for a in (reu, rev, rla))
    return BandedGraphD1.create(reu, rev, rla, num_vertices=rv_cap,
                                dtype=dtype, device=device)


def reduced_solve_route(pfdr_opt, on_cuda: bool) -> str:
    """Where cut-pursuit solves its reduced problems: ``"kernel"`` (the
    whole-solve kernels ``solve_small`` / ``solve_fused``; their plain
    versions for CPU tensors) or ``"staged"`` (the PFDR loop).

    The JAX package's rule: the kernel route needs ``fused != "off"``,
    ``dif_rcd == 0`` and ``verbose == 0``, and tensors on the accelerator
    or ``fused == "on"``.  With ``fused="auto"``, ``dif_rcd > 0`` or
    ``verbose > 0`` take the staged loop; with ``fused="on"``, which asks
    for the kernels, they raise ``NotImplementedError``.
    """
    if pfdr_opt.fused == "off" or not (on_cuda or pfdr_opt.fused == "on"):
        return "staged"
    for name in ("dif_rcd", "verbose"):
        value = getattr(pfdr_opt, name)
        if value and pfdr_opt.fused == "on":
            raise NotImplementedError(
                f"PFDROptions.{name}={value!r} is not supported by the "
                f"whole-solve kernels that fused='on' asks for; pass "
                f"fused='auto' or 'off' to solve the reduced problems in "
                f"the staged loop")
        if value:
            return "staged"
    return "kernel"


def machine_eps(dtype, dif_tol: float) -> float:
    """Reference epsilon rule (``CP_PFDR_graph_quadratic_d1_l1.cpp:235-252``):
    the machine epsilon, or dif_tol when it is a smaller positive value."""
    m = float(np.finfo(dtype).eps)
    return dif_tol if 0 < dif_tol < m else m


# ---------------------------------------------------------------------------
# host-side reduced pipeline (used below the native-solver crossover)
# ---------------------------------------------------------------------------

def host_operator_norm(gram_apply, dim: int, *, tol: float = 1e-3,
                       it_max: int = 100, nb_init: int = 10) -> float:
    """Numpy counterpart of ``ops.power_iter.operator_norm`` (batched
    restarts, relative convergence test, fixed seed), as the JAX package's
    host route runs it."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, (dim, nb_init))
    b = np.sqrt(np.sum(x * x, axis=0))
    x = gram_apply(x / b)
    b = np.sqrt(np.sum(x * x, axis=0))
    for _ in range(it_max):
        safe_b = np.where(b > 0, b, 1.0)
        x = gram_apply(x / safe_b)
        a = np.sqrt(np.sum(x * x, axis=0))
        done = np.all((a - b) < tol * safe_b)
        b = np.where(b > 0, a, 0.0)
        if done:
            break
    return float(b.max())


def host_reduce_dense(a_t, y_np, cv, num_comp: int, pre_at: bool):
    """Numpy counterpart of ``_reduce_dense``: reduced operator,
    observation and DIAG Lipschitz metric (Jacobi-equilibrated power
    method), unpadded.  ``a_t`` is the CONTIGUOUS [V, N] transpose of the
    design matrix (scipy copies non-contiguous operands on every call)."""
    s = sp.csr_matrix(
        (np.ones(len(cv)), (np.arange(len(cv)), cv)),
        shape=(len(cv), num_comp))
    ra = np.asarray(s.T @ a_t).T  # [N, rV] component column sums
    if pre_at:
        raa = ra.T @ ra
        ry = ra.T @ y_np
        d = np.sqrt(np.diagonal(raa))
        d_safe = np.where(d > 0, d, 1.0)
        eq = raa / (d_safe[:, None] * d_safe[None, :])
        c = host_operator_norm(lambda x: eq @ x, num_comp)
        return -1, raa, ry, np.diagonal(raa) * c
    cn = np.sqrt(np.sum(ra * ra, axis=0))
    cn_safe = np.where(cn > 0, cn, 1.0)
    eq = ra / cn_safe
    # pre-symmetrization cost rule (operator_norm_matrix.cpp:116): iterate
    # the smaller precomputed Gram when it beats the two-sided apply
    from ..ops.power_iter import presymmetrize_wins
    m, n = eq.shape
    if presymmetrize_wins(m, n):
        if m <= n:
            gram = eq @ eq.T
            c = host_operator_norm(lambda x: gram @ x, m)
        else:
            gram = eq.T @ eq
            c = host_operator_norm(lambda x: gram @ x, n)
    else:
        c = host_operator_norm(lambda x: eq.T @ (eq @ x), num_comp)
    return ra.shape[0], ra, y_np, cn * cn * c


def host_reduce_gram(gram_np, y_np, cv, num_comp: int):
    s = sp.csr_matrix(
        (np.ones(len(cv)), (np.arange(len(cv)), cv)),
        shape=(len(cv), num_comp))
    raa = np.asarray(s.T @ (s.T @ gram_np.T).T)
    ry = np.asarray(s.T @ y_np)
    d = np.sqrt(np.maximum(np.diagonal(raa), 0.0))
    d_safe = np.where(d > 0, d, 1.0)
    eq = raa / (d_safe[:, None] * d_safe[None, :])
    c = host_operator_norm(lambda x: eq @ x, num_comp)
    return raa, ry, np.diagonal(raa) * c


def host_reduce_diag(diag_np, y_np, cv, num_comp: int):
    rdiag = np.bincount(cv, weights=diag_np, minlength=num_comp)
    ry = np.bincount(cv, weights=y_np, minlength=num_comp)
    return rdiag, ry, rdiag


def component_representatives(cv: np.ndarray):
    """First-occurrence vertex index of each component label (labels are
    assigned in first-encounter order, so unique() is aligned)."""
    _, first = np.unique(cv, return_index=True)
    return first


def np64(x):
    """Host float64 copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)
