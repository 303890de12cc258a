"""Device-resident cut-pursuit iteration for quadratic + d1 (+l1/bounds)
(counterpart of ``cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_device``).

The host route (:mod:`.cut_pursuit`) brings O(E) arrays to the host every
CP iteration.  Here the whole iteration stays on the tensors' device:

* steepest cut: the certified PDHG relaxation on the full graph with the
  active edges masked to zero weight (a zero-weight edge never constrains
  the cut), warm-started from the previous iteration's cut.  On a stencil
  graph whose kernels take it (``supports_fused``) it is the kernel of
  :mod:`..ops.mincut_fused` (its plain version for CPU tensors); on any
  other container, and any device, the plain loop of
  :mod:`..maxflow.device`, as in the JAX package.  ``duplex=True`` replaces
  the two directional cuts by one two-layer ternary cut
  (``CP_PFDR_graph_quadratic_d1_l1_duplex.cpp:468-549``), a plain loop on
  every container (the JAX package has no kernel for it);
* connected components: the union-find kernel of
  :mod:`..ops.components_fused` on a stencil graph whose kernels take it,
  min-label propagation to its fixpoint (:mod:`..ops.components`)
  otherwise, compacted to first-encounter order
  (the reference's DFS numbering, ``CP_PFDR_graph_quadratic_d1_l1.cpp:
  570-596``);
* contraction: a stable two-key sort of the active edges' component pairs
  and run-length weight sums (``:607-661``), padded with inert zero-weight
  self-loops, plus an ``eps`` self-loop on every live component (the
  reference adds them to isolated components only; an extra eps self-loop
  adds ``eps |x_c - x_c| = 0`` to the objective, so the minimizer is
  unchanged);
* reduced operator and solve: one-hot products up to ``_ONEHOT_MAX``
  components and sorted segment sums beyond (an operator sharded over
  ranks, :mod:`..parallel.cp_dist`, contracts itself by the same rule and
  sums over the ranks), then one whole-solve kernel
  (:func:`.cut_pursuit._kernel_solve`: ``solve_small`` when the problem
  fits its shared memory and has fewer vertices than
  ``SOLVE_FUSED_MIN_RV_CAP`` gives for the operator's kind, ``solve_fused``
  otherwise), or the staged
  PFDR loop for CPU tensors with ``pfdr.fused="auto"``, for
  ``pfdr.fused="off"``, and with ``"auto"`` for ``pfdr.dif_rcd > 0`` or
  ``pfdr.verbose > 0`` (:func:`.cut_pursuit_common.reduced_solve_route`);
* merge and evolution tests: elementwise on the device.

Host reads per iteration: the new-edge count, the certificates, the
component and reduced-edge counts and the evolution.  An uncertified cut
continues from its own iterates on the device for up to
``CONTINUE_FACTOR`` times ``cut_it_max`` more steps; one still uncertified
raises for CUDA tensors and, for CPU tensors, is redone on the host
push-relabel with a warning (the exactness guard of the JAX package); it
is never used silently.  Run sums and segment reductions are
deterministic (no float atomics), so a run's trajectory does not change
between runs.
"""
from __future__ import annotations

import time as _time
import warnings

import numpy as np
import torch

from .. import maxflow
from ..config import CPOptions, Lipsch, numpy_dtype
from ..graph import GraphD1
from ..maxflow.device import _pdhg_min_cut, _pdhg_min_cut_duplex
from ..operators import DenseOp, DiagOp, GramOp, QuadOp, RankShardedOp
from ..ops.components import connected_components_device
from ..ops.components_fused import (compact_labels_device,
                                    device_components_stencil_fused)
from ..ops.mincut_fused import device_cut_stencil_fused
from ..ops.power_iter import dense_operator_norm
from ..stencil import StencilGraphD1
from .cut_pursuit import (CPResult, CPState, _kernel_solve, _objective,
                          _reduce_dense, _reduce_diag, _reduce_gram)
from .cut_pursuit_common import (_ONEHOT_MAX, bucket, machine_eps,
                                 make_reduced_container, reduced_solve_route)
from .pfdr_quadratic import VertexProx, pfdr_quadratic_d1

# an uncertified device cut continues for up to this many times cut_it_max
# more steps before the host redo (CPU tensors) or an error (CUDA tensors)
CONTINUE_FACTOR = 4
_INT_SENTINEL = 2**31 - 1


def stencil_kernels(graph) -> bool:
    """Whether the device cut and components take the stencil kernels
    (``mincut_fused``, ``components_fused``): a :class:`StencilGraphD1`
    they take (``supports_fused``).  Every other graph takes the plain
    loops, on any device."""
    return isinstance(graph, StencilGraphD1) and graph.supports_fused


def _smooth_grad(op: QuadOp, obs, graph: GraphD1, x, active, la_l1,
                 has_l1: bool):
    """Gradient of the smooth part plus the d1 sign terms of the active
    edges and the l1 sign terms (``CP_PFDR_graph_quadratic_d1_l1.cpp:
    339-391``)."""
    dfs = op.grad(x, obs)
    xu, xv = graph.gather_endpoints(x)
    s = torch.sign(xu - xv) * graph.la_d1 * active
    dfs = dfs + graph.edge_to_vertex_sum(s, -s)
    if has_l1:
        dfs = dfs + torch.sign(x) * la_l1
    return dfs


def _direction_costs(op: QuadOp, obs, graph: GraphD1, x, active, la_l1, *,
                     lo: float, hi: float, differentiable: bool,
                     has_l1: bool, positivity: bool):
    """The one or two cut cost vectors (``CP_PFDR_graph_quadratic_d1_l1
    .cpp:339-549``)."""
    dfs = _smooth_grad(op, obs, graph, x, active, la_l1, has_l1)
    if differentiable:
        return dfs, dfs
    zero = x == 0
    inf = float("inf")
    if has_l1:
        c1 = dfs + torch.where(zero, la_l1, 0.0)
        if positivity:
            c2 = torch.where(zero, inf, -dfs)
        else:
            c2 = -dfs + torch.where(zero, la_l1, 0.0)
    else:
        c1 = torch.where(x == hi, inf, dfs) if np.isfinite(hi) else dfs
        c2 = torch.where(x == lo, inf, -dfs) if np.isfinite(lo) else -dfs
    return c1, c2


def _duplex_costs(op: QuadOp, obs, graph: GraphD1, x, active, la_l1, *,
                  has_l1: bool, positivity: bool):
    """Layer costs and inter-layer capacities of the duplex ternary cut
    (``CP_PFDR_graph_quadratic_d1_l1_duplex.cpp:470-511``): the directional
    derivatives ``up``/``do`` (``+-la_l1`` at zeros, ``-inf`` down under
    positivity), ``m = max(0, -up, do)``; returns ``(-do + m, -(up + m),
    m)``."""
    dfs = _smooth_grad(op, obs, graph, x, active, la_l1, has_l1)
    zero = x == 0
    if has_l1:
        up = dfs + torch.where(zero, la_l1, 0.0)
        do = dfs - torch.where(zero, la_l1, 0.0)
    else:
        up = do = dfs
    if positivity:
        do = torch.where(zero, float("-inf"), do)
    m = torch.clamp(torch.maximum(-up, do), min=0.0)
    return -do + m, -(up + m), m


def _device_cut(graph: GraphD1, active, c, tol: float, it_max: int,
                check_every: int, x0=None, z0=None):
    """One steepest cut on the standing graph (active edges weight-masked
    out); returns ``(sep [E] bool, gap, big, x, z)``: the separated edges,
    the duality gap and cost scale (0-d tensors; certified when
    ``gap <= tol * big``) and the relaxed state that warm-starts the next
    iteration's cut (the reference reuses its max-flow graph the same way,
    ``graph.hpp:280``)."""
    if stencil_kernels(graph):
        return device_cut_stencil_fused(graph, active, c, tol, it_max,
                                        check_every, x0, z0)
    w = torch.where(active, 0.0, graph.la_d1)
    fin = torch.isfinite(c)
    big = 1.0 + 2.0 * (w.sum() + torch.where(fin, c.abs(), 0.0).sum())
    c_cl = torch.clamp(torch.where(fin, c, big), -big, big).to(w.dtype)
    side, gap, _, x, z = _pdhg_min_cut(graph, w, c_cl, (tol * big).to(w.dtype),
                                       it_max, check_every, x0, z0)
    su, sv = graph.gather_endpoints(side)
    return (su != sv) & ~active & (graph.la_d1 > 0), gap, big, x, z


def _device_cut_duplex(graph: GraphD1, active, c1, c2, m, tol: float,
                       it_max: int, check_every: int, x0=None, z0=None,
                       zv0=None):
    """One duplex ternary cut on the standing graph (active edges
    weight-masked out, :func:`..maxflow.device._pdhg_min_cut_duplex`);
    returns ``(sep [E] bool, gap, big, x, z, zv)``: the edges separated on
    either layer, the gap and cost scale (0-d tensors) and the relaxed
    state that warm-starts the next iteration's cut."""
    w = torch.where(active, 0.0, graph.la_d1)

    def finsum(a):
        return torch.where(torch.isfinite(a), a.abs(), 0.0).sum()

    big = 1.0 + 2.0 * (2.0 * w.sum() + finsum(c1) + finsum(c2) + m.sum())

    def clip(c):
        return torch.clamp(torch.where(torch.isfinite(c), c, big), -big,
                           big).to(w.dtype)

    side, gap, _, x, z, zv = _pdhg_min_cut_duplex(
        graph, w, clip(c1), clip(c2), m.to(w.dtype), (tol * big).to(w.dtype),
        it_max, check_every, x0, z0, zv0)
    su, sv = graph.gather_endpoints(side)                  # [E, 2]
    sep = (su != sv).any(dim=1) & ~active & (graph.la_d1 > 0)
    return sep, gap, big, x, z, zv


def _device_components(graph: GraphD1, active):
    """Labels of the components of the inactive nonzero-weight edges,
    compacted to first-encounter order: ``(cv int32, num_comp, firsts)``
    with ``num_comp`` a 0-d tensor."""
    if stencil_kernels(graph):
        return device_components_stencil_fused(graph, active)
    mask = ~active & (graph.la_d1 > 0)
    return compact_labels_device(connected_components_device(graph, mask))


def _contract_sort(cv, graph: GraphD1, active):
    """Contraction, phase A: the active nonzero edges' component pairs
    ``(lo, hi)`` sorted stably by ``lo`` then ``hi`` (two stable sorts;
    unselected edges carry a sentinel and sort last), their weights in that
    order, the run-start flags and the run count (a 0-d tensor)."""
    sel = active & (graph.la_d1 > 0)
    cu, cvv = graph.gather_endpoints(cv)
    lo = torch.where(sel, torch.minimum(cu, cvv), _INT_SENTINEL)
    hi = torch.where(sel, torch.maximum(cu, cvv), _INT_SENTINEL)
    order = torch.sort(hi, stable=True).indices
    order = order[torch.sort(lo[order], stable=True).indices]
    lo, hi = lo[order], hi[order]
    w = torch.where(sel, graph.la_d1, 0.0)[order]
    first = torch.ones(1, dtype=torch.bool, device=lo.device)
    flags = (torch.cat([first, (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])])
             & (lo != _INT_SENTINEL))
    return lo, hi, w, flags, flags.sum()


def _contract_pad(lo, hi, w, flags, num_comp: int, eps: float,
                  rv_cap: int, re_cap: int):
    """Contraction, phase B: run-length weight sums padded to ``re_cap``
    edges with zero-weight self-loops spread over the components, then an
    ``eps`` self-loop on every live component (see the module docstring).
    Returns int64 ``reu, rev`` and ``rla`` of ``re_cap + rv_cap`` edges."""
    e = lo.shape[0]
    starts = torch.nonzero(flags).reshape(-1)
    n_runs = starts.numel()
    offsets = torch.cat([starts, starts.new_full((1,), e)])
    wsum = torch.segment_reduce(w, "sum", offsets=offsets)
    iota_e = torch.arange(re_cap, device=lo.device)
    spread = iota_e % rv_cap
    pad = re_cap - n_runs
    reu = torch.cat([lo[starts].to(torch.int64), spread[n_runs:]])
    rev = torch.cat([hi[starts].to(torch.int64), spread[n_runs:]])
    rla = torch.cat([wsum, w.new_zeros(pad)])
    iota = torch.arange(rv_cap, device=lo.device)
    eps_la = torch.where(iota < num_comp, eps, 0.0).to(w.dtype)
    return (torch.cat([reu, iota]), torch.cat([rev, iota]),
            torch.cat([rla, eps_la]))


def _vertex_runs(cv, rv_cap: int):
    """Vertices sorted stably by component label, and the offsets of the
    runs (labels are contiguous first-encounter ints, so run ``i`` is
    component ``i``; empty runs pad to ``rv_cap``)."""
    order = torch.sort(cv, stable=True).indices
    counts = torch.bincount(cv.to(torch.int64), minlength=rv_cap)
    offsets = torch.zeros(rv_cap + 1, dtype=torch.int64, device=cv.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return order, offsets


def _run_sums(values, cv, rv_cap: int):
    """Per-component sums of ``values`` ([V] or [V, N]) as deterministic
    segment reductions over the vertices sorted by component."""
    order, offsets = _vertex_runs(cv, rv_cap)
    return torch.segment_reduce(values[order], "sum", offsets=offsets)


def _reduce_vertex_terms(cv, x, la_l1, firsts, rv_cap: int):
    """Reduced l1 weights (summed per component) and the warm start (one
    representative per component, padded with ``x[0]`` as in the JAX
    package)."""
    r_la_l1 = _run_sums(la_l1, cv, rv_cap)
    reps = torch.zeros(rv_cap, dtype=torch.int64, device=cv.device)
    first_idx = torch.nonzero(firsts).reshape(-1)
    reps[:first_idx.numel()] = first_idx
    return r_la_l1, x[reps]


def _segment_reduce_dense(a, obs, cv, rv_cap: int):
    """Dense reduction beyond the one-hot cap: per-component column sums of
    ``A`` by segment sums over the sorted vertices, O(V N) memory, never
    premultiplied (the [rV, rV] Gram would not fit, and the reference's
    premultiplication rule never picks it at rV >> N)."""
    ra = _run_sums(a.T, cv, rv_cap).T                      # [N, rv_cap]
    cn = torch.sqrt((ra * ra).sum(dim=0))
    cn_safe = torch.where(cn > 0, cn, torch.ones_like(cn))
    c = dense_operator_norm(ra / cn_safe)
    return ra, obs, cn * cn * c


def _segment_reduce_diag(diag, obs, cv, rv_cap: int):
    """Diagonal reduction beyond the one-hot cap, by segment sums."""
    rdiag = _run_sums(diag, cv, rv_cap)
    return rdiag, _run_sums(obs, cv, rv_cap), rdiag


def _device_merge(graph: GraphD1, x, active, eps: float, dif_tol: float):
    """Deactivates active edges whose endpoint components are relatively
    equal (``CP_PFDR_graph_quadratic_d1_l1.cpp:863-886``)."""
    xu, xv = graph.gather_endpoints(x)
    d = (xu - xv).abs()
    amax = torch.maximum(xu.abs(), xv.abs())
    rel = torch.where(amax > eps, d / torch.clamp(amax, min=eps), d / eps)
    return active & ~(rel <= dif_tol)


def _evolution(x, x_prev, eps: float):
    delta = x - x_prev
    num = torch.dot(delta, delta)
    den = torch.dot(x, x)
    return torch.where(den > eps, num / den, num / eps)


def _reduced_problem(op: QuadOp, obs, cv, num_comp: int, rv_cap: int,
                     pfdr_it_prev: int, pre_at_allowed: bool = True,
                     onehot_max: int = _ONEHOT_MAX):
    """Reduced operator, observation and DIAG Lipschitz metric on the
    partition ``cv`` (``CP_PFDR_graph_quadratic_d1_l1.cpp:663-836``):
    ``(r_op, mat, ry, lipsch)``; one-hot products up to ``onehot_max``
    components, segment sums beyond.  A rank-sharded operator contracts
    itself (:meth:`..operators.RankShardedOp.reduced`, the same result on
    every rank); its premultiplication rule counts the global observation
    axis, as the host loop does."""
    if isinstance(op, GramOp) and rv_cap > onehot_max:
        raise ValueError(
            f"premultiplied (A^t A) mode cannot contract to {num_comp} "
            "components (the [rV, rV] reduced Gram does not fit); pass "
            "the dense operator instead")
    if isinstance(op, (DenseOp, RankShardedOp)):
        n_obs = (op.num_obs if isinstance(op, RankShardedOp)
                 else op.a.shape[0])
        pre_at = (pre_at_allowed and rv_cap <= onehot_max
                  and num_comp < (2 * n_obs * pfdr_it_prev)
                  // (n_obs + pfdr_it_prev))
        if isinstance(op, RankShardedOp):
            return op.reduced(obs, cv, rv_cap, pre_at, onehot_max)
        if rv_cap <= onehot_max:
            mat, ry, lipsch = _reduce_dense(op.a, obs, cv, rv_cap, pre_at)
        else:
            mat, ry, lipsch = _segment_reduce_dense(op.a, obs, cv, rv_cap)
        return (GramOp(mat) if pre_at else DenseOp(mat)), mat, ry, lipsch
    if isinstance(op, GramOp):
        mat, ry, lipsch = _reduce_gram(op.gram, obs, cv, rv_cap)
        return GramOp(mat), mat, ry, lipsch
    diag = (op.diag if isinstance(op, DiagOp)
            else torch.ones(cv.shape[0], dtype=obs.dtype, device=obs.device))
    if rv_cap <= onehot_max:
        rdiag, ry, lipsch = _reduce_diag(diag, obs, cv, rv_cap)
    else:
        rdiag, ry, lipsch = _segment_reduce_diag(diag, obs, cv, rv_cap)
    return DiagOp(rdiag), rdiag, ry, lipsch


def contract(graph: GraphD1, active, eps: float):
    """Components and contracted graph of the current active set:
    ``(cv, num_comp, firsts, rgraph)`` with ``rgraph`` a container over
    ``bucket(num_comp)`` vertices on the device
    (:func:`.cut_pursuit_common.make_reduced_container`; three host reads:
    the component and reduced-edge counts, the largest reduced degree)."""
    cv, num_comp_t, firsts = _device_components(graph, active)
    lo_s, hi_s, w_s, flags, re_count = _contract_sort(cv, graph, active)
    num_comp, re_count = (int(v) for v in torch.stack(
        [num_comp_t.to(torch.int64), re_count.to(torch.int64)]).cpu())
    rv_cap = bucket(num_comp)
    reu, rev, rla = _contract_pad(lo_s, hi_s, w_s, flags, num_comp, eps,
                                  rv_cap, bucket(re_count))
    return cv, num_comp, firsts, make_reduced_container(
        reu, rev, rla, rv_cap, rla.dtype, rla.device)


def problem_setup(num_v: int, obs, la_l1, positivity: bool, bounds):
    """``(la_l1_dev, has_l1, lo, hi, differentiable, vprox)`` of a device
    solve: the l1 weights as a [V] tensor (zeros under positivity alone)."""
    lo, hi = (-np.inf, np.inf) if bounds is None else (
        float(bounds[0]), float(bounds[1]))
    has_l1 = la_l1 is not None or positivity
    if la_l1 is not None:
        if isinstance(la_l1, torch.Tensor):
            la_l1 = la_l1.detach().cpu().numpy()
        la_l1_dev = torch.as_tensor(
            np.broadcast_to(np.asarray(la_l1, numpy_dtype(obs.dtype)),
                            (num_v,)).copy(), device=obs.device)
    else:
        la_l1_dev = torch.zeros(num_v, dtype=obs.dtype, device=obs.device)
    differentiable = not has_l1 and not (np.isfinite(lo) or np.isfinite(hi))
    if bounds is not None:
        vprox = VertexProx(kind="bounds", lo=lo, hi=hi)
    elif has_l1:
        vprox = VertexProx(kind="l1", positivity=positivity)
    else:
        vprox = VertexProx()
    return la_l1_dev, has_l1, lo, hi, differentiable, vprox


def scalar_init(op: QuadOp, obs, num_v: int, la_l1_dev, has_l1: bool,
                positivity: bool, bounds, lo: float, hi: float) -> float:
    """Value of the single-component start (the scalar prox solve,
    ``CP_PFDR_graph_quadratic_d1_l1.cpp:66-175``)."""
    ry1, raa1 = (float(v) for v in op.ones_image(num_v, obs))
    if bounds is not None:
        return min(max(ry1 / raa1, lo), hi)
    rl1 = float(la_l1_dev.sum()) if has_l1 else 0.0
    if ry1 > rl1:
        return (ry1 - rl1) / raa1
    if not positivity and ry1 < -rl1:
        return (ry1 + rl1) / raa1
    return 0.0


def _inactive_edges(graph: GraphD1, active):
    """Host COO of the inactive nonzero-weight edges: ``(inact mask, eu,
    ev, la)``."""
    eu, ev, la = graph.host_coo()
    inact = ~active.cpu().numpy() & (la > 0)
    return inact, eu[inact], ev[inact], la[inact]


def _separation(graph: GraphD1, inact, sep_i, device):
    """[E] bool tensor of the inactive edges ``sep_i`` separates."""
    sep = np.zeros(graph.num_edges, bool)
    sep[np.nonzero(inact)[0][sep_i]] = True
    return torch.as_tensor(sep, device=device)


def _host_cut_fallback(graph: GraphD1, active, c1, c2):
    """Host push-relabel cuts for one CP iteration (certificate failure)."""
    inact, ieu, iev, ila = _inactive_edges(graph, active)

    def cut(c):
        side = maxflow.min_cut(graph.num_vertices, ieu, iev, ila,
                               c.cpu().numpy().astype(np.float64))
        return side[ieu] != side[iev]

    sep_i = cut(c1)
    if c2 is not None:
        sep_i = sep_i | cut(c2)
    return _separation(graph, inact, sep_i, active.device)


def _host_duplex_fallback(graph: GraphD1, active, c1, c2, m):
    """Host directed min-cut for one duplex cut (certificate failure): the
    2V-node two-layer construction of :func:`.cut_pursuit._duplex_cut`."""
    inact, ieu, iev, ila = _inactive_edges(graph, active)
    num_v = graph.num_vertices
    c1h, c2h, mh = (a.cpu().numpy().astype(np.float64) for a in (c1, c2, m))
    rng_v = np.arange(num_v, dtype=np.int32)
    eeu = np.concatenate([ieu, ieu + num_v, rng_v])
    eev = np.concatenate([iev, iev + num_v, rng_v + num_v])
    w_uv = np.concatenate([ila, ila, np.zeros(num_v)])
    w_vu = np.concatenate([ila, ila, mh])
    side = maxflow.min_cut_directed(2 * num_v, eeu, eev, w_uv, w_vu,
                                    np.concatenate([c1h, c2h]))
    sep_i = ((side[ieu] != side[iev])
             | (side[ieu + num_v] != side[iev + num_v]))
    return _separation(graph, inact, sep_i, active.device)


def _read_cuts(sep, checks, cut_tol: float):
    """One host read of a round of cuts: ``(new separated edges,
    certified)`` from ``sep`` and the cuts' ``[gap, big, ...]`` pairs."""
    *gaps, n_new = torch.stack(
        [v.to(torch.float64) for v in checks]
        + [sep.sum().to(torch.float64)]).tolist()
    return int(n_new), all(gap <= cut_tol * big
                           for gap, big in zip(gaps[::2], gaps[1::2]))


def cp_quadratic_d1_device(op: QuadOp, obs, graph: GraphD1, *,
                           la_l1=None, positivity: bool = False,
                           bounds=None, duplex: bool = False,
                           opt: CPOptions = CPOptions(),
                           monitor: bool = False,
                           state: CPState | None = None) -> CPResult:
    """Device-resident cut-pursuit solve (same contract as
    :func:`.cut_pursuit.cp_quadratic_d1`); see the module docstring."""
    t0 = _time.monotonic()
    num_v = graph.num_vertices
    device = obs.device
    dtype = numpy_dtype(obs.dtype)
    la_l1_dev, has_l1, lo, hi, differentiable, vprox = problem_setup(
        num_v, obs, la_l1, positivity, bounds)
    eps = machine_eps(dtype, opt.dif_tol)
    dif_tol2 = opt.dif_tol * opt.dif_tol
    # reduced solves: one whole-solve kernel on a CUDA device (its plain
    # version on the CPU with fused="on"), the staged loop otherwise
    kernel_route = reduced_solve_route(opt.pfdr, obs.is_cuda) == "kernel"

    if state is None:
        x1 = scalar_init(op, obs, num_v, la_l1_dev, has_l1, positivity,
                         bounds, lo, hi)
        active = torch.zeros(graph.num_edges, dtype=torch.bool,
                             device=device)
        cv = torch.zeros(num_v, dtype=torch.int32, device=device)
        x_full = torch.full((num_v,), x1, dtype=obs.dtype, device=device)
    else:
        active = torch.as_tensor(np.asarray(state.active, bool),
                                 device=device)
        cv = torch.as_tensor(np.asarray(state.cv, np.int32), device=device)
        x_full = torch.as_tensor(np.asarray(state.rx, dtype)[state.cv],
                                 device=device)

    def mon_objective(x):
        return float(_objective(op, obs, x, graph,
                                la_l1_dev if has_l1 else None))

    times = [0.0]
    objs = [mon_objective(x_full)] if monitor else []
    difs = []
    x_prev = x_full
    pfdr_it_prev = opt.pfdr.it_max
    it = 0
    dif = max(dif_tol2, 1.0)
    num_comp = 1
    # one duplex cut where the problem has two directions and no bounds
    use_duplex = duplex and not differentiable and bounds is None
    # PDHG warm starts: per direction, or the duplex cut's (x, z, zv)
    cut1 = cut2 = (None, None)
    dup = (None, None, None)
    chk = min(250, opt.cut_it_max)
    while it < opt.it_max and dif >= dif_tol2:
        # -- steepest cut(s) (:337-549; duplex :470-545) ---------------------
        if use_duplex:
            d_costs = _duplex_costs(op, obs, graph, x_full, active,
                                    la_l1_dev, has_l1=has_l1,
                                    positivity=positivity)

            def cuts(it_max):
                nonlocal dup
                sep, gap, big, *dup = _device_cut_duplex(
                    graph, active, *d_costs, opt.cut_tol, it_max, chk, *dup)
                return sep, [gap, big]
        else:
            c1, c2 = _direction_costs(op, obs, graph, x_full, active,
                                      la_l1_dev, lo=lo, hi=hi,
                                      differentiable=differentiable,
                                      has_l1=has_l1, positivity=positivity)

            def cuts(it_max):
                nonlocal cut1, cut2
                sep, gap1, big1, *cut1 = _device_cut(
                    graph, active, c1, opt.cut_tol, it_max, chk, *cut1)
                checks = [gap1, big1]
                if not differentiable:
                    sep2, gap2, big2, *cut2 = _device_cut(
                        graph, active, c2, opt.cut_tol, it_max, chk, *cut2)
                    checks += [gap2, big2]
                    sep = sep | sep2
                return sep, checks

        sep, checks = cuts(opt.cut_it_max)
        n_new, certified = _read_cuts(sep, checks, opt.cut_tol)
        if not certified:
            # continue the cuts from their own iterates
            sep, checks = cuts(CONTINUE_FACTOR * opt.cut_it_max)
            n_new, certified = _read_cuts(sep, checks, opt.cut_tol)
        if not certified:
            kind = "duplex cut" if use_duplex else "cut"
            if obs.is_cuda:
                raise RuntimeError(
                    f"steepest {kind} uncertified after "
                    f"{(1 + CONTINUE_FACTOR) * opt.cut_it_max} PDHG steps; "
                    f"raise CPOptions.cut_it_max or cut_tol")
            # exactness guard: redo this iteration's cuts on the host
            warnings.warn(f"falling back to the host min-cut solver for this "
                          f"{kind}", UserWarning, stacklevel=2)
            sep = (_host_duplex_fallback(graph, active, *d_costs)
                   if use_duplex else
                   _host_cut_fallback(graph, active, c1,
                                      None if differentiable else c2))
            n_new = int(sep.sum())
        active = active | sep
        if n_new == 0:  # nothing to recompute (:556-563)
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            if monitor:
                objs.append(objs[-1])
            continue

        # -- contraction (:568-661) -----------------------------------------
        cv, num_comp, firsts, rgraph = contract(graph, active, eps)
        rv_cap = rgraph.num_vertices
        r_la_l1, rx0 = _reduce_vertex_terms(cv, x_full, la_l1_dev, firsts,
                                            rv_cap)
        r_op, mat, ry, lipsch = _reduced_problem(op, obs, cv, num_comp,
                                                 rv_cap, pfdr_it_prev)

        # -- reduced PFDR solve (:842-859) -----------------------------------
        if kernel_route:
            rx, it_d = _kernel_solve(
                r_op, mat, ry, lipsch, rgraph,
                r_la_l1 if has_l1 else None, rx0, num_comp, opt.pfdr.it_max,
                vprox=vprox, rho=float(opt.pfdr.rho),
                dif_tol=float(opt.pfdr.dif_tol))
            pfdr_it_prev = max(int(it_d), 1)
        else:
            res = pfdr_quadratic_d1(
                r_op, ry, rgraph, la_l1=r_la_l1 if has_l1 else None,
                vprox=vprox, lipsch=lipsch, ltype=Lipsch.DIAG, x0=rx0,
                opt=opt.pfdr)
            rx = res.x
            pfdr_it_prev = max(res.it, 1)
        x_full = rx[cv.to(torch.int64)]

        # -- merge + evolution (:863-975) ------------------------------------
        active = _device_merge(graph, x_full, active, eps, opt.dif_tol)
        dif = float(_evolution(x_full, x_prev, eps))
        difs.append(dif)
        x_prev = x_full
        it += 1
        times.append(_time.monotonic() - t0)
        if monitor:
            objs.append(mon_objective(x_full))
        if opt.verbose:
            print(f"CP it {it} (device): {num_comp} components, "
                  f"{int(active.sum())} active edges, dif {dif:.3g}, "
                  f"PFDR it {pfdr_it_prev}")

    cv_host = cv.cpu().numpy().astype(np.int32)
    _, reps = np.unique(cv_host, return_index=True)
    rx_host = x_full.cpu().numpy()[reps].astype(dtype)
    return CPResult(
        cv=cv_host, rx=rx_host, it=it, time=np.asarray(times),
        obj=np.asarray(objs) if monitor else np.zeros(0, dtype),
        dif=np.asarray(difs),
        state=CPState(active=active.cpu().numpy(), cv=cv_host, rx=rx_host))
