"""Sharded-graph cut-pursuit on a vertex-sharded stencil graph
(counterpart of ``cp_pfdr_graph_d1_tpu.parallel.cp_sharded``).

The same algorithm as the device cut-pursuit, with every O(V) and O(E)
array cut into the row blocks of the ranks of a process group, so the
outer loop handles graphs larger than one card:

* **steepest cuts**: the certified PDHG binary-TV relaxation
  (:mod:`..maxflow.device`) on the rank's row block, its iterate, duals and
  edge state sharded; per step the halo exchange of
  :class:`.halo.HaloStencilGraphD1`, per check the certificate sums over
  the ranks.  Warm-started across cut-pursuit iterations, per direction;
* **connected components**: per-block min-label propagation with pointer
  jumping (:func:`..ops.components.connected_components_device`) on the
  block-internal subgraph, then a host union-find over the boundary-edge
  label pairs; labels compact to the single-device numbering (smallest
  global vertex first);
* **contraction**: each rank compacts its active edges' component pairs,
  the ranks' lists are gathered and merged on the host into the reduced
  graph (the reduced problem is o(V) and replicated);
* **merge**: the deactivation test of nearly equal endpoint values is per
  edge and runs sharded at the start of the next cut.

The host stages run the same arithmetic on the same replicated arrays in
every rank (the sums over ranks are added in rank order), so every rank
takes the same decisions.  The JAX package wraps each stage in a
``shard_map`` (retraced per compaction capacity); here each stage is a
plain function of the rank's tensors, and the compaction has no capacity.
Reference stages replaced: ``CP_PFDR_graph_quadratic_d1_l1.cpp:411-549``
(cuts), ``:570-596`` (components), ``:607-661`` (contraction).
"""
from __future__ import annotations

import time as _time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..config import CPOptions, Lipsch
from ..graph import GraphD1
from ..operators import DenseOp, DiagOp, GramOp
from ..ops.components import connected_components_device
from ..solvers.cut_pursuit import CPResult, CPState
from ..solvers.cut_pursuit_common import (bucket, host_reduce_dense,
                                          host_reduce_diag, machine_eps)
from ..solvers.pfdr_quadratic import VertexProx, pfdr_quadratic_d1
from ..stencil import StencilGraphD1
from .halo import HaloStencilGraphD1, la_blocks, row_blocks
from .mesh import Mesh, RingExchange, all_gather, all_gather_object, all_sum

_THRESHOLDS = 15


class Geom(NamedTuple):
    """Static geometry of one row-block shard."""
    h: int
    w: int
    h_loc: int
    shifts: tuple
    wrap: tuple

    @property
    def v_loc(self):
        return self.h_loc * self.w

    @property
    def e_loc(self):
        return len(self.shifts) * self.h_loc * self.w

    @property
    def halo(self):
        return max((abs(dy) for dy, _ in self.shifts), default=0)


def _crossing_mask(g: Geom) -> np.ndarray:
    """bool [E_loc]: the edge slots whose head lies in a neighbouring row
    block (family-major layout)."""
    m = np.zeros((len(g.shifts), g.h_loc, g.w), bool)
    for k, (dy, _) in enumerate(g.shifts):
        if dy > 0:
            m[k, g.h_loc - dy:, :] = True
        elif dy < 0:
            m[k, :-dy, :] = True
    return m.reshape(-1)


def halo_graph(g: Geom, la_loc, mesh: Mesh):
    return HaloStencilGraphD1(la_loc, (g.h_loc, g.w), g.shifts, g.wrap, mesh)


def fetch(mesh: Mesh, t) -> np.ndarray:
    """Host copy [P, ...] of every rank's ``t`` (the same shape on every
    rank), in rank order."""
    if t.dtype == torch.bool:
        return all_gather(mesh, t.to(torch.uint8)).cpu().numpy().astype(bool)
    return all_gather(mesh, t).cpu().numpy()


# ---------------------------------------------------------------------------
# sharded PDHG min-cut
# ---------------------------------------------------------------------------

def pdhg_cut_sharded(graph, w, c, tol_rel, it_max: int, check_every: int,
                     x0, z0, mesh: Mesh):
    """Sharded twin of ``maxflow.device._pdhg_min_cut``: the same
    iteration, every reduction summed over the ranks, so the duality-gap
    certificate is global and a certified cut is as optimal as the
    single-device one.  ``w`` is the per-edge capacity; returns
    ``(side, gap, big, x, z)`` with ``side`` the thresholded binary side."""
    dtype = graph.la_d1.dtype
    finite = torch.isfinite(c)
    big = 1.0 + 2.0 * (all_sum(mesh, w.sum())
                       + all_sum(mesh, torch.where(finite, c.abs(),
                                                   0.0).sum()))
    c = torch.where(finite, c, big)
    c = torch.minimum(torch.maximum(c, -big), big).to(dtype)
    tol = tol_rel * big

    deg_w = graph.vertex_degree_weighted(w)
    tau = torch.where(deg_w > 0, 1.0 / torch.clamp(deg_w, min=1e-30),
                      1.0 / torch.clamp(c.abs(), min=1e-12))
    sigma = torch.where(w > 0, 0.5 / torch.clamp(w, min=1e-30), 0.0)
    ts = torch.linspace(0.03, 0.97, _THRESHOLDS, dtype=dtype,
                        device=w.device)

    def cut_values(x):
        side = (x[:, None] > ts[None, :]).to(torch.uint8)
        lin = all_sum(mesh, torch.where(side.bool(), c[:, None],
                                        0.0).sum(dim=0))
        su, sv = graph.gather_endpoints(side)
        bnd = all_sum(mesh, torch.where(su != sv, w[:, None],
                                        0.0).sum(dim=0))
        return lin + bnd

    x, xb, z = x0, x0, z0
    it = 0
    gap = torch.tensor(float("inf"), dtype=dtype, device=w.device)
    t_best = ts[0]
    while it < it_max and bool(gap > tol):
        for _ in range(check_every):
            xbu, xbv = graph.gather_endpoints(xb)
            z = torch.clamp(z + sigma * w * (xbu - xbv), -1, 1)
            ktz = graph.edge_to_vertex_sum(w * z, -(w * z))
            x_new = torch.clamp(x - tau * (ktz + c), 0, 1)
            xb = 2 * x_new - x
            x = x_new
        ktz = graph.edge_to_vertex_sum(w * z, -(w * z))
        dual = all_sum(mesh, torch.clamp(c + ktz, max=0).sum())
        vals = cut_values(x)
        best = int(torch.argmin(vals))
        gap = vals[best] - dual
        t_best = ts[best]
        it += check_every
    return x > t_best, gap, big, x, z


# ---------------------------------------------------------------------------
# per-rank stages
# ---------------------------------------------------------------------------

def _merge_active(graph, x, active, dif_tol: float, eps: float):
    """Deactivates the active edges whose endpoint values are relatively
    equal (local per edge)."""
    xu, xv = graph.gather_endpoints(x)
    d = (xu - xv).abs()
    amax = torch.maximum(xu.abs(), xv.abs())
    rel = torch.where(amax > eps, d / torch.clamp(amax, min=eps), d / eps)
    return active & ~(rel <= dif_tol)


def stage_components(la_loc, active, g: Geom, mesh: Mesh):
    """Per-block pointer-jumping components and the boundary label pairs
    ``(labels [V_loc], pairs [B, 2], valid [B])`` (global labels)."""
    crossing = torch.as_tensor(_crossing_mask(g), device=la_loc.device)
    mask = ~active & (la_loc > 0) & ~crossing
    local = StencilGraphD1(la_loc, (g.h_loc, g.w), g.shifts,
                           (False, g.wrap[1]))
    lab = connected_components_device(local, mask)
    glab = (lab.to(torch.int64) + mesh.rank * g.v_loc).reshape(g.h_loc, g.w)
    hd = g.halo
    if hd:
        top, bot = RingExchange(mesh, glab[-hd:], glab[:hd]).wait()
        ext = torch.cat([top, glab, bot])
    pairs, valid = [], []
    act3 = active.reshape(len(g.shifts), g.h_loc, g.w)
    la3 = la_loc.reshape(len(g.shifts), g.h_loc, g.w)
    for k, (dy, dx) in enumerate(g.shifts):
        if dy == 0:
            continue
        rows = range(g.h_loc - dy, g.h_loc) if dy > 0 else range(0, -dy)
        for i in rows:
            v_lab = torch.roll(ext[hd + i + dy], -dx)
            pairs.append(torch.stack([glab[i], v_lab], dim=1))
            valid.append(~act3[k, i] & (la3[k, i] > 0))
    if pairs:
        return lab, torch.cat(pairs), torch.cat(valid)
    dev = la_loc.device
    return (lab, torch.zeros((1, 2), dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.bool, device=dev))


def stage_triples(graph, la_loc, active, cv_loc):
    """The (component u, component v, weight) triples of the rank's active
    edges, compacted, on the host."""
    cu, cv = graph.gather_endpoints(cv_loc)
    idx = torch.nonzero(active & (la_loc > 0)).reshape(-1)
    return (cu[idx].cpu().numpy().astype(np.int32),
            cv[idx].cpu().numpy().astype(np.int32),
            la_loc[idx].cpu().numpy().astype(np.float64))


# ---------------------------------------------------------------------------
# host pieces (replicated)
# ---------------------------------------------------------------------------

def merge_boundary(labs: np.ndarray, pairs: np.ndarray,
                   valid: np.ndarray, v_loc: int):
    """Union-find over the boundary label pairs; returns ``(num_components,
    cv [V] int32)`` with the single-device first-encounter numbering."""
    p_shards = labs.shape[0]
    glab = (labs.astype(np.int64)
            + (np.arange(p_shards)[:, None] * v_loc)).reshape(-1)
    pu = pairs[..., 0].reshape(-1)[valid.reshape(-1)]
    pv = pairs[..., 1].reshape(-1)[valid.reshape(-1)]
    uniq = np.unique(glab)
    comp = np.searchsorted(uniq, glab)
    n = len(uniq)
    if len(pu):
        import scipy.sparse as _sp
        from scipy.sparse.csgraph import connected_components as _cc
        a = np.searchsorted(uniq, pu)
        b = np.searchsorted(uniq, pv)
        adj = _sp.coo_matrix((np.ones(len(a), np.int8), (a, b)),
                             shape=(n, n))
        ncc, cls = _cc(adj, directed=False)
    else:
        ncc, cls = n, np.arange(n)
    # each merged class keeps its smallest global vertex as representative:
    # the single-device numbering by smallest member
    rep = np.full(ncc, np.iinfo(np.int64).max)
    np.minimum.at(rep, cls, uniq)
    root_glab = rep[cls]
    order = np.unique(root_glab)
    compact = np.searchsorted(order, root_glab)
    return len(order), compact[comp].astype(np.int32)


def reduce_pairs(ru, rv, w, num_components: int, eps: float):
    """``build_reduced_graph`` semantics from pre-selected active pairs."""
    lo = np.minimum(ru, rv)
    hi = np.maximum(ru, rv)
    keys = lo.astype(np.int64) * num_components + hi
    uniq, inv = np.unique(keys, return_inverse=True)
    wsum = np.bincount(inv, weights=w, minlength=len(uniq))
    r_eu = (uniq // num_components).astype(np.int32)
    r_ev = (uniq % num_components).astype(np.int32)
    touched = np.zeros(num_components, bool)
    touched[r_eu] = True
    touched[r_ev] = True
    iso = np.nonzero(~touched)[0].astype(np.int32)
    if len(iso):
        r_eu = np.concatenate([r_eu, iso])
        r_ev = np.concatenate([r_ev, iso])
        wsum = np.concatenate([wsum, np.full(len(iso), eps)])
    return r_eu, r_ev, wsum


def gather_triples(mesh: Mesh, triples):
    """Every rank's triples, concatenated in rank order."""
    parts = all_gather_object(mesh, triples)
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))


def _torch_reduced_solve(mode, mat, ry, reu, rev, rla, r_la_l1, vprox,
                         lipsch, rx0, opt: CPOptions, dtype, device):
    """The reduced solve without the native C++: the staged PFDR loop on
    the (small, replicated) reduced problem."""
    t = torch.from_numpy(np.zeros(0, dtype)).dtype
    num = len(rx0)
    gg = GraphD1.create(reu, rev, np.asarray(rla, dtype), num_vertices=num,
                        dtype=t, device=device)

    def tt(a):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    op = {0: DiagOp, -1: GramOp}.get(mode, DenseOp)(tt(mat))
    res = pfdr_quadratic_d1(
        op, tt(ry), gg, la_l1=None if r_la_l1 is None else tt(r_la_l1),
        vprox=vprox, lipsch=tt(lipsch), ltype=Lipsch.DIAG, x0=tt(rx0),
        opt=opt.pfdr)
    return res.x.cpu().numpy(), res.it


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def cp_quadratic_d1_sharded(obs, graph: StencilGraphD1, mesh: Mesh, *,
                            a=None, la_l1=None, positivity: bool = False,
                            bounds=None, opt: CPOptions = CPOptions(),
                            state: Optional[CPState] = None,
                            axis: str = "dp", device="cuda") -> CPResult:
    """Sharded-graph device cut-pursuit on a stencil graph, run in every
    rank of ``mesh`` (each passes the whole problem; the result is the
    same on every rank).

    Args:
      obs: observation: ``y`` [V] for identity/diagonal, [N] for a dense
        ``a`` (numpy or tensor).
      graph: the GLOBAL stencil graph (row-sharded here).
      mesh: the ranks; H must divide by their number, block height >= the
        stencil halo.
      a: None (identity), [V] diagonal, or [N, V] dense design matrix.
      state: optional warm restart (``CPResult.state``).

    Returns a :class:`..solvers.cut_pursuit.CPResult` whose ``cv``/``rx``
    follow the single-device solver's numbering.
    """
    t0 = _time.monotonic()
    h, w = graph.field_shape
    p_n = mesh.size
    g = Geom(h, w, row_blocks(h, graph.shifts, p_n), graph.shifts,
             graph.wrap)
    num_v = h * w
    obs_np = (obs.cpu().numpy() if isinstance(obs, torch.Tensor)
              else np.asarray(obs))
    dtype = obs_np.dtype
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype

    if bounds is not None and (la_l1 is not None or positivity):
        raise ValueError("bounds is exclusive with la_l1/positivity")
    lo, hi = (-np.inf, np.inf) if bounds is None else (
        float(bounds[0]), float(bounds[1]))
    has_l1 = la_l1 is not None
    if has_l1:
        la_l1 = np.broadcast_to(np.asarray(la_l1, dtype), (num_v,)).copy()
    differentiable = (not has_l1 and not positivity
                      and not (np.isfinite(lo) or np.isfinite(hi)))
    if bounds is not None:
        vprox = VertexProx(kind="bounds", lo=lo, hi=hi)
    elif has_l1 or positivity:
        vprox = VertexProx(kind="l1", positivity=positivity)
        if not has_l1:
            la_l1 = np.zeros(num_v, dtype)
    else:
        vprox = VertexProx()
    eps = machine_eps(dtype, opt.dif_tol)
    dif_tol2 = opt.dif_tol * opt.dif_tol

    # -- this rank's blocks --------------------------------------------------
    r0, r1 = mesh.rank * g.v_loc, (mesh.rank + 1) * g.v_loc

    def mine(x):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x)[r0:r1]),
                               dtype=tdtype, device=device)

    la_loc = torch.as_tensor(la_blocks(graph, g.h_loc, p_n)[mesh.rank],
                             dtype=tdtype, device=device)
    op_kind = "identity" if a is None else (
        "diag" if np.ndim(a) == 1 else "dense")
    if op_kind == "dense":
        a_np = (a.cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a)).astype(np.float64)
        a_t_np = np.ascontiguousarray(a_np.T)
        n_obs = a_np.shape[0]
        a_loc = torch.as_tensor(np.ascontiguousarray(a_np[:, r0:r1]),
                                dtype=tdtype, device=device)
        y_loc = torch.as_tensor(obs_np, dtype=tdtype, device=device)
        diag_np = None
    else:
        diag_np = (np.ones(num_v) if op_kind == "identity"
                   else np.asarray(a, np.float64))
        a_loc = None if op_kind == "identity" else mine(a)
        y_loc = mine(obs_np)
    la_l1_loc = mine(la_l1) if (has_l1 or positivity) else None
    y64 = obs_np.astype(np.float64)
    hgraph = halo_graph(g, la_loc, mesh)
    active = torch.zeros(g.e_loc, dtype=torch.bool, device=device)
    x0 = torch.full((g.v_loc,), 0.5, dtype=tdtype, device=device)
    z0 = torch.zeros(g.e_loc, dtype=tdtype, device=device)
    warm = [[x0, z0], [x0, z0]]

    # -- scalar initialization (reference :66-175) --------------------------
    if state is None:
        if op_kind == "dense":
            a1 = a_np.sum(axis=1)
            ry1, raa1 = float(a1 @ y64), float(a1 @ a1)
        else:
            ry1, raa1 = float(y64.sum()), float(diag_np.sum())
        if bounds is not None:
            x1 = min(max(ry1 / raa1, lo), hi)
        else:
            rl1 = float(la_l1.sum()) if has_l1 else 0.0
            if ry1 > rl1:
                x1 = (ry1 - rl1) / raa1
            elif not positivity and ry1 < -rl1:
                x1 = (ry1 + rl1) / raa1
            else:
                x1 = 0.0
        cv = np.zeros(num_v, np.int32)
        rx = np.asarray([x1], dtype)
        num_comp = 1
    else:
        cv = np.array(state.cv, np.int32)
        rx = np.array(state.rx, dtype)
        num_comp = len(rx)
        act_all = np.asarray(state.active).reshape(p_n, g.e_loc)
        active = torch.as_tensor(act_all[mesh.rank], device=device)

    chk = min(250, opt.cut_it_max)

    def cut_stage(cv_loc, rx_t, first):
        """Merge, direction costs and the one or two sharded cuts."""
        nonlocal active
        x = rx_t[cv_loc]
        if not first:
            active = _merge_active(hgraph, x, active, opt.dif_tol, eps)
        if op_kind == "identity":
            dfs = x - y_loc
        elif op_kind == "diag":
            dfs = a_loc * x - y_loc
        else:  # column-sharded: grad = -A_loc^t (y - sum_ranks A_loc x)
            r = y_loc - all_sum(mesh, a_loc @ x)
            dfs = -(a_loc.T @ r)
        xu, xv = hgraph.gather_endpoints(x)
        s = torch.sign(xu - xv) * torch.where(active, la_loc, 0.0)
        dfs = dfs + hgraph.edge_to_vertex_sum(s, -s)
        if la_l1_loc is not None and has_l1:
            dfs = dfs + torch.sign(x) * la_l1_loc
        zero = x == 0
        inf = torch.tensor(float("inf"), dtype=tdtype, device=device)
        if differentiable:
            costs = [dfs]
        elif has_l1 or positivity:
            l1 = la_l1_loc
            c1 = dfs + torch.where(zero, l1, 0.0)
            c2 = (torch.where(zero, inf, -dfs) if positivity
                  else -dfs + torch.where(zero, l1, 0.0))
            costs = [c1, c2]
        else:  # bounds
            c1 = torch.where(x == hi, inf, dfs) if np.isfinite(hi) else dfs
            c2 = (torch.where(x == lo, inf, -dfs) if np.isfinite(lo)
                  else -dfs)
            costs = [c1, c2]
        w_cut = torch.where(active, 0.0, la_loc)
        cuttable = ~active & (la_loc > 0)
        sep = torch.zeros_like(active)
        certs = []
        for k, c in enumerate(costs):
            side, gap, big, xk, zk = pdhg_cut_sharded(
                hgraph, w_cut, c, opt.cut_tol, opt.cut_it_max, chk,
                *warm[k], mesh)
            warm[k] = [xk, zk]
            su, sv = hgraph.gather_endpoints(side.to(torch.uint8))
            sep = sep | ((su != sv) & cuttable)
            certs.append((float(gap), float(big)))
        active = active | sep
        return int(all_sum(mesh, sep.sum())), certs

    # -- main loop ----------------------------------------------------------
    use_native = native.available()
    times = [0.0]
    difs = []
    x_prev = rx[cv]
    it = 0
    dif = max(dif_tol2, 1.0)
    pfdr_it_prev = opt.pfdr.it_max
    while it < opt.it_max and dif >= dif_tol2:
        rx_pad = np.zeros(bucket(num_comp), dtype)
        rx_pad[:num_comp] = rx
        n_new, certs = cut_stage(
            torch.as_tensor(cv[r0:r1].astype(np.int64), device=device),
            torch.as_tensor(rx_pad, device=device),
            first=it == 0 and state is None)
        bad = [k + 1 for k, (gap, big) in enumerate(certs)
               if gap > opt.cut_tol * big]
        if bad:
            warnings.warn(f"sharded PDHG cut {bad} exited uncertified; "
                          f"increase cut_it_max", UserWarning, stacklevel=2)
        if n_new == 0:
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            continue

        # -- components: per-block pointer jumping + host boundary merge ----
        lab, pairs, valid = stage_components(la_loc, active, g, mesh)
        num_comp, cv = merge_boundary(fetch(mesh, lab),
                                      fetch(mesh, pairs),
                                      fetch(mesh, valid), g.v_loc)

        # -- contraction: per-rank compaction + host merge ------------------
        cv_loc = torch.as_tensor(cv[r0:r1].astype(np.int64), device=device)
        tu, tv, tw = gather_triples(
            mesh, stage_triples(hgraph, la_loc, active, cv_loc))
        reu, rev, rla = reduce_pairs(tu, tv, tw, num_comp, eps)

        # -- reduced solve (replicated; the reduced problem is o(V)) --------
        cnt_c = np.bincount(cv, minlength=num_comp)
        rx0 = np.zeros(num_comp, np.float64)
        np.add.at(rx0, cv, x_prev.astype(np.float64))
        rx0 = rx0 / np.maximum(cnt_c, 1)
        if op_kind == "dense":
            pre_at = num_comp < (2 * n_obs * pfdr_it_prev) // (
                n_obs + pfdr_it_prev)
            mode, mat, ry, lipsch = host_reduce_dense(a_t_np, y64, cv,
                                                      num_comp, pre_at)
        else:
            mat, ry, lipsch = host_reduce_diag(diag_np, y64, cv, num_comp)
            mode = 0
        r_la_l1 = None
        if has_l1 or positivity:
            r_la_l1 = np.zeros(num_comp)
            np.add.at(r_la_l1, cv, la_l1.astype(np.float64))
        if use_native:
            rx_new, pfdr_it = native.pfdr_quadratic_d1_host(
                mode, mat, ry, reu, rev, rla,
                la_l1=r_la_l1, positivity=vprox.positivity,
                bounds=(lo, hi) if bounds is not None else None,
                lip_diag=np.asarray(lipsch, np.float64),
                rho=opt.pfdr.rho, cond_min=opt.pfdr.cond_min,
                dif_rcd=opt.pfdr.dif_rcd, dif_tol=opt.pfdr.dif_tol,
                it_max=opt.pfdr.it_max, x0=rx0)
        else:
            rx_new, pfdr_it = _torch_reduced_solve(
                mode, mat, ry, reu, rev, rla, r_la_l1, vprox, lipsch, rx0,
                opt, dtype, device)
        pfdr_it_prev = max(int(pfdr_it), 1)
        rx = np.asarray(rx_new).astype(dtype)

        x_full = rx[cv]
        delta = x_full - x_prev
        den = float(np.dot(x_full, x_full))
        dif = float(np.dot(delta, delta)) / (den if den > eps else eps)
        difs.append(dif)
        x_prev = x_full
        it += 1
        times.append(_time.monotonic() - t0)
        if opt.verbose and mesh.rank == 0:
            print(f"CP(sharded) it {it}: {num_comp} components, "
                  f"dif {dif:.3g}")

    active_host = fetch(mesh, active).reshape(-1)
    return CPResult(cv=cv, rx=rx, it=it, time=np.asarray(times),
                    obj=np.zeros(0, dtype), dif=np.asarray(difs),
                    state=CPState(active=active_host, cv=cv, rx=rx))
