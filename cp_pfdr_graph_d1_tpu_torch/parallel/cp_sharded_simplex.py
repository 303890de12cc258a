"""Sharded-graph cut-pursuit for the multi-label family (counterpart of
``cp_pfdr_graph_d1_tpu.parallel.cp_sharded_simplex``).

Multi-label twin of :mod:`.cp_sharded`: cut-pursuit for
``sum_v f_al(p_v; q_v) + sum_e la_d1 ||p_u - p_v||_1`` over per-vertex
simplex distributions on a vertex-sharded stencil graph, the [V, K]
observation and all O(E) state cut into the row blocks of the ranks:

* **K-1 alpha-expansion cuts**: the Kolmogorov-Zabih binary energies (as
  symmetric weights and unary credits, as the host loop
  :func:`..solvers.cut_pursuit_simplex._alpha_expansion_cuts` writes them)
  solved by the certified sharded PDHG min-cut of
  :func:`.cp_sharded._pdhg_cut_sharded`; each expansion cut warm-starts
  from the same label's relaxed state of the previous iteration;
* **components and contraction**: the sharded stages of :mod:`.cp_sharded`;
* **reduced observations**: per-component sums of each rank's rows of the
  observation on its device (float64), summed over the ranks: no [V, K]
  host accumulation per iteration;
* **reduced solve**: the native C++ multi-label PFDR (float64) on the
  replicated reduced problem, or without it the staged loop on a reduced
  problem padded to ``bucket`` sizes (inert uniform rows, zero-weight
  edges), as the single-device host loop does.

Reference stages replaced: ``CP_PFDR_graph_loss_d1_simplex.cpp:522-618``
(expansion cuts), ``:643-731`` (contraction), ``:733-766`` (reduced
observations).
"""
from __future__ import annotations

import time as _time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import native
from ..config import CPOptions
from ..solvers.cut_pursuit_common import (ReducedGraph, bucket, machine_eps,
                                          make_reduced_container, np64,
                                          pad_reduced_graph)
from ..solvers.cut_pursuit_device import _run_sums
from ..solvers.cut_pursuit_simplex import CPSimplexResult, CPSimplexState
from ..solvers.pfdr_simplex import pfdr_loss_d1_simplex
from ..stencil import StencilGraphD1
from .cp_sharded import (_fetch, _gather_triples, _Geom, _halo_graph,
                         _merge_boundary, _pdhg_cut_sharded, _reduce_pairs,
                         _stage_components, _stage_triples)
from .halo import _la_blocks, _row_blocks
from .mesh import Mesh, all_sum


def _sel_label(a, idx):
    """``a[v, idx[v]]``."""
    return torch.gather(a, 1, idx.to(torch.int64)[:, None])[:, 0]


def _expansion_cuts(graph, q_loc, la_loc, active, cv_loc, rp, rdi, warm, *,
                    al: float, k: int, eps: float, opt: CPOptions,
                    first: bool, mesh: Mesh):
    """Merge, loss gradient and the K-1 sharded PDHG expansion cuts on this
    rank's block.  Returns ``(active, n_new, certificates)``; ``warm`` (the
    relaxed states of the K-1 cuts) is updated in place."""
    p_loc = rp[cv_loc]
    if not first:  # merge almost-equal neighbours (:782-804)
        pu, pv = graph.gather_endpoints(p_loc)
        active = active & ~((pu - pv).abs().amax(dim=1) <= eps)
    # loss gradient + active-edge d1 subgradients (:327-377)
    if al == 0.0:
        dfs = -q_loc
    elif al == 1.0:
        dfs = p_loc - q_loc
    else:
        al_k, al_1 = al / k, 1.0 - al
        dfs = -(al_k + al_1 * q_loc) / (al_k / al_1 + p_loc)
    pu, pv = graph.gather_endpoints(p_loc)
    d = pu - pv
    s = torch.where(d > eps, 1.0, torch.where(d < -eps, -1.0, 0.0)).to(
        dfs.dtype)
    s = torch.where(active[:, None], s * la_loc[:, None], 0.0)
    dfs = dfs + graph.edge_to_vertex_sum(s, -s)
    # K-1 expansion cuts (:522-606)
    i_of_v = rdi[cv_loc]
    dfs_i = _sel_label(dfs, i_of_v)
    valid = ~active & (la_loc > 0)
    djv = torch.zeros_like(cv_loc)
    chk = min(250, opt.cut_it_max)
    certs = []
    for n in range(1, k):
        j_of_v = torch.where(n > i_of_v, n, n - 1)
        dfs_j = _sel_label(dfs, j_of_v)
        cur = torch.where(djv > i_of_v, djv, torch.clamp(djv - 1, min=0))
        dfs_cur = _sel_label(dfs, cur)
        theta = torch.where(djv == 0, dfs_j - dfs_i,
                            torch.where(djv == n, 0.0, dfs_j - dfs_cur))
        du, dv = graph.gather_endpoints(djv)
        same = du == dv
        w = torch.where(valid, torch.where(same, 2.0 * la_loc, la_loc), 0.0)
        credit = torch.where(valid & ~same, la_loc, 0.0)
        theta = theta - graph.edge_to_vertex_sum(credit, credit)
        side, gap, big, xn, zn = _pdhg_cut_sharded(
            graph, w, theta, opt.cut_tol, opt.cut_it_max, chk,
            *warm[n - 1], mesh)
        warm[n - 1] = [xn, zn]
        certs.append((float(gap), float(big)))
        djv = torch.where(side, n, djv)
    du, dv = graph.gather_endpoints(djv)
    sep = valid & (du != dv)
    return active | sep, int(all_sum(mesh, sep.sum())), certs


def cp_loss_d1_simplex_sharded(q, graph: StencilGraphD1, mesh: Mesh, *,
                               al: float, opt: CPOptions = CPOptions(),
                               state: Optional[CPSimplexState] = None,
                               axis: str = "dp",
                               device="cuda") -> CPSimplexResult:
    """Sharded-graph cut-pursuit, multi-label family, run in every rank of
    ``mesh`` (each passes the whole problem; the result is the same on
    every rank).

    Args:
      q: [V, K] observations (vertex-major; numpy or tensor).
      graph: the GLOBAL stencil graph (row-sharded here).
      mesh: the ranks; H must divide by their number, block height >= the
        stencil halo.
      al: loss selector: 0 linear, 1 quadratic, in ]0, 1[ smoothed KL.
      opt: outer options; ``opt.dif_tol >= 1`` stops on the number of
        changed maximum-likelihood labels.
      state: optional warm restart (``CPSimplexResult.state``).
    """
    t0 = _time.monotonic()
    h, w = graph.field_shape
    p_n = mesh.size
    g = _Geom(h, w, _row_blocks(h, graph.shifts, p_n), graph.shifts,
              graph.wrap)
    num_v = h * w
    q_np = (q.cpu().numpy() if isinstance(q, torch.Tensor)
            else np.asarray(q))
    k = q_np.shape[1]
    if k < 2:
        raise ValueError("multi-label cut-pursuit needs K >= 2 labels")
    dtype = q_np.dtype
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    label_mode = opt.dif_tol >= 1.0
    tol_scale = opt.dif_tol / num_v if label_mode else opt.dif_tol
    ptol = (opt.pfdr.dif_tol / num_v if opt.pfdr.dif_tol >= 1
            else opt.pfdr.dif_tol)
    eps = machine_eps(dtype, min(tol_scale, ptol))

    r0, r1 = mesh.rank * g.v_loc, (mesh.rank + 1) * g.v_loc
    q_loc = torch.as_tensor(np.ascontiguousarray(q_np[r0:r1]), device=device)
    q64_loc = q_loc.to(torch.float64)
    la_loc = torch.as_tensor(_la_blocks(graph, g.h_loc, p_n)[mesh.rank],
                             dtype=tdtype, device=device)
    hgraph = _halo_graph(g, la_loc, mesh)
    active = torch.zeros(g.e_loc, dtype=torch.bool, device=device)
    warm = [[torch.full((g.v_loc,), 0.5, dtype=tdtype, device=device),
             torch.zeros(g.e_loc, dtype=tdtype, device=device)]
            for _ in range(k - 1)]

    # -- initialization: unisimplicial solution (:66-148) -------------------
    if state is None:
        qsum0 = q_np.sum(axis=0)
        if al == 0.0:
            rp = np.zeros((1, k), dtype)
            rp[0, np.argmax(qsum0)] = 1.0
        else:
            rp = (qsum0 / num_v)[None, :].astype(dtype)
        cv = np.zeros(num_v, np.int32)
        num_comp = 1
    else:
        cv = np.array(state.cv, np.int32)
        rp = np.array(state.rp, dtype)
        num_comp = len(rp)
        act_all = np.asarray(state.active).reshape(p_n, g.e_loc)
        active = torch.as_tensor(act_all[mesh.rank], device=device)

    use_native = native.available()

    def solve_reduced(rq, rla_f, reu, rev, rla, rp0):
        if use_native:
            rp_new, _ = native.pfdr_loss_d1_simplex_host(
                np64(rq), al, reu, rev, np64(rla),
                la_f=np64(rla_f) if rla_f is not None else None,
                rho=opt.pfdr.rho, cond_min=opt.pfdr.cond_min,
                dif_rcd=opt.pfdr.dif_rcd, dif_tol=opt.pfdr.dif_tol,
                it_max=opt.pfdr.it_max, p0=rp0)
            return rp_new.astype(dtype)
        # staged loop on the reduced problem padded to bucket sizes: inert
        # uniform rows on the padding vertices, zero-weight padding edges
        n = len(rp0)
        rv_cap = bucket(n)
        peu, pev, pla = pad_reduced_graph(
            ReducedGraph(n, reu, rev, np.asarray(rla, dtype)), rv_cap,
            bucket(len(reu)))
        rgraph = make_reduced_container(peu, pev, pla, rv_cap, tdtype,
                                        device)

        def pad(a, fill):
            out = np.full((rv_cap,) + a.shape[1:], fill, dtype)
            out[:n] = a
            return torch.as_tensor(out, device=device)

        res = pfdr_loss_d1_simplex(
            rgraph, pad(rq, 1.0 / k), al=al,
            la_f=None if rla_f is None else pad(rla_f, 0.0),
            p0=pad(rp0, 1.0 / k), opt=opt.pfdr)
        return res.p.cpu().numpy()[:n].astype(dtype)

    # -- main loop ----------------------------------------------------------
    times = [0.0]
    difs = []
    prev_labels = np.argmax(rp, axis=1)[cv]
    prev_p_full = rp[cv]
    it = 0
    dif = max(opt.dif_tol, 1.0)
    while it < opt.it_max and dif >= opt.dif_tol:
        rp_pad = np.full((bucket(num_comp), k), 1.0 / k, dtype)
        rp_pad[:num_comp] = rp
        cv_loc = torch.as_tensor(cv[r0:r1].astype(np.int64), device=device)
        active, n_new, certs = _expansion_cuts(
            hgraph, q_loc, la_loc, active, cv_loc,
            torch.as_tensor(rp_pad, device=device),
            torch.as_tensor(np.argmax(rp_pad, axis=1), device=device), warm,
            al=float(al), k=k, eps=eps, opt=opt,
            first=it == 0 and state is None, mesh=mesh)
        bad = [n + 1 for n, (gap, big) in enumerate(certs)
               if gap > opt.cut_tol * big]
        if bad:
            warnings.warn(f"sharded PDHG expansion cut exited uncertified "
                          f"(cuts {bad}); increase cut_it_max", UserWarning,
                          stacklevel=2)
        if n_new == 0:
            difs.append(0.0)
            dif = 0.0
            it += 1
            times.append(_time.monotonic() - t0)
            continue

        # -- components and contraction (the quadratic module's stages) ----
        lab, pairs, valid = _stage_components(la_loc, active, g, mesh)
        num_comp, cv = _merge_boundary(_fetch(mesh, lab),
                                       _fetch(mesh, pairs),
                                       _fetch(mesh, valid), g.v_loc)
        cv_loc = torch.as_tensor(cv[r0:r1].astype(np.int64), device=device)
        tu, tv, tw = _gather_triples(
            mesh, _stage_triples(hgraph, la_loc, active, cv_loc))
        reu, rev, rla = _reduce_pairs(tu, tv, tw, num_comp, eps)

        # -- reduced observations (:733-766) and solve (:773-780) ----------
        qsum = all_sum(mesh, _run_sums(q64_loc, cv_loc, num_comp)
                       ).cpu().numpy()
        sizes = np.bincount(cv, minlength=num_comp).astype(np.float64)
        if al == 0.0:
            rq = qsum
            rp0 = np.zeros((num_comp, k))
            rp0[np.arange(num_comp), np.argmax(qsum, axis=1)] = 1.0
            rla_f = None
        else:
            rq = qsum / np.maximum(sizes, 1)[:, None]
            rp0 = rq.copy()
            rla_f = sizes
        rp = solve_reduced(rq, rla_f, reu, rev, rla, rp0)

        # -- evolution (:806-917) ------------------------------------------
        if label_mode:
            labels = np.argmax(rp, axis=1)[cv]
            dif = float((labels != prev_labels).sum())
            prev_labels = labels
        else:
            p_full = rp[cv]
            dif = float(np.abs(p_full - prev_p_full).sum()) / num_v
            prev_p_full = p_full
        difs.append(dif)
        it += 1
        times.append(_time.monotonic() - t0)
        if opt.verbose and mesh.rank == 0:
            print(f"CP-simplex(sharded) it {it}: {num_comp} components, "
                  f"dif {dif:.3g}")

    active_host = _fetch(mesh, active).reshape(-1)
    return CPSimplexResult(
        cv=cv, rp=rp, it=it, time=np.asarray(times),
        obj=np.zeros(0, dtype), dif=np.asarray(difs),
        state=CPSimplexState(active=active_host, cv=cv, rp=rp))
