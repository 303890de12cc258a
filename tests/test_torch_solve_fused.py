"""Plain version of the ``solve_fused`` kernel against the JAX package's
``pfdr_quadratic_d1`` on a ``BandedGraphD1`` (on the CPU).

The port's kernel takes flat edge rows in the banded plan's order (sorted by
smaller endpoint, padded with zero-weight copies of the last edge), so the
inputs here are the JAX banded graph's edges and the port's preconditioning
of them.  With ``fused="on"`` the JAX side runs its whole-solve Pallas
kernel in interpret mode in float32: equal iteration counts, iterates at
2e-5 (``tests/test_solve_fused.py``'s tolerance between that kernel and the
staged loop).  With ``fused="off"`` it runs its staged loop in float64:
iterates at 1e-10.  Fields are 12 x 16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
from cp_pfdr_graph_d1_tpu.banded_graph import BandedGraphD1
from cp_pfdr_graph_d1_tpu_torch import (DenseOp, DiagOp, GramOp, GraphD1,
                                        IdentityOp, VertexProx)
from cp_pfdr_graph_d1_tpu_torch.config import Lipsch, PFDROptions
from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused, solve_small
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as tcp
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import \
    initial_precondition

from .conftest import make_grid_graph

torch.set_num_threads(1)

H, W, N = 12, 16, 20
RHO = 1.4


def problem(seed, dtype):
    r = np.random.default_rng(seed)
    v = H * W
    eu, ev, la = make_grid_graph(H, W, seed=seed)
    a = (r.standard_normal((N, v)) / np.sqrt(N)).astype(dtype)
    x_true = np.zeros(v, dtype)
    x_true[r.integers(0, v, 20)] = 1.0
    y = (a @ x_true + 0.01 * r.standard_normal(N)).astype(dtype)
    return eu, ev, la.astype(dtype), a, y


def vprox_of(kind):
    return {"none": VertexProx(), "l1": VertexProx(kind="l1"),
            "l1pos": VertexProx(kind="l1", positivity=True),
            "bounds": VertexProx(kind="bounds", lo=-0.2, hi=0.7)}[kind]


def operators(op_kind, a, y):
    """(JAX operator, port operator, obs) of one operator kind."""
    if op_kind == "dense":
        return J.DenseOp(jnp.asarray(a)), DenseOp(torch.from_numpy(a)), y
    aty = a.T @ y
    if op_kind == "gram":
        g = a.T @ a
        return (J.GramOp(jnp.asarray(g)), GramOp(torch.from_numpy(g)), aty)
    if op_kind == "diag":
        d = (a * a).sum(axis=0)
        return (J.DiagOp(jnp.asarray(d)), DiagOp(torch.from_numpy(d)), aty)
    return J.IdentityOp(), IdentityOp(), aty


def run_pair(op_kind, vkind, dtype, fused, it_max=60, dif_tol=0.0,
             seed=0, resume_at=None):
    eu, ev, la, a, y = problem(seed, dtype)
    v = H * W
    jop, top, obs = operators(op_kind, a, y)
    lip = float(np.linalg.eigvalsh((a.T @ a).astype(np.float64))[-1])
    vp = vprox_of(vkind)
    la_l1 = (np.full(v, 0.05, dtype) if vkind.startswith("l1") else None)
    bg = BandedGraphD1.create(eu, ev, la, num_vertices=v,
                              dtype=jnp.dtype(dtype))
    jvp = J.VertexProx(kind=vp.kind, positivity=vp.positivity, lo=vp.lo,
                       hi=vp.hi)

    def jopt(m):
        return J.PFDROptions(rho=RHO, dif_tol=dif_tol, it_max=m, fused=fused)

    jl1 = None if la_l1 is None else jnp.asarray(la_l1)
    kw = dict(la_l1=jl1, vprox=jvp, lipsch=lip)
    if resume_at is None:
        res_j = J.pfdr_quadratic_d1(jop, jnp.asarray(obs), bg, opt=jopt(it_max),
                                    **kw)
    else:
        _, st = J.pfdr_quadratic_d1(jop, jnp.asarray(obs), bg,
                                    opt=jopt(resume_at), return_state=True,
                                    **kw)
        res_j = J.pfdr_quadratic_d1(jop, jnp.asarray(obs), bg,
                                    opt=jopt(it_max), state0=st, **kw)

    # the port: preconditioning on the banded graph's edge order, then the
    # kernel's plain version with the same edge rows
    t = torch.from_numpy
    g = GraphD1.create(np.asarray(bg.eu), np.asarray(bg.ev),
                       np.asarray(bg.la_d1), num_vertices=v,
                       dtype=t(a).dtype, device="cpu")
    tl1 = None if la_l1 is None else t(la_l1)
    pre = initial_precondition(top, t(obs), g, tl1, RHO, lip, Lipsch.SCAL)
    if op_kind == "dense":
        kind, mat, aty = "dense", top.a, top.apply_t(t(obs))
    elif op_kind == "gram":
        kind, mat, aty = "gram", top.gram, t(obs)
    else:
        kind, aty = "diag", t(obs)
        mat = (top.diag if op_kind == "diag"
               else torch.ones(v, dtype=aty.dtype))
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    eps_mach = float(np.finfo(dtype).eps)
    args = (kind, mat, aty, pre.ga, pre.th_l1)
    skw = dict(rv=v, rho=RHO, vkind=vp.kind, positivity=vp.positivity,
               lo=float(vp.lo), hi=float(vp.hi), dif_tol2=dif_tol ** 2,
               eps=dif_tol if 0 < dif_tol < eps_mach else eps_mach)
    x0 = torch.zeros(v, dtype=aty.dtype)
    z0 = torch.stack([x0[g.eu], x0[g.ev]])
    if resume_at is None:
        out = solve_fused.fused_pfdr_solve(*args, x0, z0, ec, g.eu, g.ev,
                                           it_max=it_max, **skw)
    else:
        x1, z1, it1, _ = solve_fused.fused_pfdr_solve(
            *args, x0, z0, ec, g.eu, g.ev, it_max=resume_at, **skw)
        out = solve_fused.fused_pfdr_solve(*args, x1, z1, ec, g.eu, g.ev,
                                           it_max=it_max, it0=int(it1),
                                           **skw)
        straight = solve_fused.fused_pfdr_solve(*args, x0, z0, ec, g.eu,
                                                g.ev, it_max=it_max, **skw)
        # resuming continues the uninterrupted trajectory bit for bit
        assert int(out[2]) == int(straight[2])
        np.testing.assert_array_equal(out[0].numpy(), straight[0].numpy())
        np.testing.assert_array_equal(out[1].numpy(), straight[1].numpy())
    return res_j, out


@pytest.mark.parametrize("op_kind,vkind", [
    ("dense", "l1"), ("dense", "l1pos"), ("gram", "bounds"),
    ("identity", "none")])
def test_plain_matches_whole_solve_kernel_f32(op_kind, vkind):
    res_j, (x, _, it, _) = run_pair(op_kind, vkind, np.float32, "on")
    assert int(it) == int(res_j.it) == 60
    np.testing.assert_allclose(x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("op_kind,vkind", [
    ("dense", "none"), ("diag", "l1pos"), ("gram", "l1")])
def test_plain_matches_staged_f64(op_kind, vkind):
    res_j, (x, _, it, _) = run_pair(op_kind, vkind, np.float64, "off",
                                    it_max=3000, dif_tol=1e-6)
    assert int(it) == int(res_j.it) < 3000
    np.testing.assert_allclose(x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=1e-10)


def test_early_stop_matches_kernel():
    res_j, (x, _, it, _) = run_pair("dense", "bounds", np.float32, "on",
                                    it_max=400, dif_tol=1e-3, seed=3)
    assert int(it) == int(res_j.it) < 400
    np.testing.assert_allclose(x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=2e-5)


def test_resume_continues_trajectory():
    """Resume from ``(x, z, it0)`` against the JAX kernel's resume from
    its ``PFDRSolveState``."""
    res_j, (x, _, it, _) = run_pair("diag", "bounds", np.float32, "on",
                                    it_max=70, resume_at=25, seed=2)
    assert int(it) == int(res_j.it) == 70
    np.testing.assert_allclose(x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=2e-5)


def test_kernel_route_beyond_solve_small(monkeypatch):
    """A reduced problem that ``solve_small`` does not take goes to
    ``solve_fused`` with its edges sorted by smaller endpoint, and solves
    the same problem."""
    eu, ev, la, a, y = problem(5, np.float64)
    v = H * W
    g = GraphD1.create(eu[::-1].copy(), ev[::-1].copy(), la[::-1].copy(),
                       num_vertices=v, dtype=torch.float64, device="cpu")
    r_op = DenseOp(torch.from_numpy(a))
    lipsch = torch.full((v,), float(np.linalg.norm(a, 2) ** 2),
                        dtype=torch.float64)
    args = (r_op, r_op.a, torch.from_numpy(y), lipsch, g,
            torch.full((v,), 0.02, dtype=torch.float64),
            torch.zeros(v, dtype=torch.float64), v)
    kw = dict(route="kernel", it_max=2000,
              vprox=VertexProx(kind="l1", positivity=True),
              pfdr=PFDROptions(rho=1.5, dif_tol=1e-6))
    x_s, it_s = tcp.reduced_solve(*args, **kw)
    calls = []
    monkeypatch.setattr(tcp, "fits", lambda *a: False)
    monkeypatch.setattr(tcp, "fused_pfdr_solve",
                        lambda *a, **k: calls.append(a[8:10]) or
                        solve_fused.fused_pfdr_solve(*a, **k))
    x_f, it_f = tcp.reduced_solve(*args, **kw)
    assert len(calls) == 1
    key = torch.minimum(*calls[0])
    assert bool((key[1:] >= key[:-1]).all())
    assert int(it_s) == int(it_f) < 2000
    np.testing.assert_allclose(x_f.numpy(), x_s.numpy(), rtol=0, atol=1e-12)
    assert solve_small.fits(4096, 91, torch.float32)
    assert not solve_small.fits(32768, 91, torch.float32)


# -- the kernel's launch plan: partition, edge owners, hub rows, layout ----

def graph_case(name):
    """``(eu, ev, rv, rv_cap)`` of an edge list sorted stably by smaller
    endpoint, as the callers pass it: "mesh", a 12 x 16 grid with 40
    padding copies of its last edge (two hub rows, as a banded
    container's padding makes); "star", a hub joined to 299 leaves that
    form a chain; "padded", a grid on the first 150 of 256 vertices."""
    if name == "mesh":
        eu, ev, _ = make_grid_graph(H, W)
        eu, ev = np.append(eu, [eu[-1]] * 40), np.append(ev, [ev[-1]] * 40)
        rv = rv_cap = H * W
    elif name == "star":
        leaves = np.arange(1, 300)
        eu = np.concatenate([np.zeros(299, np.int64), leaves[:-1]])
        ev = np.concatenate([leaves, leaves[1:]])
        rv = rv_cap = 300
    else:
        eu, ev, _ = make_grid_graph(10, 15)
        rv, rv_cap = 150, 256
    eu, ev = np.asarray(eu, np.int64), np.asarray(ev, np.int64)
    order = np.argsort(np.minimum(eu, ev), kind="stable")
    return eu[order], ev[order], rv, rv_cap


@pytest.mark.parametrize("name", ["mesh", "star", "padded"])
def test_partition_covers_vertices_and_edges_once(name):
    """Each vertex lies in one block, each edge has one writer slot (at its
    smaller endpoint, so the owners' edges are contiguous in the sorted
    order), every slot knows its own and its other endpoint, and the rows
    of more than HUB_ROW slots (and only those) are the hub rows of their
    block."""
    eu, ev, _, rv_cap = graph_case(name)
    ne = eu.size
    grid = solve_fused.grid_size(rv_cap, 8)
    assert grid == min(8, rv_cap // solve_fused.MIN_BLOCK_VERTICES)
    idx, nb_max, slots = solve_fused.build_index(eu, ev, rv_cap, grid,
                                                 n_rows=N)
    idx = {k: v.numpy() for k, v in idx.items()}
    vstart, off = idx["vstart"], idx["inc_off"]
    assert vstart[0] == 0 and vstart[-1] == rv_cap
    assert np.all(np.diff(vstart) >= 0) and len(vstart) == grid + 1
    block_of = np.searchsorted(vstart, np.arange(rv_cap), side="right") - 1
    code = idx["inc_slot"].view(np.uint32).astype(np.int64)
    slot, writer = code & 0x7FFFFFFF, code >> 31
    assert sorted(slot.tolist()) == list(range(2 * ne))
    vert = np.concatenate([eu, ev])
    me = np.repeat(np.arange(rv_cap), np.diff(off))
    np.testing.assert_array_equal(vert[slot], me)
    np.testing.assert_array_equal(idx["inc_self"], me - vstart[block_of[me]])
    np.testing.assert_array_equal(idx["inc_other"],
                                  np.concatenate([ev, eu])[slot])
    e = slot % ne
    assert np.bincount(e[writer == 1], minlength=ne).tolist() == [1] * ne
    np.testing.assert_array_equal(me[writer == 1],
                                  np.minimum(eu, ev)[e[writer == 1]])
    owner = np.empty(ne, np.int64)
    owner[e[writer == 1]] = block_of[me[writer == 1]]
    assert np.all(np.diff(owner) >= 0)  # each block's edges contiguous
    deg = np.diff(off)
    hubs = idx["hubs"]
    np.testing.assert_array_equal(hubs, np.flatnonzero(
        deg > solve_fused.HUB_ROW))
    for b in range(grid):
        mine = hubs[idx["hub_off"][b]:idx["hub_off"][b + 1]]
        assert np.all(block_of[mine] == b)
    assert len(hubs) == (2 if name == "mesh" else int(name == "star"))
    assert nb_max == np.diff(vstart).max()
    assert slots == np.diff(off[vstart]).max()
    assert solve_fused.layout("dense", N, 4, nb_max, slots) == (
        True, True, slots)


def warp_sum(vals):
    """A warp's sum as the kernel takes it: lane l adds the values l, l +
    32, ... in order, then a ``__shfl_down_sync`` tree (16, 8, 4, 2, 1)
    leaves the total in lane 0."""
    lanes = np.zeros(32)
    for k, v in enumerate(vals):
        lanes[k % 32] += v
    for off in (16, 8, 4, 2, 1):
        lanes[:off] = lanes[:off] + lanes[off:2 * off]
    return lanes[0]


def kernel_schedule(op_kind, op, aty, ga, th_l1, x0, z0, ec, eu, ev, *, rv,
                    it_max, rho, vkind, positivity, lo, hi, dif_tol2, eps,
                    sms=8):
    """A numpy copy (float64) of the kernel's schedule, written from
    ``csrc/solve_fused.cu``: blocks of ``build_index``, the slot terms from
    the old z, x and p with only the writer slot storing its edge's pair,
    the vertex sums in CSR order (a warp's lanes and shuffle tree on the
    rows of more than ``HUB_ROW`` slots), the vertices >= rv held at zero,
    r from the blocks' partials (a warp per row over the block's columns,
    then a warp per row over the blocks), the stop test on the partials'
    evolution sums.  It checks the plan and the schedule's arithmetic, not
    the CUDA code, which ``chip_smoke.py`` holds against the plain version
    on the card."""
    from cp_pfdr_graph_d1_tpu_torch.ops.prox import vertex_prox_plain
    op, aty, ga, th_l1, x, z, ec = (np.asarray(a, np.float64) for a in (
        op, aty, ga, th_l1, x0, z0, ec))
    rv_cap, ne = x.size, eu.shape[0]
    n_rows = op.shape[0] if op_kind == "dense" else 0
    grid = solve_fused.grid_size(rv_cap, sms)
    idx = {k: v.numpy() for k, v in solve_fused.build_index(
        eu, ev, rv_cap, grid, n_rows)[0].items()}
    vstart, off = idx["vstart"], idx["inc_off"]
    code = idx["inc_slot"].view(np.uint32).astype(np.int64)
    slot, writer = code & 0x7FFFFFFF, code >> 31 == 1
    e, at_v = slot % ne, slot >= ne
    me = np.repeat(np.arange(rv_cap), np.diff(off))
    w = idx["inc_other"]
    wu, wv, wdu, wdv, thd = ec

    def partials(x):
        cols = [slice(vstart[b], vstart[b + 1]) for b in range(grid)]
        return np.array([[warp_sum(op[n, c] * x[c]) for c in cols]
                         for n in range(n_rows)]).reshape(n_rows, grid)

    def row_sum(v):
        terms = buf[off[v]:off[v + 1]]
        if terms.size > solve_fused.HUB_ROW:
            return warp_sum(terms)
        return sum(terms, 0.0)

    r_parts, it, dif = partials(x), 0, max(dif_tol2, 1.0)
    while True:
        if it > 0:
            dif = num / den if den > eps else num / eps
        if not (it < it_max and dif >= dif_tol2):
            break
        if op_kind == "dense":
            g = op.T @ np.array([warp_sum(q) for q in r_parts])
        else:
            g = x @ op if op_kind == "gram" else op * x
        p = 2.0 * x - ga * (g - aty)
        pu = np.where(at_v, p[w], p[me])
        pv = np.where(at_v, p[me], p[w])
        xu = np.where(at_v, x[w], x[me])
        xv = np.where(at_v, x[me], x[w])
        au, av = pu - z[0, e], pv - z[1, e]
        avg = wdu[e] * au + wdv[e] * av
        diff = au - av
        shr = np.sign(diff) * np.maximum(np.abs(diff) - thd[e], 0.0)
        zun = z[0, e] + rho * ((avg + wdv[e] * shr) - xu)
        zvn = z[1, e] + rho * ((avg - wdu[e] * shr) - xv)
        zn = np.full_like(z, np.nan)
        zn[0, e[writer]], zn[1, e[writer]] = zun[writer], zvn[writer]
        buf = np.where(at_v, wv[e] * zvn, wu[e] * zun)
        acc = np.array([row_sum(v) for v in range(rv_cap)])
        xn = vertex_prox_plain(torch.from_numpy(acc), torch.from_numpy(th_l1),
                               vkind, positivity, lo, hi).numpy()
        xn[rv:] = 0.0
        num, den = ((xn - x) ** 2).sum(), (xn * xn).sum()
        x, z, it = xn, zn, it + 1
        r_parts = partials(x)
    assert not np.isnan(z).any()  # every edge written by its owner
    return x, z, it


@pytest.mark.parametrize("op_kind,name", [
    ("dense", "mesh"), ("dense", "padded"), ("gram", "star"),
    ("diag", "mesh"), ("dense", "star")])
def test_kernel_schedule_matches_plain(op_kind, name):
    """The kernel's schedule over its launch plan (edge owners, hub rows,
    split r) against the plain version: the same iterates and the same
    stop on the evolution test (float64, at most 200 iterations)."""
    eu, ev, rv, rv_cap = graph_case(name)
    r = np.random.default_rng(7)
    ne = eu.size
    la = np.where(np.arange(ne) < ne - 40 if name == "mesh" else True,
                  r.uniform(0.05, 0.3, ne), 0.0)
    a = r.standard_normal((N, rv_cap)) / np.sqrt(N)
    y = r.standard_normal(N)
    jop, top, obs = operators(op_kind, a, y)
    t = torch.from_numpy
    g = GraphD1.create(eu, ev, la, num_vertices=rv_cap, dtype=torch.float64,
                       device="cpu")
    lip = float(np.linalg.eigvalsh(a.T @ a)[-1])
    pre = initial_precondition(top, t(obs), g, None, 1.4, lip, Lipsch.SCAL)
    op = {"dense": a, "gram": a.T @ a, "diag": (a * a).sum(axis=0)}[op_kind]
    aty = a.T @ y if op_kind == "dense" else obs
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    x0 = r.normal(size=rv_cap) * (np.arange(rv_cap) < rv)
    z0 = r.normal(size=(2, ne))
    ga, th_l1 = pre.ga.numpy(), r.uniform(0.0, 0.05, rv_cap)
    kw = dict(rv=rv, it_max=200, rho=1.4, vkind="l1", positivity=False,
              lo=-np.inf, hi=np.inf, dif_tol2=1e-10, eps=1e-16)
    t = torch.from_numpy
    args = (op_kind, t(op), t(aty), t(ga), t(th_l1), t(x0), t(z0), ec,
            t(eu), t(ev))
    xp, zp, itp, _ = solve_fused.solve_fused_plain(*args, **kw)
    xk, zk, itk = kernel_schedule(*args, **kw)
    assert itk == int(itp)
    np.testing.assert_allclose(xk, xp.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(zk, zp.numpy(), rtol=0, atol=1e-12)


def test_make_plan_sizes_the_launch():
    """``make_plan`` builds the launch's plan on every call: the packed
    index arrays in the kernel's order, the grid, the layout and one
    scratch of the second x and z buffers, p, the partials and the slot
    contributions."""
    eu, ev, _, rv_cap = graph_case("mesh")
    teu, tev = torch.from_numpy(eu), torch.from_numpy(ev)
    plan = solve_fused.make_plan("dense", teu, tev, rv_cap, N,
                                 torch.float64, sms=8)
    assert plan.grid == 6 and plan.xs_in_smem and plan.op_in_smem
    assert plan.slot_cap > 0
    assert plan.packed.dtype == torch.int32
    np.testing.assert_array_equal(plan.packed.numpy(), np.concatenate(
        [plan.index[k].numpy() for k in solve_fused._INDEX_ORDER]))
    assert plan.scratch.numel() == 2 * rv_cap + 4 * eu.size + (N + 2) * 6
    again = solve_fused.make_plan("dense", teu, tev, rv_cap, N,
                                  torch.float64, sms=8)
    assert again is not plan and again.scratch is not plan.scratch


def chain_nb_max(rv_cap, grid):
    """The most vertices a block owns when ``partition`` splits a chain of
    ``rv_cap`` vertices over ``grid`` blocks."""
    deg = torch.full((rv_cap,), 2)
    deg[[0, -1]] = 1
    off = torch.cat([torch.zeros(1, dtype=torch.int64), deg.cumsum(0)])
    return int(torch.diff(solve_fused.partition(off, grid, 0)).max())


@pytest.mark.parametrize("itemsize,rv_cap,xs_in", [
    (8, 1 << 21, False), (4, 1 << 21, True), (4, 1 << 22, False),
    (8, 1 << 20, True)])
def test_layout_beyond_shared_memory(itemsize, rv_cap, xs_in):
    """On 132 blocks the iterate and forward values leave shared memory
    beyond about 1.9 M vertices in float64 (3.8 M in float32); the
    launch's shared memory then stays within a block's limit, so any size
    launches."""
    nb_max = chain_nb_max(rv_cap, 132)
    slots = 2 * nb_max
    got_xs, op_in, slot_cap = solve_fused.layout("diag", 0, itemsize, nb_max,
                                                 slots)
    assert got_xs == xs_in and not op_in
    assert (2 * nb_max * itemsize + 66 * itemsize
            > solve_fused.MAX_SMEM_BYTES) != xs_in
    assert solve_fused.smem_bytes(itemsize, 0, nb_max, got_xs, op_in,
                                  slot_cap) <= solve_fused.MAX_SMEM_BYTES


def test_layout_dense_operator_slice():
    """A dense operator's slice joins the iterate in shared memory when
    both fit, else it is streamed; row sums that cannot fit raise."""
    nb = chain_nb_max(4096, 132)
    assert solve_fused.layout("dense", 91, 8, nb, 2 * nb)[:2] == (True, True)
    nb = chain_nb_max(131072, 132)
    assert solve_fused.layout("dense", 91, 8, nb, 2 * nb)[:2] == (True,
                                                                   False)
    with pytest.raises(ValueError, match="row sums"):
        solve_fused.layout("dense", 40_000, 8, nb, 2 * nb)
