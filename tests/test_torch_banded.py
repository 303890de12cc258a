"""Port's banded container and its kernel modules (``ops/banded``,
``ops/banded_fused``, the banded whole solve and the reduced-container
rule) against the JAX package, on the CPU in float64.

The port's wrappers run their kernels' plain versions here (the tensors lie
on the CPU).  The JAX side takes its plain route: ``BandedGraphD1(mode=
"jnp")``, ``GraphD1`` and ``fused="off"``; ``tests/test_banded.py`` holds
the JAX kernels against that route.  Tolerances are those of
``tests/test_banded.py``: transfers at 1e-12, solves with equal iteration
counts and ``x`` within 1e-10.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.ops import banded as jbanded
from cp_pfdr_graph_d1_tpu.ops.prox import d1_pair_prox as j_pair_prox
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import \
    cp_quadratic_d1 as jax_cp
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_common import \
    make_reduced_container as j_reduced
from cp_pfdr_graph_d1_tpu.solvers.pfdr_quadratic import \
    _vertex_prox as j_vertex_prox
from cp_pfdr_graph_d1_tpu_torch import convert
from cp_pfdr_graph_d1_tpu_torch.ops import banded, banded_fused, solve_fused
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
    cp_quadratic_d1 as torch_cp
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import \
    make_reduced_container as t_reduced
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import Precond

from ._torch_cuda_source import (assert_struct_mirrors, cuda_constant,
                                 cuda_source)
from .conftest import make_grid_graph

torch.set_num_threads(1)

V = 500


def irregular_graph(v=V, seed=0):
    """Grid plus random chords, as ``tests/test_banded.py``."""
    r = np.random.default_rng(seed)
    eu, ev, la = make_grid_graph(25, v // 25, seed=seed)
    extra = 60
    ceu = r.integers(0, v, extra).astype(np.int32)
    cev = ((ceu + r.integers(1, 40, extra)) % v).astype(np.int32)
    return (np.concatenate([eu, ceu]), np.concatenate([ev, cev]),
            np.concatenate([la, 0.5 + r.random(extra)]))


def star_graph(v=V, seed=0):
    """Vertex 0 joined to every other vertex, plus a ring of the leaves: a
    hub of degree 2 (v - 1) in the incidence list."""
    r = np.random.default_rng(seed)
    leaves = np.arange(1, v, dtype=np.int32)
    eu = np.concatenate([np.zeros(v - 1, np.int32), leaves])
    ev = np.concatenate([leaves, np.roll(leaves, -1)])
    return eu, ev, 0.2 + r.random(eu.shape[0])


GRAPHS = {"mesh": irregular_graph, "star": star_graph}


def pair(name, seed=0, tile=1024):
    eu, ev, la = GRAPHS[name](seed=seed)
    jg = J.BandedGraphD1.create(eu, ev, la, num_vertices=V,
                                dtype=jnp.float64, tile=tile, mode="jnp")
    tg = T.BandedGraphD1.create(eu, ev, la, num_vertices=V,
                                dtype=torch.float64, tile=tile, device="cpu")
    return jg, tg


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("round_wd8", [False, True])
def test_plan_and_container_match_jax(name, round_wd8):
    eu, ev, la = GRAPHS[name]()
    jplan, jperm, jepad = jbanded.build_banded_plan(eu, ev, V, 1024,
                                                    round_wd8=round_wd8)
    tplan, tperm, tepad = banded.build_banded_plan(eu, ev, V, 1024,
                                                   round_wd8=round_wd8)
    np.testing.assert_array_equal(tperm, jperm)
    assert tepad == jepad
    np.testing.assert_array_equal(tplan.starts8, jplan.starts8)
    assert (tplan.num_tiles, tplan.wd8, tplan.v8) == (
        jplan.num_tiles, jplan.wd8, jplan.v8)
    np.testing.assert_array_equal(banded.rcm_order(eu, ev, V),
                                  jbanded.rcm_order(eu, ev, V))
    jg, tg = pair(name)
    assert tg.num_edges == jg.num_edges
    np.testing.assert_array_equal(tg.eu.numpy(), np.asarray(jg.eu))
    np.testing.assert_array_equal(tg.ev.numpy(), np.asarray(jg.ev))
    np.testing.assert_array_equal(tg.la_d1.numpy(), np.asarray(jg.la_d1))
    # the port's container rebuilt from the JAX container's own arrays
    tc = convert.banded_graph(np.asarray(jg.eu), np.asarray(jg.ev),
                              np.asarray(jg.la_d1), V, device="cpu")
    np.testing.assert_array_equal(tc.eu.numpy(), tg.eu.numpy())


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("k", [None, 3])
def test_transfers_match_jax(name, k):
    jg, tg = pair(name, seed=1)
    r = np.random.default_rng(2)
    shape = (V,) if k is None else (V, k)
    x = r.normal(size=shape)
    ju, jv = jg.gather_endpoints(jnp.asarray(x))
    tu, tv = tg.gather_endpoints(torch.from_numpy(x))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-12)
    eshape = (tg.num_edges,) + shape[1:]
    vu, vv = r.normal(size=eshape), r.normal(size=eshape)
    out_j = jg.edge_to_vertex_sum(jnp.asarray(vu), jnp.asarray(vv))
    out_t = tg.edge_to_vertex_sum(torch.from_numpy(vu), torch.from_numpy(vv))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-12)
    assert banded.banded_gather.launches == 0
    assert banded.banded_scatter.launches == 0


def random_stage_state(num_vertices, num_edges, la, seed):
    """A seeded PFDR stage state: iterate, gradient, preconditioner (zero
    weights where the edge weight is zero) and auxiliary pairs."""
    r = np.random.default_rng(seed)
    live = (np.asarray(la) != 0).astype(np.float64)
    wdu = r.uniform(0.2, 0.8, num_edges)
    st = dict(
        x=r.normal(size=num_vertices), grad=r.normal(size=num_vertices),
        ga=r.uniform(0.2, 1.5, num_vertices),
        th_l1=r.uniform(0.0, 0.3, num_vertices),
        zu=r.normal(size=num_edges), zv=r.normal(size=num_edges),
        wu=live * r.uniform(0.1, 0.5, num_edges),
        wv=live * r.uniform(0.1, 0.5, num_edges),
        w_d1u=wdu, w_d1v=1.0 - wdu, th_d1=live * r.uniform(0, 0.5, num_edges))
    return st


def jax_staged_step(jg, st, rho, vprox):
    """One staged PFDR edge + vertex stage in the JAX package (its
    ``solvers/pfdr_quadratic.py`` loop body)."""
    s = {k: jnp.asarray(v) for k, v in st.items()}
    p = 2.0 * s["x"] - s["ga"] * s["grad"]
    pxu, pxv = jg.gather_endpoints(jnp.stack([p, s["x"]], axis=-1))
    pu, pv = j_pair_prox(pxu[..., 0] - s["zu"], pxv[..., 0] - s["zv"],
                         s["w_d1u"], s["w_d1v"], s["th_d1"])
    zu = s["zu"] + rho * (pu - pxu[..., 1])
    zv = s["zv"] + rho * (pv - pxv[..., 1])
    xn = jg.edge_to_vertex_sum(s["wu"] * zu, s["wv"] * zv)
    xn = j_vertex_prox(xn, J.VertexProx(*vprox), s["th_l1"])
    d = xn - s["x"]
    return [np.asarray(a) for a in (xn, zu, zv, jnp.sum(d * d),
                                    jnp.sum(xn * xn))]


def port_step(tg, st, rho, vprox):
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    pre = Precond(t["ga"], t["wu"], t["wv"], t["w_d1u"], t["w_d1v"],
                  t["th_d1"], t["th_l1"])
    out = tg.fused_iteration(t["x"], t["grad"], pre, t["zu"], t["zv"], rho,
                             T.VertexProx(*vprox))
    return [a.numpy() for a in out]


VPROXES = [("l1", False), ("l1", True), ("bounds", False, -0.4, 0.9),
           ("none", False)]
VPROX_IDS = ["l1", "l1pos", "bounds", "none"]


@pytest.mark.parametrize("vprox", VPROXES, ids=VPROX_IDS)
def test_fused_step_matches_jax_staged(vprox):
    jg, tg = pair("mesh", seed=3)
    st = random_stage_state(V, tg.num_edges, tg.la_d1.numpy(), seed=4)
    want = jax_staged_step(jg, st, 1.4, vprox)
    got = port_step(tg, st, 1.4, vprox)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    assert banded_fused.fused_banded_iteration.launches == 0


def solve_problem(seed=5):
    eu, ev, la = irregular_graph(seed=seed)
    r = np.random.default_rng(seed + 1)
    a = r.normal(size=(32, V)) / np.sqrt(32)
    y = a @ r.normal(size=V)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    return eu, ev, 0.15 * la, a, y, lip


def jax_solve(eu, ev, la, a, y, lip, vprox, la_l1, it_max=400):
    return J.pfdr_quadratic_d1(
        J.DenseOp(jnp.asarray(a)), jnp.asarray(y),
        J.GraphD1.create(eu, ev, la, num_vertices=V, dtype=jnp.float64),
        la_l1=None if la_l1 is None else jnp.asarray(la_l1),
        vprox=J.VertexProx(*vprox), lipsch=lip,
        opt=J.PFDROptions(rho=1.4, dif_tol=1e-8, it_max=it_max,
                          fused="off"))


@pytest.mark.parametrize("vprox", VPROXES, ids=VPROX_IDS)
@pytest.mark.parametrize("monitor", [True, False],
                         ids=["banded_fused", "solve_fused"])
def test_banded_solve_matches_jax(vprox, monitor):
    """``pfdr_quadratic_d1`` on the port's banded container: monitored runs
    take the ``banded_fused`` loop, unmonitored ones the ``solve_fused``
    whole solve (the plain versions here)."""
    eu, ev, la, a, y, lip = solve_problem()
    la_l1 = np.full(V, 0.03) if vprox[0] == "l1" else None
    base = jax_solve(eu, ev, la, a, y, lip, vprox, la_l1)
    tg = T.BandedGraphD1.create(eu, ev, la, num_vertices=V,
                                dtype=torch.float64, device="cpu")
    res = T.pfdr_quadratic_d1(
        T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y), tg,
        la_l1=None if la_l1 is None else torch.from_numpy(la_l1),
        vprox=T.VertexProx(*vprox), lipsch=lip,
        opt=T.PFDROptions(rho=1.4, dif_tol=1e-8, it_max=400, fused="on"),
        monitor=monitor)
    assert res.it == int(base.it)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(base.x), rtol=0,
                               atol=1e-10)
    assert solve_fused.fused_pfdr_solve.launches == 0


def test_banded_whole_solve_resumes():
    """A banded whole solve stopped at 60 iterations and resumed from its
    state reaches the uninterrupted run's iterate."""
    eu, ev, la, a, y, lip = solve_problem(seed=7)
    tg = T.BandedGraphD1.create(eu, ev, la, num_vertices=V,
                                dtype=torch.float64, device="cpu")
    kw = dict(la_l1=torch.full((V,), 0.03, dtype=torch.float64),
              vprox=T.VertexProx("l1", True), lipsch=lip)
    op, obs = T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y)

    def opt(it_max):
        return T.PFDROptions(rho=1.4, dif_tol=0.0, it_max=it_max, fused="on")

    full = T.pfdr_quadratic_d1(op, obs, tg, opt=opt(120), **kw)
    first, st = T.pfdr_quadratic_d1(op, obs, tg, opt=opt(60),
                                    return_state=True, **kw)
    assert first.it == 60
    rest = T.pfdr_quadratic_d1(op, obs, tg, opt=opt(120), state0=st, **kw)
    assert rest.it == full.it == 120
    np.testing.assert_allclose(rest.x.numpy(), full.x.numpy(), rtol=0,
                               atol=1e-12)


def star_reduced(rv=600):
    """Padded reduced graph of a contraction with a hub: component 0
    adjacent to all others."""
    eu = np.zeros(rv - 1, np.int32)
    ev = np.arange(1, rv, dtype=np.int32)
    return eu, ev, np.full(rv - 1, 0.5)


@pytest.mark.parametrize("kind", ["star", "grid"])
def test_reduced_container_matches_jax(kind):
    if kind == "star":
        reu, rev, rla = star_reduced()
        rv_cap = 1024
    else:
        reu, rev, rla = make_grid_graph(20, 20)
        rv_cap = 512
    jg = j_reduced(reu, rev, rla, rv_cap, jnp.float64)
    tg = t_reduced(reu, rev, rla, rv_cap, torch.float64, "cpu")
    td = t_reduced(torch.from_numpy(reu.astype(np.int64)),
                   torch.from_numpy(rev.astype(np.int64)),
                   torch.from_numpy(rla), rv_cap, torch.float64, "cpu")
    assert type(tg).__name__ == type(jg).__name__ == type(td).__name__
    assert type(tg).__name__ == ("BandedGraphD1" if kind == "star"
                                 else "GraphD1")
    np.testing.assert_array_equal(tg.eu.numpy(), np.asarray(jg.eu))
    np.testing.assert_array_equal(td.ev.numpy(), np.asarray(jg.ev))


def hub_problem(v=400, seed=0):
    """A star (vertex 0 joined to every leaf) under TV denoising: the first
    cut separates about half the leaves, each its own component adjacent
    to the hub's component."""
    r = np.random.default_rng(seed)
    eu = np.zeros(v - 1, np.int32)
    ev = np.arange(1, v, dtype=np.int32)
    la = np.full(v - 1, 0.05)
    y = np.where(r.random(v) < 0.5, 1.0, -1.0) + 0.1 * r.normal(size=v)
    return eu, ev, la, y


@pytest.mark.parametrize("fused", ["auto", "on"], ids=["staged", "small"])
def test_cut_pursuit_with_hub_matches_jax(fused, monkeypatch):
    """Host-cut cut-pursuit whose reduced graph has a hub component: both
    packages hand it to the banded container; solutions agree at 1e-6 and
    objectives at 1e-9 relative (``tests/test_torch_cut_pursuit.py``)."""
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_common
    eu, ev, la, y = hub_problem()
    v = len(y)
    jopt = J.CPOptions(dif_tol=1e-4, it_max=3,
                       pfdr=J.PFDROptions(rho=1.5, dif_tol=1e-7,
                                          it_max=2000))
    res_j = jax_cp(J.IdentityOp(), jnp.asarray(y),
                   J.GraphD1.create(eu, ev, la, num_vertices=v,
                                    dtype=jnp.float64), opt=jopt)
    topt = convert.cp_options(dataclasses.asdict(jopt))
    topt = dataclasses.replace(
        topt, pfdr=dataclasses.replace(topt.pfdr, fused=fused))
    made = []
    real = cut_pursuit_common.make_reduced_container

    def record(*args):
        g = real(*args)
        made.append(type(g).__name__)
        return g

    monkeypatch.setattr(T.solvers.cut_pursuit, "make_reduced_container",
                        record)
    res_t = torch_cp(T.IdentityOp(), torch.from_numpy(y),
                     T.GraphD1.create(eu, ev, la, num_vertices=v,
                                      dtype=torch.float64, device="cpu"),
                     opt=topt)
    assert "BandedGraphD1" in made
    x_j, x_t = res_j.rx[res_j.cv], res_t.rx[res_t.cv]
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-6)

    def objective(x):
        return 0.5 * np.sum((x - y) ** 2) + np.sum(la * np.abs(x[eu] - x[ev]))

    np.testing.assert_allclose(objective(x_t), objective(x_j), rtol=1e-9)
    assert len(res_t.rx) > 100


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fused_launch_shape_covers_every_slot_once(name):
    """``banded_fused.launch_shape`` read as the kernel reads it: lanes are
    the smallest power of two at least the mean slot count of the rows of
    at most LONG_ROW slots; each such row's slots go to exactly one lane of
    one tile thread (lane j takes beg + j, beg + j + L, ...), each of its
    vertices to exactly one lane 0, and each longer row to exactly one
    block past the tiles."""
    _, tg = pair(name)
    idx = tg.edge_index()
    offsets = idx.offsets.numpy().astype(np.int64)
    deg = np.diff(offsets)
    lanes, tiles, n_long = banded_fused.launch_shape(offsets, idx.long_rows)
    short = deg <= banded.LONG_ROW
    assert lanes < 2 * deg[short].mean() <= 2 * lanes or lanes == 1
    assert n_long == int((~short).sum()) == idx.long_rows.numel()
    per = banded_fused.BLOCK // lanes
    i = np.arange(banded_fused.BLOCK)
    v = (np.arange(tiles)[:, None] * per + i // lanes).ravel()
    j = np.tile(i % lanes, tiles)
    live = v < V
    v, j = v[live], j[live]
    lane0 = np.zeros(V, np.int64)
    np.add.at(lane0, v[j == 0], 1)
    assert (lane0 == 1).all()
    slot_cover = np.zeros(offsets[-1], np.int64)
    for vi, ji in zip(v, j):
        if short[vi]:
            slot_cover[offsets[vi] + ji:offsets[vi + 1]:lanes] += 1
    long_rows = idx.long_rows.numpy()
    for vi in long_rows:
        slot_cover[offsets[vi]:offsets[vi + 1]] += 1
    assert (slot_cover == 1).all()
    assert len(set(long_rows.tolist())) == n_long


# (graph, tile) of the launch-shape cases: the mesh and the star padded to
# a multiple of 1024 edges, and the mesh padded to 4096, beyond its 1015
# edges, so that its last edge's endpoints are hubs of the padding
SHAPE_CASES = {"mesh": ("mesh", 1024), "star": ("star", 1024),
               "padded": ("mesh", 4096)}


def port_graph(name, tile):
    """The port's container alone (the JAX one takes multiples of 1024
    only)."""
    eu, ev, la = GRAPHS[name]()
    return T.BandedGraphD1.create(eu, ev, la, num_vertices=V,
                                  dtype=torch.float64, tile=tile,
                                  device="cpu")


def scatter_cover(offsets, long_rows, k, lanes, tiles, seg_len):
    """How often the scatter kernel, read as ``csrc/banded.cu`` maps its
    grid, sums each (slot, column) and writes each (vertex, column): tile
    threads give vertex ``b * BLOCK / lanes + i / lanes`` lanes ``i %
    lanes`` that take the slots ``beg + lane, beg + lane + lanes, ...`` in
    passes of ``kScatterCols`` columns (one at K = 1), lane 0 writing;
    block ``tiles + s * k + c`` sums column ``c`` of segment ``s``
    (:func:`banded.long_segments`: its vertex, slot range and row), thread
    ``t`` a run of ``ceil(len / BLOCK)`` of its slots (``long_row_run``),
    and the row's only segment, or the last of its segments to finish,
    writes.  Returns ``(summed [2E,
    k], written [V, k], blocks per segment and column)``."""
    src = cuda_source("banded.cu")
    block = cuda_constant(src, "kBandedBlock")
    cols = 1 if k == 1 else cuda_constant(src, "kScatterCols")
    nv = len(offsets) - 1
    deg = np.diff(offsets)
    summed = np.zeros((offsets[-1], k), np.int64)
    written = np.zeros((nv, k), np.int64)
    t = np.arange(tiles * block)
    v = (t // block) * (block // lanes) + (t % block) // lanes
    j = (t % block) % lanes
    for c0 in range(0, k, cols):
        cs = slice(c0, min(c0 + cols, k))
        for vi, ji in zip(v, j):
            if vi < nv and deg[vi] <= banded.LONG_ROW:
                summed[offsets[vi] + ji:offsets[vi + 1]:lanes, cs] += 1
                written[vi, cs] += ji == 0
    segs, long_seg = banded.long_segments(offsets, long_rows, seg_len)
    per_seg = np.zeros((len(segs), k), np.int64)
    tickets = np.zeros((len(long_rows), k), np.int64)
    for b in range(len(segs) * k):
        sg, c = divmod(b, k)
        vi, beg, end, r = segs[sg]
        assert vi == long_rows[r] and end - beg <= seg_len
        nseg = long_seg[r + 1] - long_seg[r]
        run = -(-(end - beg) // block)
        for th in range(block):
            lo = beg + th * run
            summed[lo:min(lo + run, end), c] += 1
        per_seg[sg, c] += 1
        tickets[r, c] += 1
        written[vi, c] += nseg == 1 or tickets[r, c] == nseg
    return summed, written, per_seg


@pytest.mark.parametrize("k", [1, 4, 12])
@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_scatter_launch_shape_covers_every_slot_once(case, k):
    """The scatter's launch (:func:`banded.launch_shape`'s lanes and tiles,
    :func:`banded.long_segments`' blocks) sums every (slot, column) exactly
    once, writes every (vertex, column) exactly once and gives each long
    row's segment exactly one block per column, on graphs with and without
    hubs of the padding, at the package's segment length and at one that
    cuts every long row into several segments; K = 12 takes two passes of
    columns."""
    name, tile = SHAPE_CASES[case]
    tg = port_graph(name, tile)
    idx = tg.edge_index()
    offsets = idx.offsets.numpy().astype(np.int64)
    long_rows = idx.long_rows.numpy()
    lanes, tiles, n_long = banded.launch_shape(offsets, long_rows)
    deg = np.diff(offsets)
    assert n_long == int((deg > banded.LONG_ROW).sum())
    if case != "mesh":
        assert n_long > 0
    assert tiles * (banded.BLOCK // lanes) >= V > (tiles - 1) * (
        banded.BLOCK // lanes)
    for seg_len in (banded.LONG_SEGMENT, 100):
        summed, written, per_seg = scatter_cover(offsets, long_rows, k,
                                                 lanes, tiles, seg_len)
        assert (summed == 1).all()
        assert (written == 1).all()
        assert (per_seg == 1).all()
        segs, long_seg = banded.long_segments(offsets, long_rows, seg_len)
        assert long_seg[-1] == len(segs) >= n_long
        if n_long:
            assert (np.diff(long_seg) == -(-deg[long_rows] // seg_len)).all()
    assert len(set(long_rows.tolist())) == n_long


def gather_cover(ne, k, itemsize):
    """How often the gather kernel, read as ``csrc/banded.cu`` maps its
    grid, writes each (row, edge, column) of its [2, E, K] output, and the
    edges whose indices a thread reads 16 bytes at a time: at K = 1 thread
    ``t`` takes edges ``4 t ... 4 t + 3`` (``kGatherEdges``), with one
    vector load of eu and of ev when all four exist and one by one at the
    ragged end; at K > 1 thread ``e`` takes edge ``e``, its columns in
    vectors of the widest of 16 or 8 bytes that divides the row (the
    pointers aligned)."""
    src = cuda_source("banded.cu")
    block = cuda_constant(src, "kGatherBlock")
    edges = cuda_constant(src, "kGatherEdges") if k == 1 else 1
    threads = -(-ne // edges)
    blocks = -(-threads // block)
    written = np.zeros((2, ne, k), np.int64)
    vector_read = np.zeros(ne, np.int64)
    width = next((w for w in (16 // itemsize, 8 // itemsize)
                  if w > 1 and k % w == 0), 1)
    for t in range(blocks * block):
        e0 = t * edges
        if e0 >= ne:
            continue
        if k == 1:
            if e0 + edges <= ne:
                vector_read[e0:e0 + edges] += 1
            written[:, e0:min(e0 + edges, ne), 0] += 1
        else:
            for c in range(0, k, width):
                written[:, e0, c:c + width] += 1
    return written, vector_read


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name,tile", [("mesh", 1), ("star", 1),
                                       ("mesh", 1024)])
def test_gather_launch_covers_every_edge_once(name, tile, k, itemsize):
    """The gather's grid writes every (edge, column) of both rows exactly
    once, at a ragged end (tile 1: 1015 and 998 edges, not multiples of 4)
    and without one; its 16-byte index loads stay inside the edges and
    cover all but the ragged end."""
    tg = port_graph(name, tile)
    ne = tg.num_edges
    written, vector_read = gather_cover(ne, k, itemsize)
    assert (written == 1).all()
    if k == 1:
        edges = cuda_constant(cuda_source("banded.cu"), "kGatherEdges")
        assert vector_read.max() == 1
        assert vector_read.sum() == ne - ne % edges
        if tile == 1:
            assert ne % edges != 0


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_fused_launch_shape_is_the_scatter_helper(case):
    """``banded_fused`` and the scatter share one launch-shape helper and
    its constants, which both CUDA sources hold."""
    assert banded_fused.launch_shape is banded.launch_shape
    assert (banded_fused.BLOCK, banded_fused.MAX_LANES) == (
        banded.BLOCK, banded.MAX_LANES)
    src, fsrc = cuda_source("banded.cu"), cuda_source("banded_fused.cu")
    assert cuda_constant(src, "kBandedBlock") == banded.BLOCK
    assert cuda_constant(fsrc, "kBandedFusedBlock") == banded.BLOCK
    assert cuda_constant(src, "kMaxScatterLanes") == banded.MAX_LANES
    assert cuda_constant(fsrc, "kMaxVertexLanes") == banded.MAX_LANES
    name, tile = SHAPE_CASES[case]
    tg = port_graph(name, tile)
    idx = tg.edge_index()
    offsets = idx.offsets.numpy()
    assert banded_fused.launch_shape(offsets, idx.long_rows) == \
        banded.launch_shape(offsets, idx.long_rows)


@pytest.mark.parametrize("source,struct,mirror", [
    ("banded.cu", "BandedPlan", banded._Plan),
    ("banded_fused.cu", "BandedFusedPlan", banded_fused._Plan)],
    ids=["banded", "banded_fused"])
def test_plans_mirror_the_cuda_source(source, struct, mirror):
    """The ctypes plans have the C structs' fields, offsets and sizes, and
    LONG_ROW is the CUDA source's kLongRow (on the card ``_lib()`` checks
    the sizes against the compiled library too)."""
    src = cuda_source(source)
    assert_struct_mirrors(src, struct, mirror)
    assert cuda_constant(src, "kLongRow") == banded.LONG_ROW
