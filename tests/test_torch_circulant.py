"""Port's circulant container and ``ops/circulant_fused`` against the JAX
package, on the CPU in float64; the ``container`` rule of the API and a
solve resumed across the packages.

The port's wrappers run their kernels' plain versions here (the tensors lie
on the CPU).  The JAX side takes its plain route (``GraphD1`` and
``fused="off"``); ``tests/test_circulant.py`` holds the JAX kernel against
that route.  Tolerances are those of ``tests/test_circulant.py``: transfers
at 1e-12, solves with equal iteration counts and ``x`` within 1e-10.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu import api as japi
from cp_pfdr_graph_d1_tpu import circulant as jcirc
from cp_pfdr_graph_d1_tpu_torch import api as tapi
from cp_pfdr_graph_d1_tpu_torch import circulant as tcirc
from cp_pfdr_graph_d1_tpu_torch import convert
from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused

from .conftest import make_grid_graph
from .test_torch_banded import (VPROX_IDS, VPROXES, jax_staged_step,
                                port_step, random_stage_state)

torch.set_num_threads(1)

V = 600
CIRC_KW = dict(max_families=8, min_count=4)


def mesh_graph(v=V, seed=0):
    """Grid plus random chords (``tests/test_circulant.py``): many repeated
    offsets, some rare ones."""
    r = np.random.default_rng(seed)
    eu, ev, la = make_grid_graph(24, v // 24, seed=seed)
    extra = 40
    ceu = r.integers(0, v, extra).astype(np.int32)
    cev = ((ceu + r.integers(1, v // 2, extra)) % v).astype(np.int32)
    keep = ceu != cev
    return (np.concatenate([eu, ceu[keep]]), np.concatenate([ev, cev[keep]]),
            np.concatenate([la, 0.4 + r.random(keep.sum())]))


def grid_graph():
    """16 x 16 grid under its natural order: no remainder."""
    eu, ev, la = make_grid_graph(16, 16, seed=6)
    return eu, ev, 0.1 * la


def pair(kind, seed=0):
    if kind == "mesh":
        (eu, ev, la), v, kw = mesh_graph(seed=seed), V, CIRC_KW
    else:
        (eu, ev, la), v, kw = grid_graph(), 256, dict(max_families=4,
                                                      min_count=2)
    jg = J.CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                   dtype=jnp.float64, **kw)
    tg = convert.circulant_graph(eu, ev, la, v, device="cpu", **kw)
    return jg, tg


@pytest.mark.parametrize("kind", ["mesh", "grid"])
def test_container_matches_jax(kind):
    jg, tg = pair(kind, seed=1)
    assert tg.num_edges == jg.num_edges
    for name in ("eu", "ev", "la_d1", "incidence"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert tg.offsets == jg.offsets
    assert (tg.vv8, tg.num_rem) == (jg.vv8, jg.num_rem)
    assert (tg.num_rem > 0) == (kind == "mesh")
    np.testing.assert_array_equal(tg.offsets_dev.numpy(), tg.offsets)


def test_strip_order_and_coverage_match_jax():
    from scipy.spatial import Delaunay
    r = np.random.default_rng(8)
    pts = r.random((1500, 2))
    edges = set()
    for s in Delaunay(pts).simplices:
        for i in range(3):
            a, b = int(s[i]), int(s[(i + 1) % 3])
            edges.add((min(a, b), max(a, b)))
    eu = np.array([e[0] for e in edges])
    ev = np.array([e[1] for e in edges])
    order = tcirc.strip_order(pts)
    np.testing.assert_array_equal(order, jcirc.strip_order(pts))
    inv = np.empty(len(pts), np.int64)
    inv[order] = np.arange(len(pts))
    for u, w in ((eu, ev), (inv[eu], inv[ev])):
        for nf in (8, 64):
            assert tcirc.offset_coverage(u, w, nf) == \
                jcirc.offset_coverage(u, w, nf)
    assert tcirc.offset_coverage(inv[eu], inv[ev]) > 0.8


@pytest.mark.parametrize("k", [None, 3])
def test_transfers_match_jax(k):
    jg, tg = pair("mesh", seed=2)
    r = np.random.default_rng(3)
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


@pytest.mark.parametrize("kind", ["mesh", "grid"])
@pytest.mark.parametrize("vprox", VPROXES, ids=VPROX_IDS)
def test_fused_step_matches_jax_staged(kind, vprox):
    """One stage through ``CirculantGraphD1.fused_iteration`` (the kernel's
    plain version) against the JAX staged stage on the same state; ``zu``
    and ``zv`` on the real slots only (virtual slots are path-dependent)."""
    jg, tg = pair(kind, seed=4)
    la = tg.la_d1.numpy()
    st = random_stage_state(tg.num_vertices, tg.num_edges, la, seed=5)
    want = jax_staged_step(jg, st, 1.3, vprox)
    got = port_step(tg, st, 1.3, vprox)
    real = la != 0
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (1, 2):
            g, w = g[real], w[real]
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    assert circulant_fused.fused_circulant_iteration.launches == 0


def solve_pair(kind, vprox, it_max=400):
    if kind == "mesh":
        (eu, ev, la), v = mesh_graph(seed=4), V
        la = 0.12 * la
        kw = CIRC_KW
    else:
        (eu, ev, la), v, kw = grid_graph(), 256, dict(max_families=4,
                                                      min_count=2)
    r = np.random.default_rng(5)
    a = r.normal(size=(32, v)) / np.sqrt(32)
    y = a @ r.normal(size=v)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    la_l1 = np.full(v, 0.03) if vprox[0] == "l1" else None
    base = J.pfdr_quadratic_d1(
        J.DenseOp(jnp.asarray(a)), jnp.asarray(y),
        J.GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64),
        la_l1=None if la_l1 is None else jnp.asarray(la_l1),
        vprox=J.VertexProx(*vprox), lipsch=lip,
        opt=J.PFDROptions(rho=1.4, dif_tol=1e-8, it_max=it_max,
                          fused="off"))
    tg = T.CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                   dtype=torch.float64, device="cpu", **kw)
    res = T.pfdr_quadratic_d1(
        T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y), tg,
        la_l1=None if la_l1 is None else torch.from_numpy(la_l1),
        vprox=T.VertexProx(*vprox), lipsch=lip,
        opt=T.PFDROptions(rho=1.4, dif_tol=1e-8, it_max=it_max, fused="on"))
    return base, res


@pytest.mark.parametrize("kind,vprox", [("mesh", v) for v in VPROXES]
                         + [("grid", VPROXES[0])],
                         ids=[f"mesh-{i}" for i in VPROX_IDS] + ["grid-l1"])
def test_circulant_solve_matches_jax(kind, vprox):
    base, res = solve_pair(kind, vprox)
    assert res.it == int(base.it)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(base.x), rtol=0,
                               atol=1e-10)


API_KW = dict(PFDR_rho=1.4, PFDR_difTol=1e-8, PFDR_itMax=400)


def api_problem():
    eu, ev, la = mesh_graph(seed=6)
    r = np.random.default_rng(7)
    a = r.normal(size=(24, V)) / np.sqrt(24)
    y = a @ r.normal(size=V)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    return (y, a, eu, ev, 0.1 * la), dict(La_l1=np.full(V, 0.02),
                                          positivity=True, L=lip)


def test_api_circulant_matches_jax():
    args, kw = api_problem()
    out_j = japi.pfdr_quadratic_d1_l1(*args, **kw, **API_KW,
                                      container="circulant")
    out_t = tapi.pfdr_quadratic_d1_l1(*args, **kw, **API_KW,
                                      container="circulant", device="cpu")
    assert out_t.it == out_j.it
    np.testing.assert_allclose(out_t.X.numpy(), out_j.X, rtol=0, atol=1e-10)


def test_api_auto_container_rule():
    """"auto" picks the circulant container only for a CUDA device: CPU
    tensors get COO, whatever the graph."""
    from scipy.spatial import Delaunay
    r = np.random.default_rng(9)
    pts = r.random((2000, 2))
    edges = set()
    for s in Delaunay(pts).simplices:
        for i in range(3):
            a, b = int(s[i]), int(s[(i + 1) % 3])
            edges.add((min(a, b), max(a, b)))
    inv = np.empty(len(pts), np.int64)
    inv[tcirc.strip_order(pts)] = np.arange(len(pts))
    eu = inv[np.array([e[0] for e in edges])]
    ev = inv[np.array([e[1] for e in edges])]
    assert len(eu) >= 4096 and tcirc.offset_coverage(eu, ev) >= 0.7
    g = tapi._graph(eu, ev, 0.1, len(pts), torch.float64, "cpu", "auto")
    assert type(g) is T.GraphD1
    g = tapi._graph(eu, ev, 0.1, len(pts), torch.float64, "cpu", "circulant")
    assert type(g) is T.CirculantGraphD1
    with pytest.raises(ValueError, match="unknown container"):
        tapi._graph(eu, ev, 0.1, len(pts), torch.float64, "cpu", "banded")


def test_jax_state_resumes_in_port():
    """A JAX solve on a ``CirculantGraphD1`` stopped at 60 iterations,
    carried through ``convert``, resumes in the port to the uninterrupted
    JAX result."""
    eu, ev, la = mesh_graph(seed=8)
    la = 0.12 * la
    r = np.random.default_rng(9)
    a = r.normal(size=(32, V)) / np.sqrt(32)
    y = a @ r.normal(size=V)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    jg = J.CirculantGraphD1.create(eu, ev, la, num_vertices=V,
                                   dtype=jnp.float64, **CIRC_KW)
    jkw = dict(la_l1=jnp.full((V,), 0.03),
               vprox=J.VertexProx(kind="l1", positivity=True), lipsch=lip)
    jop, jy = J.DenseOp(jnp.asarray(a)), jnp.asarray(y)

    def jopt(it_max):
        return J.PFDROptions(rho=1.4, dif_tol=0.0, it_max=it_max,
                             fused="off")

    full = J.pfdr_quadratic_d1(jop, jy, jg, opt=jopt(120), **jkw)
    _, st = J.pfdr_quadratic_d1(jop, jy, jg, opt=jopt(60), return_state=True,
                                **jkw)
    state = convert.pfdr_solve_state(
        st.x, st.zu, st.zv, [np.asarray(a) for a in st.pre], st.x_prev,
        st.dif, st.dif_rcd2, st.it, device="cpu")
    tg = convert.circulant_graph(eu, ev, la, V, device="cpu", **CIRC_KW)
    opt = convert.pfdr_options(dataclasses.asdict(jopt(120)))
    res = T.pfdr_quadratic_d1(
        T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y), tg,
        la_l1=torch.full((V,), 0.03, dtype=torch.float64),
        vprox=T.VertexProx(kind="l1", positivity=True), lipsch=lip,
        opt=dataclasses.replace(opt, fused="on"), state0=state)
    assert res.it == int(full.it) == 120
    np.testing.assert_allclose(res.x.numpy(), np.asarray(full.x), rtol=0,
                               atol=1e-10)


def kernel_endpoint_gamma(g, ga):
    """Gamma at each slot's two ends as the CUDA kernel reads it: a family
    slot (f, u) joins padded vertex u to (u + d_f) mod VV, and a padded
    position (u >= V) reads 0; a remainder slot reads its endpoints."""
    nf, vv = len(g.offsets), g.vv
    pad = torch.cat([ga, ga.new_zeros(vv - g.num_vertices)])
    u = torch.arange(vv).repeat(nf)
    w = (u + torch.tensor(g.offsets).repeat_interleave(vv)) % vv
    gau, gav = g.gather_endpoints(ga)
    return (torch.cat([pad[u], gau[nf * vv:]]),
            torch.cat([pad[w], gav[nf * vv:]]))


@pytest.mark.parametrize("kind", ["mesh", "grid"])
def test_kernel_derived_weights_match_preconditioner(kind):
    """The CUDA kernel derives ``w_d1v = 1 - w_d1u`` and ``wv = wu (w_d1v /
    safe_u) (Gamma_v / safe_Gamma_u)`` (0 where Gamma_u = 0) instead of
    reading them, as the TPU kernel does: on the mesh's and the grid's
    circulant containers, with one vertex whose edges all have weight 0,
    the identity holds for the quadratic preconditioner's outputs after
    ``initial_precondition`` and after ``recondition``, to 1e-14 relative
    in float64, virtual slots included."""
    from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
    from cp_pfdr_graph_d1_tpu_torch.solvers import pfdr_quadratic as pq
    if kind == "mesh":
        (eu, ev, la), v, kw = mesh_graph(seed=2), V, CIRC_KW
    else:
        (eu, ev, la), v, kw = grid_graph(), 256, dict(max_families=4,
                                                      min_count=2)
    la = la.copy()
    la[(eu == 5) | (ev == 5)] = 0.0  # vertex 5 keeps no weighted edge
    g = T.CirculantGraphD1.create(eu, ev, la, num_vertices=v,
                                  dtype=torch.float64, device="cpu", **kw)
    r = np.random.default_rng(7)
    a = torch.from_numpy(r.normal(size=(24, v)) / np.sqrt(24))
    op, obs = T.DenseOp(a), a @ torch.from_numpy(r.normal(size=v))
    la_l1 = torch.full((v,), 0.02, dtype=torch.float64)
    lip = float(torch.linalg.matrix_norm(a, 2) ** 2)
    pre = pq.initial_precondition(op, obs, g, la_l1, 1.5, lip, Lipsch.SCAL)
    x = torch.from_numpy(np.abs(r.normal(size=v)))
    zu, zv = (torch.from_numpy(r.normal(size=g.num_edges)) for _ in range(2))
    pre2, _, _ = pq.recondition(op, obs, g, la_l1, 1.5, 1e-2, lip,
                                Lipsch.SCAL, x, op.grad(x, obs), zu, zv, pre)
    for p in (pre, pre2):
        assert bool((p.wu[(g.la_d1 == 0)] == 0).all())
        gau, gav = kernel_endpoint_gamma(g, p.ga)
        w_d1u = p.w_d1u
        safe_u = torch.where(w_d1u > 0, w_d1u, 1.0)
        safe_g = torch.where(gau > 0, gau, 1.0)
        wv = p.wu * ((1.0 - w_d1u) / safe_u) * torch.where(
            gau > 0, gav / safe_g, 0.0)
        torch.testing.assert_close(wv, p.wv, rtol=1e-14, atol=0)
        torch.testing.assert_close(1.0 - w_d1u, p.w_d1v, rtol=1e-14, atol=0)


@pytest.mark.parametrize("kind", ["mesh", "grid"])
def test_launch_shape_covers_every_slot_once(kind):
    """``launch_shape``'s groups and blocks, read as the kernel reads them,
    give every (padded vertex, family) pair to exactly one thread of the
    main launch, and every remainder row to exactly one place: the
    group-0 thread of its vertex, or (more than LONG_ROW slots) one block
    of the first launch."""
    from cp_pfdr_graph_d1_tpu_torch.ops.banded import LONG_ROW
    _, g = pair(kind, seed=3)
    nf, vv = len(g.offsets), g.vv
    groups, blocks = circulant_fused.launch_shape(vv, nf)
    # the largest power of two at most min(nf, MAX_GROUPS)
    cap = min(nf, circulant_fused.MAX_GROUPS)
    assert groups & (groups - 1) == 0 and groups <= cap < 2 * groups
    tv = circulant_fused.BLOCK // groups
    i = np.arange(circulant_fused.BLOCK)
    u = (np.arange(blocks)[:, None] * tv + i % tv).ravel()
    grp = np.tile(i // tv, blocks)
    cover = np.zeros((vv, nf), np.int64)
    for f in range(nf):
        mine = (u < vv) & (grp * nf // groups <= f) \
            & (f < (grp + 1) * nf // groups)
        np.add.at(cover[:, f], u[mine], 1)
    assert (cover == 1).all()
    group0 = np.zeros(vv, np.int64)
    np.add.at(group0, u[(u < vv) & (grp == 0)], 1)
    assert (group0 == 1).all()
    if g.rem_graph is not None:
        idx = g.rem_graph.edge_index()
        deg = np.diff(idx.offsets.numpy())
        np.testing.assert_array_equal(idx.long_rows.numpy(),
                                      np.nonzero(deg > LONG_ROW)[0])
    assert circulant_fused.launch_shape(20480, 64) == (8, 640)
    assert circulant_fused.launch_shape(20480, 2) == (2, 160)
