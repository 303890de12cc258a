"""Port's stencil container and stencil kernel module against the JAX
package, on the CPU in float64.

The port's fused iteration runs its kernel's plain PyTorch version here (the
tensors lie on the CPU); the JAX side runs its Pallas kernel in interpret
mode, as ``tests/test_stencil.py`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu import GraphD1 as JGraphD1
from cp_pfdr_graph_d1_tpu.ops.stencil_fused import fused_stencil_iteration
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1 as JStencil
from cp_pfdr_graph_d1_tpu_torch import GraphD1, StencilGraphD1, VertexProx
from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import Precond

torch.set_num_threads(1)


def make_pair(h, w, shifts, wrap, seed):
    """The same stencil graph in both packages."""
    r = np.random.default_rng(seed)
    weights = {s: r.uniform(0.2, 1.0, (h, w)) for s in shifts}
    jg = JStencil.create((h, w), weights, wrap=wrap, dtype=jnp.float64)
    tg = StencilGraphD1.create((h, w), weights, wrap=wrap,
                               dtype=torch.float64, device="cpu")
    return jg, tg


def test_gather_reduce_and_coo_view_match_jax():
    jg, tg = make_pair(12, 10, ((0, 1), (1, 0)), (False, True), seed=0)
    np.testing.assert_array_equal(tg.eu, np.asarray(jg.eu))
    np.testing.assert_array_equal(tg.ev, np.asarray(jg.ev))
    np.testing.assert_array_equal(tg.la_d1.numpy(), np.asarray(jg.la_d1))
    r = np.random.default_rng(1)
    x = r.normal(size=tg.num_vertices)
    for xs in (x, r.normal(size=(tg.num_vertices, 3))):
        ju, jv = jg.gather_endpoints(jnp.asarray(xs))
        tu, tv = tg.gather_endpoints(torch.from_numpy(xs))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-12)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-12)
    vu, vv = r.normal(size=(2, tg.num_edges))
    out_j = jg.edge_to_vertex_sum(jnp.asarray(vu), jnp.asarray(vv))
    out_t = tg.edge_to_vertex_sum(torch.from_numpy(vu), torch.from_numpy(vv))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-12)

    # the COO container of the port agrees with the JAX one on the same
    # edges (nonzero-weight edges of the stencil)
    keep = tg.la_d1.numpy() > 0
    eu, ev, la = tg.eu[keep], tg.ev[keep], tg.la_d1.numpy()[keep]
    jc = JGraphD1.create(eu, ev, la, num_vertices=tg.num_vertices,
                         dtype=jnp.float64)
    tc = GraphD1.create(eu, ev, la, num_vertices=tg.num_vertices,
                        dtype=torch.float64, device="cpu")
    out_j = jc.edge_to_vertex_sum(jnp.asarray(vu[keep]), jnp.asarray(vv[keep]))
    out_t = tc.edge_to_vertex_sum(torch.from_numpy(vu[keep]),
                                  torch.from_numpy(vv[keep]))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-12)
    np.testing.assert_allclose(
        tc.gather_endpoints(torch.from_numpy(x))[1].numpy(),
        np.asarray(jc.gather_endpoints(jnp.asarray(x))[1]), atol=1e-12)


VPROXES = [VertexProx(kind="l1"), VertexProx(kind="l1", positivity=True),
           VertexProx(kind="bounds", lo=-0.5, hi=0.8), VertexProx()]
FAMILIES = {2: ((0, 1), (1, 0)), 4: ((0, 1), (1, 0), (1, 1), (1, -1))}


@pytest.mark.parametrize("vprox", VPROXES, ids=["l1", "l1pos", "bounds",
                                                "none"])
@pytest.mark.parametrize("wrap", [(False, False), (True, True)],
                         ids=["nowrap", "wrap"])
@pytest.mark.parametrize("f", [2, 4])
def test_fused_iteration_plain_matches_pallas(vprox, wrap, f):
    """One stage through the port's ``StencilGraphD1.fused_iteration`` (the
    kernel's plain version on the CPU) against the JAX Pallas kernel in
    interpret mode, on the same random state."""
    h, w = 6, 10
    jg, tg = make_pair(h, w, FAMILIES[f], wrap, seed=10 + f)
    r = np.random.default_rng(20 + f)
    v, e = h * w, f * h * w
    live = tg.la_d1.numpy() > 0  # zero-weight slots carry zero weights
    x, grad = r.normal(size=(2, v))
    ga, th_l1 = r.uniform(0.1, 1.0, (2, v))
    zu, zv = r.normal(size=(2, e))
    wu, wv, w_d1u, th_d1 = r.uniform(0.05, 0.5, (4, e)) * live
    w_d1u = np.where(live, w_d1u / 0.5 * 0.9 + 0.05, 0.5)
    w_d1v = 1.0 - w_d1u
    rho = 1.3

    xn, zun, zvn, num, den = fused_stencil_iteration(
        jnp.asarray(x.reshape(h, w)), jnp.asarray(grad.reshape(h, w)),
        jnp.asarray(ga.reshape(h, w)), jnp.asarray(th_l1.reshape(h, w)),
        *(jnp.asarray(a.reshape(f, h, w))
          for a in (zu, zv, wu, wv, w_d1u, w_d1v, th_d1)),
        shifts=tg.shifts, rho=rho, vkind=vprox.kind,
        positivity=vprox.positivity, lo=float(vprox.lo), hi=float(vprox.hi),
        interpret=True)

    t = torch.from_numpy
    pre = Precond(t(ga), t(wu), t(wv), t(w_d1u), t(w_d1v), t(th_d1),
                  t(th_l1))
    launches = stencil_fused.fused_stencil_iteration.launches
    txn, tzu, tzv, tnum, tden = tg.fused_iteration(
        t(x), t(grad), pre, t(zu), t(zv), rho, vprox)
    assert stencil_fused.fused_stencil_iteration.launches == launches
    np.testing.assert_allclose(txn.numpy(), np.asarray(xn).ravel(),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(tzu.numpy(), np.asarray(zun).ravel(),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(tzv.numpy(), np.asarray(zvn).ravel(),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(float(tnum), float(num), rtol=1e-13)
    np.testing.assert_allclose(float(tden), float(den), rtol=1e-13)


# -- the kernel's launch: a thread a vertex ---------------------------------

SHIFT_CASES = {1: ((1, 0),), 2: ((0, 1), (1, 0)),
               4: ((0, 1), (1, 0), (1, 1), (1, -1)),
               "long": ((0, 1), (2, -1), (0, 9))}


def pair_prox(pu, pv, zu, zv, xu, xv, wdu, wdv, th, rho):
    """``pair_prox_relax`` of ``csrc/pfdr_common.cuh`` on scalars."""
    au, av = pu - zu, pv - zv
    avg, diff = wdu * au + wdv * av, au - av
    shrunk = np.sign(diff) * max(abs(diff) - th, 0.0)
    return (zu + rho * ((avg + wdv * shrunk) - xu),
            zv + rho * ((avg - wdu * shrunk) - xv))


def vertex_schedule(fields, shifts, h, w, rho, vprox):
    """A numpy copy of the kernel's schedule, written from
    ``csrc/stencil_fused.cu`` (it checks the launch shape and the
    schedule's arithmetic, not the CUDA code, which ``chip_smoke.py`` holds
    against the plain version on the card): ``(x_new, zu, zv, visits)`` where
    ``visits`` counts the threads of the launch (``blocks(h, w)`` blocks of
    ``VERTEX_BLOCK``) that took each cell.  A thread computes, family by
    family, its cell's own edge (tail at the cell) and writes it, adds wu
    zu, then recomputes the edge whose head the cell is from its tail's
    values (wrapped) and adds wv zv."""
    from cp_pfdr_graph_d1_tpu_torch.ops.prox import vertex_prox_plain
    f = len(shifts)
    x, grad, ga, th_l1 = (a.ravel() for a in fields[:4])
    zu, zv, wu, wv, wdu, wdv, thd = (a.reshape(f, h * w) for a in fields[4:])
    p = 2.0 * x - ga * grad
    acc = np.zeros(h * w)
    zuo, zvo = np.full((f, h * w), np.nan), np.full((f, h * w), np.nan)
    visits = np.zeros(h * w, np.int64)
    nt = stencil_fused.VERTEX_BLOCK
    for b in range(stencil_fused.blocks(h, w)):
        for t in range(nt):
            c = b * nt + t
            if c >= h * w:
                continue
            visits[c] += 1
            i, j = divmod(c, w)
            for k, (dy, dx) in enumerate(shifts):
                v = (i + dy) % h * w + (j + dx) % w
                zun, zvn = pair_prox(p[c], p[v], zu[k, c], zv[k, c], x[c],
                                     x[v], wdu[k, c], wdv[k, c], thd[k, c],
                                     rho)
                zuo[k, c], zvo[k, c] = zun, zvn
                acc[c] += wu[k, c] * zun
                u = (i - dy) % h * w + (j - dx) % w
                _, zvn = pair_prox(p[u], p[c], zu[k, u], zv[k, u], x[u],
                                   x[c], wdu[k, u], wdv[k, u], thd[k, u],
                                   rho)
                acc[c] += wv[k, u] * zvn
    xn = vertex_prox_plain(torch.from_numpy(acc), torch.from_numpy(th_l1),
                           vprox.kind, vprox.positivity, vprox.lo,
                           vprox.hi).numpy()
    return xn, zuo, zvo, visits


def stage_state(h, w, shifts, wrap, seed):
    """A stencil graph and random stage fields on it (float64, CPU)."""
    _, tg = make_pair(h, w, shifts, wrap, seed)
    r = np.random.default_rng(seed + 1)
    f, v = len(shifts), h * w
    live = tg.la_d1.numpy() > 0
    x, grad = r.normal(size=(2, v))
    ga, th_l1 = r.uniform(0.1, 1.0, (2, v))
    zu, zv = r.normal(size=(2, f * v))
    wu, wv, th_d1 = r.uniform(0.05, 0.5, (3, f * v)) * live
    w_d1u = np.where(live, r.uniform(0.05, 0.95, f * v), 0.5)
    return tg, (x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, 1.0 - w_d1u,
                th_d1)


@pytest.mark.parametrize("hw", [(13, 21), (9, 30)], ids=["13x21", "9x30"])
@pytest.mark.parametrize("wrap", [(False, False), (True, False)],
                         ids=["nowrap", "wrapy"])
@pytest.mark.parametrize("f", [1, 2, 4, "long"])
def test_launch_covers_every_cell_once(f, wrap, hw):
    """The launch (``blocks``, ``VERTEX_BLOCK``) takes every cell of a field
    whose size is not a multiple of the block exactly once, and the
    kernel's schedule (own edge, then the incoming edge recomputed from its
    wrapped tail) gives the plain version's stage, float64."""
    h, w = hw
    shifts = SHIFT_CASES[f]
    _, fields = stage_state(h, w, shifts, wrap, seed=3)
    assert (h * w) % stencil_fused.VERTEX_BLOCK != 0
    vp = VertexProx(kind="l1")
    xn, zun, zvn, visits = vertex_schedule(fields, shifts, h, w, 1.3, vp)
    assert visits.min() == visits.max() == 1
    t = torch.from_numpy
    fl = len(shifts)
    want = stencil_fused.stencil_iteration_plain(
        *(t(a).reshape(h, w) for a in fields[:4]),
        *(t(a).reshape(fl, h, w) for a in fields[4:]), shifts=shifts,
        rho=1.3, vkind=vp.kind, positivity=vp.positivity, lo=vp.lo,
        hi=vp.hi)
    np.testing.assert_allclose(xn, want[0].numpy().ravel(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(zun, want[1].numpy().reshape(fl, -1), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(zvn, want[2].numpy().reshape(fl, -1), rtol=0,
                               atol=1e-13)
