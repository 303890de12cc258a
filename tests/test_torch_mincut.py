"""Port's PDHG min-cut against the JAX package, on the CPU in float64.

``maxflow/device._pdhg_min_cut`` (the plain loop on any container) and the
plain version of the ``mincut_fused`` kernel are held against the JAX
package's ``_pdhg_min_cut`` and its Pallas kernel in interpret mode, on
12 x 16 fields with ``check_every = 50``: equal step counts and thresholds,
iterates at 1e-10 (the two differ only in summation order).  The
certified-with-fallback entry is held against the host push-relabel by
cut value, since a non-unique min-cut may put vertices on either side.
The directed and duplex cuts are held to the JAX functions the same way,
and the counterparts of ``tests/test_mincut.py:261-383`` hold the directed
cut and the duplex device loop to the host solvers.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu.graph import GraphD1 as JGraph
from cp_pfdr_graph_d1_tpu.maxflow import device as jdev
from cp_pfdr_graph_d1_tpu.ops import mincut_fused as jmf
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1 as JStencil
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu_torch import GraphD1, StencilGraphD1, maxflow
from cp_pfdr_graph_d1_tpu_torch.maxflow import device as tdev
from cp_pfdr_graph_d1_tpu_torch.ops import mincut_fused as tmf
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import cp_quadratic_d1

from .conftest import make_grid_graph

torch.set_num_threads(1)

H, W = 12, 16
SHIFTS = {2: ((0, 1), (1, 0)), 4: ((0, 1), (1, 0), (1, 1), (1, -1))}


def cut_inputs(f, seed=0, warm=False):
    """Weights, costs, steps and starts of one cut on a 12 x 16 stencil
    with 10 % of its edges masked, as ``device_cut_stencil_fused`` builds
    them."""
    r = np.random.default_rng(seed)
    shifts = SHIFTS[f]
    g = JStencil.create((H, W), {s: 0.3 for s in shifts}, dtype=jnp.float64)
    w = np.where(r.random(g.num_edges) < 0.1, 0.0, np.asarray(g.la_d1))
    c = r.standard_normal(H * W)
    deg = np.asarray(g.vertex_degree_weighted(jnp.asarray(w)))
    tau = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-30),
                   1.0 / np.maximum(np.abs(c), 1e-12))
    sigma = np.where(w > 0, 0.5 / np.maximum(w, 1e-30), 0.0)
    x0 = r.random(H * W) if warm else np.full(H * W, 0.5)
    z0 = r.uniform(-1, 1, g.num_edges) if warm else np.zeros(g.num_edges)
    big = 1.0 + 2.0 * (w.sum() + np.abs(c).sum())
    e = (f, H, W)
    return shifts, [w.reshape(e), c.reshape(H, W), tau.reshape(H, W),
                    sigma.reshape(e), x0.reshape(H, W), z0.reshape(e)], \
        1e-6 * big


@pytest.mark.parametrize("f,warm", [(2, False), (2, True), (4, False),
                                    (4, True)])
def test_plain_kernel_matches_pallas_kernel(f, warm):
    shifts, arrays, tol = cut_inputs(f, seed=f, warm=warm)
    kw = dict(shifts=shifts, check_every=50)
    xj, zj, gj, tj, ij = jmf.fused_pdhg_min_cut(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(tol), 5000,
        interpret=True, **kw)
    xt, zt, gt, tt, it = tmf.fused_pdhg_min_cut(
        *(torch.from_numpy(a) for a in arrays),
        torch.tensor(tol, dtype=torch.float64), 5000, **kw)
    assert int(it) == int(ij) and int(it) < 5000
    assert float(tt) == float(tj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(gt), float(gj), rtol=0, atol=1e-10)
    assert float(gt) <= tol


def coo_graph(seed=0, v=150, e=400):
    r = np.random.default_rng(seed)
    eu = r.integers(0, v, e).astype(np.int32)
    ev = r.integers(0, v, e).astype(np.int32)
    keep = eu != ev
    return eu[keep], ev[keep], r.uniform(0.1, 0.5, keep.sum()), v


@pytest.mark.parametrize("container", ["stencil", "coo"])
def test_pdhg_min_cut_matches_jax(container):
    r = np.random.default_rng(7)
    if container == "stencil":
        gj = JStencil.create((H, W), {(0, 1): 0.3, (1, 0): 0.3},
                             dtype=jnp.float64)
        gt = StencilGraphD1.create((H, W), {(0, 1): 0.3, (1, 0): 0.3},
                                   dtype=torch.float64, device="cpu")
        w = np.asarray(gj.la_d1) * (r.random(gj.num_edges) > 0.1)
    else:
        eu, ev, w, v = coo_graph()
        gj = JGraph.create(eu, ev, w, num_vertices=v, dtype=jnp.float64)
        gt = GraphD1.create(eu, ev, w, num_vertices=v, dtype=torch.float64,
                            device="cpu")
    c = r.standard_normal(gj.num_vertices)
    tol = 1e-6 * (1.0 + 2.0 * (w.sum() + np.abs(c).sum()))
    sj, gapj, itj, xj, zj = jdev._pdhg_min_cut(
        gj, jnp.asarray(w), jnp.asarray(c), jnp.asarray(tol), 20_000, 50)
    st, gapt, itt, xt, zt = tdev._pdhg_min_cut(
        gt, torch.from_numpy(w), torch.from_numpy(c),
        torch.tensor(tol, dtype=torch.float64), 20_000, 50)
    assert itt == int(itj) and itt < 20_000
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_min_cut_device_with_fallback_matches_host():
    eu, ev, w, v = coo_graph(seed=3)
    c = np.random.default_rng(3).standard_normal(v)
    host = maxflow.min_cut(v, eu, ev, w, c)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        side = tdev.min_cut_device_with_fallback(
            v, eu, ev, w, c, tol=1e-9, it_max=50_000, check_every=50,
            dtype=torch.float64, device="cpu")
    big = 1.0 + 2.0 * (w.sum() + np.abs(c).sum())
    assert abs(tdev.cut_value(eu, ev, w, c, side)
               - tdev.cut_value(eu, ev, w, c, host)) <= 2e-9 * big
    # a step cap too small to certify: a warning, then the host cut itself
    with pytest.warns(UserWarning, match="host min-cut"):
        side = tdev.min_cut_device_with_fallback(
            v, eu, ev, w, c, tol=1e-12, it_max=10, dtype=torch.float64,
            device="cpu")
    np.testing.assert_array_equal(side, host)


def test_min_cut_device_stencil_and_coo_agree_with_jax():
    """``min_cut_device`` on a stencil (the kernel's route) and on its COO
    view certifies the same cut value as the JAX package's."""
    gt = StencilGraphD1.create((H, W), {(0, 1): 0.3, (1, 0): 0.3},
                               dtype=torch.float64, device="cpu")
    eu, ev, la = gt.host_coo()
    c = np.random.default_rng(11).standard_normal(H * W)
    kw = dict(tol=1e-8, it_max=20_000, check_every=50, return_gap=True)
    sj, _, cj = jdev.min_cut_device(H * W, eu, ev, la, c,
                                    dtype=jnp.float64, **kw)
    ss, _, cs = tdev.min_cut_device(H * W, eu, ev, la, c, graph=gt,
                                    dtype=torch.float64, **kw)
    sc, _, cc = tdev.min_cut_device(H * W, eu, ev, la, c,
                                    dtype=torch.float64, device="cpu", **kw)
    assert cj and cs and cc
    want = tdev.cut_value(eu, ev, la, c, sj)
    big = 1.0 + 2.0 * (la.sum() + np.abs(c).sum())
    for side in (ss, sc):
        assert abs(tdev.cut_value(eu, ev, la, c, side) - want) <= 2e-8 * big


def directed_value(eu, ev, w_uv, w_vu, c, side):
    """Objective of a cut with per-direction arc capacities."""
    side = np.asarray(side).astype(bool)
    return (float(np.sum(c[side])) + float(np.sum(w_uv[side[eu] & ~side[ev]]))
            + float(np.sum(w_vu[side[ev] & ~side[eu]])))


def directed_inputs(seed, n, e):
    r = np.random.default_rng(seed)
    eu = r.integers(0, n, e).astype(np.int32)
    ev = ((eu + 1 + r.integers(0, n - 1, e)) % n).astype(np.int32)
    return (eu, ev, r.uniform(0.0, 1.0, e), r.uniform(0.0, 1.0, e),
            r.normal(size=n))


@pytest.mark.parametrize("seed", range(4))
def test_directed_device_cut_matches_host(seed):
    """``tests/test_mincut.py::test_directed_device_cut_matches_host``: the
    asymmetric-dual PDHG cut reaches the directed push-relabel's cut
    value."""
    n = 24
    eu, ev, w_uv, w_vu, c = directed_inputs(seed + 40, n, 70)
    side_d = tdev.min_cut_directed_device(n, eu, ev, w_uv, w_vu, c,
                                          dtype=torch.float64, device="cpu")
    side_h = maxflow.min_cut_directed(n, eu, ev, w_uv, w_vu, c)
    np.testing.assert_allclose(directed_value(eu, ev, w_uv, w_vu, c, side_d),
                               directed_value(eu, ev, w_uv, w_vu, c, side_h),
                               atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_directed_python_fallback_agrees(seed):
    """``tests/test_mincut.py::test_directed_python_fallback_agrees``: the
    directed Dinic fallback equals the native directed solver."""
    n = 16
    eu, ev, w_uv, w_vu, c = directed_inputs(seed + 50, n, 40)
    side_py = maxflow._min_cut_python(n, eu, ev, w_uv, w_vu, c)
    side_h = maxflow.min_cut_directed(n, eu, ev, w_uv, w_vu, c)
    np.testing.assert_allclose(directed_value(eu, ev, w_uv, w_vu, c, side_py),
                               directed_value(eu, ev, w_uv, w_vu, c, side_h),
                               atol=1e-9)


def duplex_problem(h, w, seed):
    """``tests/test_mincut.py``'s duplex problems: a grid fused LASSO with
    l1, float64."""
    v = h * w
    eu, ev, la = make_grid_graph(h, w, seed=seed)
    r = np.random.default_rng(seed + 1)
    a = r.normal(size=(30, v)) / np.sqrt(30)
    x_true = np.zeros((h, w))
    x_true[1:4, 1:4] = 1.5
    x_true[h - 3:h - 1, w - 4:w - 1] = -2.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=30)
    g = GraphD1.create(eu, ev, 0.3 * la, dtype=torch.float64, device="cpu")
    return a, y, np.full(v, 0.02), g


def solve_duplex(a, y, la_l1, g, positivity, **opt):
    res = cp_quadratic_d1(
        T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y), g, la_l1=la_l1,
        positivity=positivity, duplex=True,
        opt=T.CPOptions(dif_tol=1e-5, pfdr=T.PFDROptions(
            rho=1.5, dif_tol=1e-9, it_max=5000), **opt))
    return res.rx[res.cv]


@pytest.mark.parametrize("positivity", [False, True])
def test_duplex_device_loop_matches_host_duplex(positivity):
    """``tests/test_mincut.py::test_duplex_device_loop_matches_host_duplex``:
    ``cut="device", duplex=True`` reaches the host duplex solution."""
    a, y, la_l1, g = duplex_problem(8, 8, 31)
    base = solve_duplex(a, y, la_l1, g, positivity, it_max=10, cut="host")
    res = solve_duplex(a, y, la_l1, g, positivity, it_max=10, cut="device")
    np.testing.assert_allclose(res, base, atol=1e-6)


def test_duplex_device_cut_fallback():
    """``tests/test_mincut.py::test_duplex_device_cut_fallback``: a starved
    duplex PDHG budget, still uncertified after its continuation, falls
    back to the host directed cut on CPU tensors, with a warning."""
    a, y, la_l1, g = duplex_problem(6, 6, 33)
    base = solve_duplex(a, y, la_l1, g, False, it_max=8, cut="host")
    with pytest.warns(UserWarning, match="falling back"):
        res = solve_duplex(a, y, la_l1, g, False, it_max=8, cut="device",
                           cut_it_max=1)
    np.testing.assert_allclose(res, base, atol=1e-6)


def parity_graphs(container, seed):
    """A 12 x 16 stencil or a random COO graph in both packages, float64,
    with 10 % of the edges at weight zero."""
    r = np.random.default_rng(seed)
    if container == "stencil":
        gj = JStencil.create((H, W), {(0, 1): 0.3, (1, 0): 0.3},
                             dtype=jnp.float64)
        gt = StencilGraphD1.create((H, W), {(0, 1): 0.3, (1, 0): 0.3},
                                   dtype=torch.float64, device="cpu")
        w = np.asarray(gj.la_d1) * (r.random(gj.num_edges) > 0.1)
    else:
        eu, ev, w, v = coo_graph(seed)
        w = w * (r.random(len(w)) > 0.1)
        gj = JGraph.create(eu, ev, w, num_vertices=v, dtype=jnp.float64)
        gt = GraphD1.create(eu, ev, w, num_vertices=v, dtype=torch.float64,
                            device="cpu")
    return r, gj, gt, w


@pytest.mark.parametrize("container", ["stencil", "coo"])
def test_pdhg_min_cut_directed_matches_jax(container):
    """``_pdhg_min_cut_directed`` against the JAX function: equal step
    counts and sides, gaps at 1e-10 (the JAX function returns no
    iterates)."""
    r, gj, gt, w = parity_graphs(container, 11)
    w_uv = w * r.uniform(0.2, 1.0, len(w))
    w_vu = w * r.uniform(0.2, 1.0, len(w))
    c = r.standard_normal(gj.num_vertices)
    tol = 1e-6 * (1.0 + 2.0 * (w_uv.sum() + w_vu.sum() + np.abs(c).sum()))
    sj, gapj, itj = jdev._pdhg_min_cut_directed(
        gj, jnp.asarray(w_uv), jnp.asarray(w_vu), jnp.asarray(c),
        jnp.asarray(tol), 20_000, 50)
    st, gapt, itt = tdev._pdhg_min_cut_directed(
        gt, torch.from_numpy(w_uv), torch.from_numpy(w_vu),
        torch.from_numpy(c), torch.tensor(tol, dtype=torch.float64), 20_000,
        50)
    assert itt == int(itj) and itt < 20_000
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(float(gapt), float(gapj), rtol=0, atol=1e-10)
    assert float(gapt) <= tol


@pytest.mark.parametrize("container,warm", [("stencil", False),
                                            ("coo", False), ("coo", True)])
def test_pdhg_min_cut_duplex_matches_jax(container, warm):
    """``_pdhg_min_cut_duplex`` against the JAX function, cold and from a
    warm start: equal step counts and sides, x, z and zv at 1e-10."""
    r, gj, gt, w = parity_graphs(container, 13)
    v, e = gj.num_vertices, gj.num_edges
    c1, c2 = r.standard_normal(v), r.standard_normal(v)
    m = np.maximum(0.0, r.standard_normal(v))
    tol = 1e-6 * (1.0 + 2.0 * (2 * w.sum() + np.abs(c1).sum()
                               + np.abs(c2).sum() + m.sum()))
    start = ((r.random((v, 2)), r.uniform(-1, 1, (e, 2)), r.random(v))
             if warm else (None, None, None))

    def args(conv):
        return [None if a is None else conv(a) for a in start]

    out_j = jdev._pdhg_min_cut_duplex(
        gj, jnp.asarray(w), jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(m),
        jnp.asarray(tol), 20_000, 50, *args(jnp.asarray))
    out_t = tdev._pdhg_min_cut_duplex(
        gt, torch.from_numpy(w), torch.from_numpy(c1), torch.from_numpy(c2),
        torch.from_numpy(m), torch.tensor(tol, dtype=torch.float64), 20_000,
        50, *args(torch.from_numpy))
    (sj, gapj, itj, *state_j), (st, gapt, itt, *state_t) = out_j, out_t
    assert itt == int(itj) and itt < 20_000
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for a, b in zip(state_t, state_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)
    assert float(gapt) <= tol
