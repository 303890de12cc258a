"""Port's PDHG min-cut against the JAX package, on the CPU in float64.

``maxflow/device._pdhg_min_cut`` (the plain loop on any container) and the
plain version of the ``mincut_fused`` kernel are held against the JAX
package's ``_pdhg_min_cut`` and its Pallas kernel in interpret mode, on
12 x 16 fields with ``check_every = 50``: equal step counts and thresholds,
iterates at 1e-10 (the two differ only in summation order).  The
certified-with-fallback entry is held against the host push-relabel by
cut value, since a non-unique min-cut may put vertices on either side.
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
from cp_pfdr_graph_d1_tpu_torch import GraphD1, StencilGraphD1, maxflow
from cp_pfdr_graph_d1_tpu_torch.maxflow import device as tdev
from cp_pfdr_graph_d1_tpu_torch.ops import mincut_fused as tmf

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
