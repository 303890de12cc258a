"""Port's device connected components against the JAX package and scipy.

The plain version of the ``components_fused`` kernel (CPU tensors) and the
generic propagation of ``ops/components`` must give the labels of the JAX
package's Pallas kernel (interpret mode, 12 x 16 fields), of its generic
device components and of scipy bit for bit: the fixpoint is unique.  The
48 x 48, 45 %-active snake case is the regression of
``tests/test_cut_pursuit_chain.py`` (a round cap below V under-converged).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu.ops import components as jcomp
from cp_pfdr_graph_d1_tpu.ops import components_fused as jcf
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_device import \
    _device_components as jax_device_components
from cp_pfdr_graph_d1_tpu.graph import GraphD1 as JGraph
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1 as JStencil
from cp_pfdr_graph_d1_tpu_torch import GraphD1, StencilGraphD1
from cp_pfdr_graph_d1_tpu_torch.ops import components as tcomp
from cp_pfdr_graph_d1_tpu_torch.ops import components_fused as tcf
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import \
    connected_components
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_device import \
    _device_components

torch.set_num_threads(1)


def stencil_pair(h, w, shifts=((0, 1), (1, 0))):
    weights = {s: 0.3 for s in shifts}
    return (JStencil.create((h, w), weights, dtype=jnp.float64),
            StencilGraphD1.create((h, w), weights, dtype=torch.float64,
                                  device="cpu"))


def scipy_roots(g, mask):
    """Smallest vertex of each vertex's component, from scipy."""
    eu, ev, _ = g.host_coo()
    n, cv = connected_components(g.num_vertices, eu, ev, mask)
    first = np.full(n, g.num_vertices)
    np.minimum.at(first, cv, np.arange(g.num_vertices))
    return first[cv], n, cv


@pytest.mark.parametrize("frac,shifts", [
    (0.1, ((0, 1), (1, 0))), (0.45, ((0, 1), (1, 0))),
    (0.45, ((0, 1), (1, 0), (1, 1), (1, -1)))])
def test_plain_kernel_matches_pallas_kernel_and_scipy(frac, shifts):
    gj, gt = stencil_pair(12, 16, shifts)
    r = np.random.default_rng(int(frac * 100) + len(shifts))
    mask = (r.random(gt.num_edges) >= frac) & (gt.host_coo()[2] > 0)
    want, _, _ = scipy_roots(gt, mask)
    got_j = np.asarray(jcf.stencil_components_fused(
        gj, jnp.asarray(mask), interpret=True))
    got_t = tcf.stencil_components_fused(gt, torch.from_numpy(mask))
    np.testing.assert_array_equal(got_j, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(
        tcomp.connected_components_device(gt, torch.from_numpy(mask)).numpy(),
        want)


def test_snake_components_converge():
    """48 x 48 at 45 % active edges: the stencil kernel's plain version and
    the generic propagation on the COO view (zero-weight slots dropped)
    both reach scipy's labelling and component count."""
    side = 48
    _, gt = stencil_pair(side, side)
    act = np.random.default_rng(5).random(gt.num_edges) < 0.45
    eu, ev, la = gt.host_coo()
    _, nc_true, cv_true = scipy_roots(gt, ~act & (la > 0))
    cvf, ncf, _ = _device_components(gt, torch.from_numpy(act))
    assert int(ncf) == nc_true
    np.testing.assert_array_equal(cvf.numpy(), cv_true)
    keep = la > 0
    gc = GraphD1.create(eu[keep], ev[keep], la[keep], num_vertices=side**2,
                        dtype=torch.float64, device="cpu")
    cvg, ncg, _ = _device_components(gc, torch.from_numpy(act[keep]))
    assert int(ncg) == nc_true
    np.testing.assert_array_equal(cvg.numpy(), cv_true)


def test_compact_labels_match_jax():
    _, gt = stencil_pair(12, 16)
    act = np.random.default_rng(2).random(gt.num_edges) < 0.3
    roots, _, _ = scipy_roots(gt, ~act & (gt.host_coo()[2] > 0))
    cv_j, n_j, f_j = jcf.compact_labels_device(jnp.asarray(roots,
                                                           jnp.int32))
    cv_t, n_t, f_t = tcf.compact_labels_device(torch.from_numpy(roots))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert int(n_t) == int(n_j)
    n_h, cv_h = tcomp.compact_labels(roots)
    n_jh, cv_jh = jcomp.compact_labels(roots)
    assert n_h == n_jh == int(n_t)
    np.testing.assert_array_equal(cv_h, cv_jh)


def test_coo_device_components_match_jax():
    """Generic route (incidence min-reduction + pointer jumping) on a
    random COO graph with a hub vertex, against the JAX package's."""
    r = np.random.default_rng(4)
    v = 120
    eu = np.concatenate([r.integers(0, v, 150), np.zeros(60, int)])
    ev = np.concatenate([r.integers(0, v, 150), r.integers(1, v, 60)])
    la = r.uniform(0.1, 1.0, eu.shape[0])
    la[::17] = 0.0
    act = r.random(eu.shape[0]) < 0.5
    gj = JGraph.create(eu, ev, la, num_vertices=v, dtype=jnp.float64)
    gt = GraphD1.create(eu, ev, la, num_vertices=v, dtype=torch.float64,
                        device="cpu")
    cv_j, n_j, f_j = jax_device_components(gj, jnp.asarray(act))
    cv_t, n_t, f_t = _device_components(gt, torch.from_numpy(act))
    assert int(n_t) == int(n_j)
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


def test_hub_graph_transfers_match_numpy():
    """A hub vertex makes the incidence table wide (one row per vertex, as
    long as the hub's degree); the edge -> vertex sum and minimum over it
    match numpy's."""
    r = np.random.default_rng(6)
    v = 3000
    eu = np.concatenate([np.zeros(2000, int), r.integers(0, v, 500)])
    ev = np.concatenate([np.arange(1, 2001), r.integers(0, v, 500)])
    g = GraphD1.create(eu, ev, r.random(eu.shape[0]), num_vertices=v,
                       dtype=torch.float64, device="cpu")
    assert tuple(g.incidence.shape) == (v, np.bincount(np.r_[eu, ev]).max())
    a, b = r.random(eu.shape[0]), r.random(eu.shape[0])
    want = np.zeros(v)
    np.add.at(want, eu, a)
    np.add.at(want, ev, b)
    got = g.edge_to_vertex_sum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    ia, ib = r.integers(0, 10 * v, (2, eu.shape[0]))
    want = np.full(v, 7 * v)
    np.minimum.at(want, eu, ia)
    np.minimum.at(want, ev, ib)
    got = g.edge_to_vertex_min(torch.from_numpy(ia), torch.from_numpy(ib),
                               7 * v)
    np.testing.assert_array_equal(got.numpy(), want)
