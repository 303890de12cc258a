"""Routes of the inputs the port's kernels do not take, on the CPU.

A stencil of more than 16 shift families, or more than 32 labels, runs the
plain routes under the default ``fused="auto"`` and ``chain="auto"``, as
the JAX package does (``StencilGraphD1.supports_fused``,
``CirculantGraphD1.supports_fused_simplex``, ``_stencil_fusable``);
``fused="on"`` raises.  The route functions read only ``is_cuda`` (and the
dtype and shape) of the tensor they are given, so a stand-in flagged as a
CUDA tensor shows the card's route here.  The solves on those inputs are
held against the JAX package in float64 at the PFDR parity tests' 1e-10
(quadratic) and 1e-12 (multi-label).  ``BandedGraphD1`` sends only float
[V] / [V, K] fields to its transfer kernels.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import \
    pfdr_loss_d1_simplex as jpfdr_simplex
from cp_pfdr_graph_d1_tpu_torch import banded_graph, convert
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_device as cpd
from cp_pfdr_graph_d1_tpu_torch.solvers import \
    cut_pursuit_simplex_device as cpsd
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_chain import \
    chain_admissible
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import fused_route
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_simplex import \
    fused_simplex_route

torch.set_num_threads(1)

# 17 shift families: one more than the stencil kernels take
SHIFTS_17 = ((0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0), (2, 1),
             (1, 2), (2, -1), (1, -2), (2, 2), (2, -2), (0, 3), (3, 0),
             (3, 1), (1, 3), (3, -1))


class CudaLike:
    """Stand-in for a CUDA tensor: the route functions read ``is_cuda``,
    ``dtype`` and ``shape``."""
    is_cuda = True

    def __init__(self, shape=(1,), dtype=torch.float32):
        self.shape = shape
        self.dtype = dtype


def stencils(shifts, h=8, w=9, seed=0):
    """The same stencil in both packages, float64, random weights."""
    r = np.random.default_rng(seed)
    weights = {s: r.uniform(0.05, 0.3, (h, w)) for s in shifts}
    jsg = J.StencilGraphD1.create((h, w), weights, dtype=jnp.float64)
    tsg = convert.stencil_graph(np.asarray(jsg.la_d1), jsg.field_shape,
                                jsg.shifts, jsg.wrap, device="cpu")
    return jsg, tsg


def test_admission_properties():
    _, g2 = stencils(((0, 1), (1, 0)))
    _, g17 = stencils(SHIFTS_17)
    assert g2.supports_fused and not g17.supports_fused
    assert g2.supports_fused_simplex(32) and not g2.supports_fused_simplex(33)
    assert not g17.supports_fused_simplex(4)
    eu = np.tile(np.arange(48), 2)
    ev = eu + np.repeat([1, 2], 48)
    cg = T.CirculantGraphD1.create(eu, ev, 0.1, num_vertices=50,
                                   dtype=torch.float64, device="cpu")
    assert cg.supports_fused_simplex(32) and not cg.supports_fused_simplex(33)


def test_route_functions_on_the_card():
    """``fused="auto"`` / ``chain="auto"`` on a CUDA stand-in: the kernel
    route for what the kernels take, the plain route for F = 17 and
    K = 33; ``fused="on"`` raises on those."""
    _, g2 = stencils(((0, 1), (1, 0)))
    _, g17 = stencils(SHIFTS_17)
    auto, on = T.PFDROptions(), T.PFDROptions(fused="on")
    obs = CudaLike()
    assert fused_route(auto, g2, obs)
    assert not fused_route(auto, g17, obs)
    with pytest.raises(ValueError, match="17 shift families"):
        fused_route(on, g17, obs)
    q4, q33 = CudaLike((72, 4)), CudaLike((72, 33))
    assert fused_simplex_route(auto, g2, q4)
    assert not fused_simplex_route(auto, g2, q33)
    assert not fused_simplex_route(auto, g17, q4)
    for g, q in ((g2, q33), (g17, q4)):
        with pytest.raises(ValueError, match="labels"):
            fused_simplex_route(on, g, q)
    op = T.DenseOp(torch.zeros(2, 72))
    opt = T.CPOptions(cut="device")
    assert chain_admissible(op, g2, opt, False, False, obs)
    assert not chain_admissible(op, g17, opt, False, False, obs)
    assert chain_admissible(op, g17, dataclasses.replace(opt, chain="on"),
                            False, False, obs)


def test_device_cut_and_components_routes(monkeypatch):
    """``_device_cut``, ``_device_components`` and the multi-label
    ``_device_side`` take the stencil kernels' wrappers only where the
    kernels take the stencil; F = 17 runs the plain loops."""
    calls = []

    def recorder(name, fn):
        def rec(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return rec

    monkeypatch.setattr(cpd, "device_cut_stencil_fused",
                        recorder("cut", cpd.device_cut_stencil_fused))
    monkeypatch.setattr(cpd, "device_components_stencil_fused",
                        recorder("comp", cpd.device_components_stencil_fused))
    monkeypatch.setattr(cpsd, "fused_pdhg_min_cut",
                        recorder("side", cpsd.fused_pdhg_min_cut))
    for shifts, kernels in ((((0, 1), (1, 0)), True), (SHIFTS_17, False)):
        _, g = stencils(shifts)
        v, e = g.num_vertices, g.num_edges
        r = np.random.default_rng(2)
        active = torch.from_numpy(r.random(e) < 0.2)
        c = torch.from_numpy(r.normal(size=v))
        calls.clear()
        sep, gap, big, _, _ = cpd._device_cut(g, active, c, 1e-6, 2000, 250)
        cv, num_comp, _ = cpd._device_components(g, active)
        w = torch.where(active, 0.0, g.la_d1)
        side, *_ = cpsd._device_side(g, w, c, 1e-6, 2000, 250)
        assert calls == (["cut", "comp", "side"] if kernels else [])
        assert float(gap) <= 1e-6 * float(big)
        assert sep.shape == (e,) and side.shape == (v,)
        # the component count is the host's
        eu, ev, la = g.host_coo()
        keep = ~active.numpy() & (la > 0)
        n, _ = connected_components(sp.coo_matrix(
            (np.ones(keep.sum()), (eu[keep], ev[keep])), shape=(v, v)),
            directed=False)
        assert int(num_comp) == n and int(cv.max()) == n - 1


def test_pfdr_17_families_matches_jax():
    """PFDR on a 17-family stencil, CPU tensors, the default options."""
    jsg, tsg = stencils(SHIFTS_17, seed=3)
    v = tsg.num_vertices
    r = np.random.default_rng(4)
    a = r.normal(size=(16, v)) / 4.0
    y = a @ np.where(r.random(v) > 0.6, 1.0, 0.0) + 0.01 * r.normal(size=16)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    opt = dict(rho=1.3, dif_tol=1e-9, it_max=800)
    vprox = dict(kind="l1", positivity=True)
    res_j = J.pfdr_quadratic_d1(
        J.DenseOp(jnp.asarray(a)), jnp.asarray(y), jsg,
        la_l1=jnp.full((v,), 0.05), vprox=J.VertexProx(**vprox), lipsch=lip,
        opt=J.PFDROptions(**opt))
    res_t = T.pfdr_quadratic_d1(
        T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y), tsg,
        la_l1=torch.full((v,), 0.05, dtype=torch.float64),
        vprox=T.VertexProx(**vprox), lipsch=lip, opt=T.PFDROptions(**opt))
    assert res_t.it == int(res_j.it)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=1e-10)


def test_pfdr_simplex_33_labels_matches_jax():
    """K = 33 multi-label PFDR on a stencil, CPU tensors, the default
    options (the JAX package's staged loop: its kernel takes no K = 33
    either)."""
    jsg, tsg = stencils(((0, 1), (1, 0)), h=6, w=5, seed=5)
    r = np.random.default_rng(6)
    q = r.dirichlet(np.full(33, 0.5), size=tsg.num_vertices)
    opt = dict(rho=1.3, dif_tol=1e-9, it_max=150)
    rj = jpfdr_simplex(jsg, jnp.asarray(q), al=1.0, opt=J.PFDROptions(**opt))
    rt = T.pfdr_loss_d1_simplex(tsg, torch.from_numpy(q), al=1.0,
                                opt=T.PFDROptions(**opt))
    assert rt.it == int(rj.it)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=0,
                               atol=1e-12)


def test_banded_transfers_dispatch(monkeypatch):
    """On the kernel route (mode "auto"), a ``BandedGraphD1`` sends float
    [V] / [V, K] fields to ``banded_gather`` / ``banded_scatter`` and the
    bool [V, T] sides, int64 labels and [V, 2, T] fields to the plain index
    gather, which the kernels do not take."""
    seen = []

    def recorder(name, fn):
        def rec(graph, *args):
            seen.append((name, args[0].dtype, args[0].ndim))
            return fn(graph, *args)
        return rec

    monkeypatch.setattr(banded_graph, "banded_gather", recorder(
        "gather", banded_graph.banded_gather_plain))
    monkeypatch.setattr(banded_graph, "banded_scatter", recorder(
        "scatter", banded_graph.banded_scatter_plain))
    r = np.random.default_rng(7)
    v, e = 40, 90
    eu = r.integers(0, v, e)
    ev = (eu + 1 + r.integers(0, v - 1, e)) % v
    g = T.BandedGraphD1.create(eu, ev, r.uniform(0.1, 1.0, e),
                               num_vertices=v, dtype=torch.float64,
                               tile=128, device="cpu")
    ref = T.GraphD1.create(*g.host_coo(), num_vertices=v,
                           dtype=torch.float64, device="cpu")
    plain = [torch.from_numpy(r.random((v, 15)) > 0.5),
             torch.arange(v, dtype=torch.int64),
             torch.from_numpy(r.random((v, 2, 15)))]
    for x in plain:
        for a, b in zip(g.gather_endpoints(x), ref.gather_endpoints(x)):
            assert torch.equal(a, b)
    assert seen == []
    x = torch.from_numpy(r.random(v))
    for a, b in zip(g.gather_endpoints(x), ref.gather_endpoints(x)):
        assert torch.equal(a, b)
    vals = torch.from_numpy(r.random((g.num_edges, 2)))
    torch.testing.assert_close(g.edge_to_vertex_sum(vals, -vals),
                               ref.edge_to_vertex_sum(vals, -vals),
                               rtol=0, atol=1e-14)
    assert seen == [("gather", torch.float64, 1),
                    ("scatter", torch.float64, 2)]
