"""Port's ``api`` entries and the slice as a whole against the JAX package,
on the CPU in float64; import hygiene, launch counters and routing.

Solutions are compared at 1e-6 (cut-pursuit) and 1e-10 (PFDR), as in
``tests/test_torch_cut_pursuit.py`` and ``tests/test_torch_pfdr_quadratic.py``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu import api as japi
from cp_pfdr_graph_d1_tpu_torch import api as tapi
from cp_pfdr_graph_d1_tpu_torch.ops import solve_small, stencil_fused

torch.set_num_threads(1)

H, W, N = 9, 8, 14
CP_KW = dict(CP_difTol=1e-4, CP_itMax=3, PFDR_rho=1.5, PFDR_difTol=1e-6,
             PFDR_itMax=800)
PFDR_KW = dict(PFDR_rho=1.4, PFDR_difTol=1e-9, PFDR_itMax=600)


def grid_problem(seed=0):
    r = np.random.default_rng(seed)
    idx = np.arange(H * W).reshape(H, W)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    la = np.full(eu.shape, 0.04)
    a = r.normal(size=(N, H * W)) / 4.0
    x_true = np.zeros((H, W))
    x_true[1:5, 2:6] = 1.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=N)
    return eu.astype(np.int32), ev.astype(np.int32), la, a, y


def cp_args(entry, eu, ev, la, a, y):
    """Positional and keyword arguments of one cut-pursuit entry."""
    v = a.shape[1]
    l1 = dict(La_l1=np.full(v, 0.01), positivity=True)
    box = dict(m=0.0, M=0.9)
    return {
        "cp_quadratic_d1_l1": ((y, a, eu, ev, la), l1),
        "cp_quadratic_d1_l1_AtA": ((a.T @ y, a.T @ a, eu, ev, la), l1),
        "cp_l22_d1_l1": ((a[0] * 4, np.full(v, 0.7), eu, ev, la),
                         dict(La_l1=np.full(v, 0.01), monitor=True)),
        "cp_quadratic_d1_bounds": ((y, a, eu, ev, la), box),
        "cp_quadratic_d1_bounds_AtA": ((a.T @ y, a.T @ a, eu, ev, la), box),
        "cp_l22_d1_bounds": ((a[0] * 4, None, eu, ev, la), box),
    }[entry]


@pytest.mark.parametrize("entry", [
    "cp_quadratic_d1_l1", "cp_quadratic_d1_l1_AtA", "cp_l22_d1_l1",
    "cp_quadratic_d1_bounds", "cp_quadratic_d1_bounds_AtA",
    "cp_l22_d1_bounds"])
def test_cp_entries_match_jax(entry):
    args, kw = cp_args(entry, *grid_problem())
    out_j = getattr(japi, entry)(*args, **kw, **CP_KW)
    out_t = getattr(tapi, entry)(*args, **kw, **CP_KW, device="cpu")
    np.testing.assert_allclose(out_t.rX[out_t.Cv], out_j.rX[out_j.Cv],
                               rtol=0, atol=1e-6)
    assert out_t.it == out_j.it
    if kw.get("monitor"):
        np.testing.assert_allclose(out_t.Obj, out_j.Obj, rtol=1e-9)


@pytest.mark.parametrize("entry", [
    "pfdr_quadratic_d1_l1", "pfdr_quadratic_d1_l1_AtA", "pfdr_l22_d1_l1",
    "pfdr_quadratic_d1_bounds", "pfdr_quadratic_d1_bounds_AtA",
    "pfdr_l22_d1_bounds"])
def test_pfdr_entries_match_jax(entry):
    eu, ev, la, a, y = grid_problem(seed=1)
    v = a.shape[1]
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    if entry.endswith("_AtA"):
        data = (a.T @ y, a.T @ a)
    elif entry.startswith("pfdr_l22"):
        data = (a[0] * 4, np.full(v, 0.7))
    else:
        data = (y, a)
    kw = (dict(La_l1=np.full(v, 0.02)) if "_d1_l1" in entry
          else dict(m=-0.1, M=0.9))
    kw["L"] = None if entry.startswith("pfdr_l22") else lip
    args = data + (eu, ev, la)
    out_j = getattr(japi, entry)(*args, **kw, **PFDR_KW, monitor=True,
                                 container="coo")
    out_t = getattr(tapi, entry)(*args, **kw, **PFDR_KW, monitor=True,
                                 device="cpu")
    assert out_t.it == out_j.it
    np.testing.assert_allclose(out_t.X.numpy(), out_j.X, rtol=0, atol=1e-10)
    np.testing.assert_allclose(out_t.Obj.numpy(), out_j.Obj, rtol=1e-10)


def test_boost_binding_matches_jax():
    eu, ev, la, a, y = grid_problem(seed=2)
    kw = dict(l1_weight=0.01, positivity=1, CP_difTol=1e-4, CP_itMax=3,
              PFDR_rho=1.5, PFDR_difTol=1e-6, PFDR_itMax=800)
    for A, obs in ((a, y), (np.full(H * W, 0.8), a[0] * 4)):
        cv_j, rx_j = japi.CP_quadratic_l1(obs, eu, ev, la, A, **kw)
        cv_t, rx_t = tapi.CP_quadratic_l1(obs, eu, ev, la, A, **kw,
                                          device="cpu")
        np.testing.assert_allclose(rx_t[cv_t], rx_j[cv_j], rtol=0,
                                   atol=1e-6)


def test_slice_end_to_end_on_stencil():
    """The slice's main path: ``api.cp_quadratic_d1_l1`` on a stencil graph
    (the EEG workload's shape, reduced) and full-graph PFDR on the same
    stencil, against the JAX package; CPU tensors launch no kernel."""
    eu, ev, la, a, y = grid_problem(seed=3)
    v = a.shape[1]
    weights = {(0, 1): 0.04, (1, 0): 0.04}
    jsg = J.StencilGraphD1.create((H, W), weights, dtype=jnp.float64)
    tsg = T.StencilGraphD1.create((H, W), weights, dtype=torch.float64,
                                  device="cpu")
    launches = (stencil_fused.fused_stencil_iteration.launches,
                solve_small.fused_pfdr_solve_small.launches)
    kw = dict(La_l1=np.full(v, 0.01), positivity=True, **CP_KW)
    out_j = japi.cp_quadratic_d1_l1(y, a, None, None, None, graph=jsg, **kw)
    out_t = tapi.cp_quadratic_d1_l1(y, a, None, None, None, graph=tsg, **kw,
                                    device="cpu")
    np.testing.assert_allclose(out_t.rX[out_t.Cv], out_j.rX[out_j.Cv],
                               rtol=0, atol=1e-6)
    assert len(out_t.rX) > 1

    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    pj = J.pfdr_quadratic_d1(
        J.DenseOp(jnp.asarray(a)), jnp.asarray(y), jsg,
        la_l1=jnp.full((v,), 0.01),
        vprox=J.VertexProx(kind="l1", positivity=True), lipsch=lip,
        opt=J.PFDROptions(rho=1.5, dif_tol=1e-9, it_max=500, fused="off"))
    results = []
    for fused in ("auto", "on"):
        pt = T.pfdr_quadratic_d1(
            T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y), tsg,
            la_l1=torch.full((v,), 0.01, dtype=torch.float64),
            vprox=T.VertexProx(kind="l1", positivity=True), lipsch=lip,
            opt=T.PFDROptions(rho=1.5, dif_tol=1e-9, it_max=500,
                              fused=fused))
        assert pt.it == int(pj.it)
        np.testing.assert_allclose(pt.x.numpy(), np.asarray(pj.x), rtol=0,
                                   atol=1e-10)
        results.append(pt.x)
    # fused="auto" on CPU tensors runs the staged loop, "on" the kernel's
    # plain version: the same iterates
    np.testing.assert_allclose(results[0].numpy(), results[1].numpy(),
                               rtol=0, atol=1e-12)
    assert (stencil_fused.fused_stencil_iteration.launches,
            solve_small.fused_pfdr_solve_small.launches) == launches


def test_import_leaves_jax_out():
    port = "cp_pfdr_graph_d1_tpu_torch"
    modules = ["api", "convert", "solvers.cut_pursuit_simplex_device",
               "banded_graph", "circulant", "ops.banded", "ops.banded_fused",
               "ops.circulant_fused", "ops.circulant_fused_simplex"]
    code = (f"import sys, {port}, "
            + ", ".join(f"{port}.{m}" for m in modules)
            + "; print('jax' in sys.modules, "
              "'cp_pfdr_graph_d1_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=root)
    assert out.stdout.strip() == "False False"


def test_build_sources_lie_in_the_port(monkeypatch):
    """Every source the port compiles (the CUDA kernels and the host C++ of
    the min-cut and native PFDR libraries) lies inside
    ``cp_pfdr_graph_d1_tpu_torch/``: the port builds nothing of the JAX
    package."""
    from unittest import mock

    from cp_pfdr_graph_d1_tpu_torch import _build, maxflow, native
    built = []

    def record(name, sources, cmd, headers=()):
        built.extend(list(sources) + list(headers))
        return mock.MagicMock()

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_load", record)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_unavailable", False)
    monkeypatch.setattr(maxflow, "_lib", None)
    monkeypatch.setattr(maxflow, "_use_fallback", False)
    _build.cuda_kernels()
    native._get_lib()
    maxflow._get_lib()
    port = _build.PKG_DIR.resolve()
    names = {p.name for p in built}
    assert {"stencil_fused_simplex.cu", "banded.cu", "banded_fused.cu",
            "circulant_fused.cu", "circulant_fused_simplex.cu", "pfdr.cpp",
            "pfdr_simplex.cpp", "mincut.cpp"} <= names
    outside = [str(p) for p in built
               if not p.resolve().is_relative_to(port) or not p.exists()]
    assert not outside, f"sources outside the port: {outside}"


def test_unported_routes_raise():
    """The routes that once raised for want of a port now solve: the duplex
    device cut (its objective within 5e-7 relative of the JAX duplex
    device loop's, float64) and the circulant container."""
    assert T.CPOptions(cut="device", chain="on").chain == "on"
    eu, ev, la, a, y = grid_problem(3)
    la_l1 = np.full(H * W, 0.02)
    pf = dict(rho=1.5, dif_tol=1e-8, it_max=3000)
    res_j = J.solvers.cut_pursuit.cp_quadratic_d1(
        J.DenseOp(jnp.asarray(a)), jnp.asarray(y),
        J.GraphD1.create(eu, ev, la, num_vertices=H * W, dtype=jnp.float64),
        la_l1=la_l1, duplex=True,
        opt=J.CPOptions(dif_tol=1e-5, it_max=8, cut="device",
                        pfdr=J.PFDROptions(**pf)))
    res_t = T.solvers.cut_pursuit.cp_quadratic_d1(
        T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y),
        T.GraphD1.create(eu, ev, la, num_vertices=H * W,
                         dtype=torch.float64, device="cpu"),
        la_l1=la_l1, duplex=True,
        opt=T.CPOptions(dif_tol=1e-5, it_max=8, cut="device",
                        pfdr=T.PFDROptions(**pf)))

    def obj(res):
        x = np.asarray(res.rx)[np.asarray(res.cv)]
        return (0.5 * np.sum((a @ x - y) ** 2)
                + np.sum(la * np.abs(x[eu] - x[ev]))
                + np.sum(la_l1 * np.abs(x)))

    assert res_t.it == res_j.it
    assert abs(obj(res_t) - obj(res_j)) <= 5e-7 * abs(obj(res_j))
    out = tapi.pfdr_quadratic_d1_l1(np.ones(2), np.ones((2, 3)), [0], [1],
                                    [1.0], container="circulant",
                                    device="cpu")
    assert out.X.shape == (3,) and bool(torch.isfinite(out.X).all())
