"""Port's ``utils``: checkpoint round trips and resumes, and the monitor.

The counterparts of ``tests/test_utils.py``, on the CPU in float64 (the two
kernel-loop resumes in float32, as there, on the kernels' plain versions),
and one test across packages: an ``.npz`` state the JAX package saves
loads into the port, and the port's resume equals the JAX resume.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import \
    cp_quadratic_d1 as jax_cp
from cp_pfdr_graph_d1_tpu.utils import save_state as jax_save_state
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import cp_quadratic_d1
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_simplex import (
    CPSimplexState, cp_loss_d1_simplex)
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import PFDRSolveState
from cp_pfdr_graph_d1_tpu_torch.utils import (SolveTrace, load_state,
                                              profile, save_state)

from .conftest import make_grid_graph

torch.set_num_threads(1)


def grid(h, w, seed, weight, dtype=torch.float64):
    eu, ev, la = make_grid_graph(h, w, seed=seed)
    return T.GraphD1.create(eu, ev, weight * la, dtype=dtype, device="cpu")


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_checkpoint_roundtrip_and_resume(tmp_path):
    g = grid(6, 6, 0, 0.2)
    v = 36
    r = np.random.default_rng(0)
    a = r.normal(size=(20, v)) / 4
    x_true = np.zeros((6, 6))
    x_true[1:4, 1:4] = 1.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=20)
    opt = T.CPOptions(dif_tol=1e-5, it_max=6,
                      pfdr=T.PFDROptions(dif_tol=1e-8, it_max=5000))
    la_l1 = np.full(v, 0.02)

    res = cp_quadratic_d1(T.DenseOp(t(a)), t(y), g, la_l1=la_l1, opt=opt)
    path = tmp_path / "state.npz"
    save_state(path, res.state)
    state = load_state(path)
    np.testing.assert_array_equal(state.cv, res.state.cv)
    np.testing.assert_array_equal(state.active, res.state.active)

    # resume on slightly perturbed data: the warm path may settle on another
    # (equally valid) partition, so compare objective and iteration count
    y2 = y + 0.01 * r.normal(size=20)
    warm = cp_quadratic_d1(T.DenseOp(t(a)), t(y2), g, la_l1=la_l1, opt=opt,
                           state=state, monitor=True)
    cold = cp_quadratic_d1(T.DenseOp(t(a)), t(y2), g, la_l1=la_l1, opt=opt,
                           monitor=True)
    assert warm.obj[-1] <= cold.obj[-1] * 1.01 + 1e-9
    assert warm.it <= cold.it


def test_checkpoint_simplex_roundtrip(tmp_path):
    g = grid(6, 6, 1, 0.2)
    r = np.random.default_rng(2)
    q = np.abs(r.normal(size=(36, 3))) + 0.1
    q /= q.sum(1, keepdims=True)
    res = cp_loss_d1_simplex(g, t(q), al=1.0,
                             opt=T.CPOptions(dif_tol=1e-4, it_max=4))
    path = tmp_path / "sstate.npz"
    save_state(path, res.state)
    state = load_state(path)
    assert isinstance(state, CPSimplexState)
    np.testing.assert_array_equal(state.rp, res.state.rp)


def test_pfdr_state_kill_resume_reproduces_trajectory(tmp_path):
    """A PFDR solve stopped mid-way, saved, loaded and resumed reproduces
    the uninterrupted trajectory exactly, reconditioning decay included."""
    r = np.random.default_rng(31)
    h = w = 12
    v, n = h * w, 20
    graph = grid(h, w, 32, 0.2)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    y = a @ r.normal(size=v) * 0.5
    lip = float(np.linalg.eigvalsh(a @ a.T)[-1])
    kw = dict(la_l1=torch.full((v,), 0.03, dtype=torch.float64),
              vprox=T.VertexProx(kind="l1"), lipsch=lip)
    op, obs = T.DenseOp(t(a)), t(y)

    def opts(it_max):
        return T.PFDROptions(rho=1.4, dif_rcd=1e-2, dif_tol=0.0,
                             it_max=it_max)

    full, full_state = T.pfdr_quadratic_d1(op, obs, graph, opt=opts(200),
                                           return_state=True, **kw)
    _, mid = T.pfdr_quadratic_d1(op, obs, graph, opt=opts(80),
                                 return_state=True, **kw)
    path = tmp_path / "pfdr.npz"
    save_state(path, mid)
    loaded = load_state(path, device="cpu")
    assert isinstance(loaded, PFDRSolveState)
    assert loaded.it == 80
    res, res_state = T.pfdr_quadratic_d1(op, obs, graph, opt=opts(200),
                                         state0=loaded, return_state=True,
                                         **kw)
    assert res.it == full.it == 200
    assert torch.equal(res.x, full.x)
    assert torch.equal(res_state.zu, full_state.zu)
    assert torch.equal(res_state.dif_rcd2, full_state.dif_rcd2)


def test_simplex_inner_state_kill_resume(tmp_path):
    """A 40-iteration multi-label solve split 15 + 25 through an ``.npz``
    checkpoint reproduces the uninterrupted trajectory."""
    g = grid(8, 8, 4, 0.4)
    v, k = 64, 4
    q = t(np.random.default_rng(9).dirichlet(np.full(k, 0.6), size=v))
    full = T.pfdr_loss_d1_simplex(
        g, q, al=1.0, opt=T.PFDROptions(rho=1.3, dif_tol=0.0, it_max=40))
    _, st = T.pfdr_loss_d1_simplex(
        g, q, al=1.0, opt=T.PFDROptions(rho=1.3, dif_tol=0.0, it_max=15),
        return_state=True)
    path = tmp_path / "simplex_inner.npz"
    save_state(path, st)
    st2 = load_state(path, device="cpu")
    assert st2.it == 15
    res2 = T.pfdr_loss_d1_simplex(
        g, q, al=1.0, opt=T.PFDROptions(rho=1.3, dif_tol=0.0, it_max=40),
        state0=st2)
    assert res2.it == 40
    np.testing.assert_allclose(res2.p.numpy(), full.p.numpy(), rtol=0,
                               atol=1e-14)


def test_whole_solve_kernel_resume_exact():
    """A whole-solve run (``solve_fused``'s plain version for CPU tensors)
    resumes from its state inside the whole solve and reproduces the
    uninterrupted trajectory bit for bit."""
    r = np.random.default_rng(0)
    h = w = 24
    v, n = h * w, 16
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    a = (r.standard_normal((n, v)) / np.sqrt(n)).astype(np.float32)
    y = r.standard_normal(n).astype(np.float32)
    bg = T.BandedGraphD1.create(eu, ev, np.full(eu.shape, 0.05, np.float32),
                                num_vertices=v, dtype=torch.float32,
                                device="cpu")
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    kw = dict(la_l1=torch.full((v,), 0.02),
              vprox=T.VertexProx(kind="l1", positivity=True), lipsch=lip)
    op = T.DenseOp(t(a))

    def opt(it_max):
        return T.PFDROptions(rho=1.5, dif_tol=0.0, it_max=it_max, fused="on")

    full = T.pfdr_quadratic_d1(op, t(y), bg, opt=opt(200), **kw)
    _, st = T.pfdr_quadratic_d1(op, t(y), bg, opt=opt(80), return_state=True,
                                **kw)
    rest = T.pfdr_quadratic_d1(op, t(y), bg, opt=opt(200), state0=st, **kw)
    assert rest.it == full.it == 200
    assert torch.equal(rest.x, full.x)


def test_simplex_fused_resume_exact():
    """The same contract for the multi-label kernel loop on a stencil
    (``stencil_fused_simplex``'s plain version for CPU tensors)."""
    r = np.random.default_rng(1)
    h = w = 24
    sg = T.StencilGraphD1.create((h, w), {(0, 1): 0.3, (1, 0): 0.3},
                                 dtype=torch.float32, device="cpu")
    q = t(r.dirichlet(np.full(4, 0.7), size=h * w).astype(np.float32))

    def opt(it_max):
        return T.PFDROptions(rho=1.5, dif_tol=0.0, it_max=it_max, fused="on")

    full = T.pfdr_loss_d1_simplex(sg, q, al=1.0, opt=opt(120))
    _, st = T.pfdr_loss_d1_simplex(sg, q, al=1.0, opt=opt(50),
                                   return_state=True)
    rest = T.pfdr_loss_d1_simplex(sg, q, al=1.0, opt=opt(120), state0=st)
    assert rest.it == full.it == 120
    assert torch.equal(rest.p, full.p)


def test_jax_checkpoints_resume_in_the_port(tmp_path):
    """The JAX package saves a ``PFDRSolveState`` (a stencil solve stopped
    at iteration 60) and a ``CPState``; the port loads both files, and its
    resumes equal the JAX resumes within 1e-12."""
    h, w, n = 10, 9, 18
    v = h * w
    r = np.random.default_rng(12)
    weights = {(0, 1): r.uniform(0.1, 0.4, (h, w)),
               (1, 0): r.uniform(0.1, 0.4, (h, w))}
    a = r.normal(size=(n, v)) / np.sqrt(n)
    y = a @ np.where(r.random(v) > 0.7, 1.0, 0.0) + 0.01 * r.normal(size=n)
    lip = float(np.linalg.eigvalsh(a @ a.T)[-1])
    jsg = J.StencilGraphD1.create((h, w), weights, dtype=jnp.float64)
    tsg = T.StencilGraphD1.create((h, w), weights, dtype=torch.float64,
                                  device="cpu")
    la_l1 = np.full(v, 0.03)

    def popt(pkg, it_max):
        return pkg.PFDROptions(rho=1.4, dif_rcd=1e-2, dif_tol=0.0,
                               it_max=it_max, fused="off")

    jkw = dict(la_l1=jnp.asarray(la_l1), lipsch=lip,
               vprox=J.VertexProx(kind="l1", positivity=True))
    _, mid = J.pfdr_quadratic_d1(J.DenseOp(jnp.asarray(a)), jnp.asarray(y),
                                 jsg, opt=popt(J, 60), return_state=True,
                                 **jkw)
    jax_save_state(tmp_path / "pfdr.npz", jax.device_get(mid))
    res_j = J.pfdr_quadratic_d1(J.DenseOp(jnp.asarray(a)), jnp.asarray(y),
                                jsg, opt=popt(J, 150), state0=mid, **jkw)
    loaded = load_state(tmp_path / "pfdr.npz", device="cpu")
    assert isinstance(loaded, PFDRSolveState) and loaded.it == 60
    res_t = T.pfdr_quadratic_d1(
        T.DenseOp(t(a)), t(y), tsg, opt=popt(T, 150), state0=loaded,
        la_l1=t(la_l1), lipsch=lip,
        vprox=T.VertexProx(kind="l1", positivity=True))
    assert res_t.it == int(res_j.it) == 150
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=1e-12)

    eu, ev, la = make_grid_graph(h, w, seed=13)
    jg = J.GraphD1.create(eu, ev, 0.2 * la, dtype=jnp.float64)
    tg = T.GraphD1.create(eu, ev, 0.2 * la, dtype=torch.float64,
                          device="cpu")

    def copt(pkg, it_max):
        return pkg.CPOptions(dif_tol=1e-5, it_max=it_max, pfdr=pkg.PFDROptions(
            dif_tol=1e-9, it_max=4000, fused="off"))

    first = jax_cp(J.DenseOp(jnp.asarray(a)), jnp.asarray(y), jg,
                   la_l1=la_l1, opt=copt(J, 2))
    jax_save_state(tmp_path / "cp.npz", first.state)
    cp_j = jax_cp(J.DenseOp(jnp.asarray(a)), jnp.asarray(y), jg, la_l1=la_l1,
                  opt=copt(J, 6), state=first.state)
    cp_t = cp_quadratic_d1(T.DenseOp(t(a)), t(y), tg, la_l1=la_l1,
                           opt=copt(T, 6),
                           state=load_state(tmp_path / "cp.npz"))
    assert cp_t.it == cp_j.it
    np.testing.assert_allclose(cp_t.rx[cp_t.cv],
                               np.asarray(cp_j.rx)[np.asarray(cp_j.cv)],
                               rtol=0, atol=1e-12)


def test_solve_trace_and_profile(tmp_path):
    """``SolveTrace.summary`` as in the JAX package; ``profile`` leaves a
    trace file in its directory."""
    trace = SolveTrace(time=np.array([0.0, 0.5, 1.25]),
                       obj=np.array([3.0, 2.0, 1.5]),
                       dif=np.array([0.1, 1e-3]))
    assert trace.summary() == ("2 iterations, 1.250s, objective 3 -> 1.5, "
                               "final evolution 0.001")
    with profile(tmp_path / "trace"):
        torch.ones(8).sum()
    assert list((tmp_path / "trace").iterdir())
