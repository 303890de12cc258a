"""Port's multi-label stencil kernel module and kernel loop against the JAX
package, on the CPU in float64.

The port's wrapper runs its kernel's plain version here (the tensors lie on
the CPU); the JAX side interprets its Pallas kernel, as
``tests/test_stencil.py::test_fused_simplex_matches_jnp`` does.  Equal
iteration counts; iterates at 1e-12 (the two differ in summation order
only).
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.ops.stencil_fused_simplex import \
    fused_stencil_simplex_iteration as jkernel
from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import \
    pfdr_loss_d1_simplex as jpfdr
from cp_pfdr_graph_d1_tpu_torch import convert
from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused_simplex as sfs

torch.set_num_threads(1)

H, W, K = 12, 10, 4


def graphs(seed=21, wrap=(False, True)):
    r = np.random.default_rng(seed)
    weights = {(0, 1): r.uniform(0.2, 1.0, (H, W)),
               (1, 0): r.uniform(0.2, 1.0, (H, W))}
    jsg = J.StencilGraphD1.create((H, W), weights, wrap=wrap,
                                  dtype=jnp.float64)
    tsg = convert.stencil_graph(np.asarray(jsg.la_d1), jsg.field_shape,
                                jsg.shifts, jsg.wrap, device="cpu")
    return jsg, tsg


def observations(seed=22):
    r = np.random.default_rng(seed)
    q = np.abs(r.normal(size=(H * W, K))) + 0.05
    return q / q.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("al,label_mode,la_f", [
    (0.0, False, None), (1.0, False, 0.8), (0.5, False, None),
    (0.5, True, None)], ids=["linear", "quadratic-laf", "kl", "kl-labels"])
def test_kernel_loop_matches_jax(al, label_mode, la_f):
    """``fused="on"``: the port's kernel loop (plain version on the CPU)
    against the JAX kernel loop (Pallas interpreted)."""
    jsg, tsg = graphs()
    q = observations()
    laf = np.full(H * W, la_f) if la_f is not None else None
    jopt = J.PFDROptions(rho=1.3, dif_tol=1.0 if label_mode else 1e-9,
                         it_max=400, fused="on")
    rj = jpfdr(jsg, jnp.asarray(q), al=al,
               la_f=jnp.asarray(laf) if laf is not None else None, opt=jopt)
    launches = sfs.fused_stencil_simplex_iteration.launches
    rt = T.pfdr_loss_d1_simplex(
        tsg, torch.from_numpy(q), al=al,
        la_f=torch.from_numpy(laf) if laf is not None else None,
        opt=convert.pfdr_options(dataclasses.asdict(jopt)))
    assert sfs.fused_stencil_simplex_iteration.launches == launches
    assert rt.it == int(rj.it)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("mode", ["monitor", "recondition", "verbose"])
def test_kernel_loop_serves_monitor_and_recondition(mode, capsys):
    """Monitoring, reconditioning and progress lines on the kernel loop
    (``fused="on"``, plain version on the CPU) against the JAX staged loop,
    which the JAX package runs for these options: equal iteration counts,
    iterates at 1e-12, objective traces at 1e-10."""
    jsg, tsg = graphs(seed=14)
    q = observations(seed=15)
    kw = dict(rho=1.2, dif_tol=1e-8, it_max=300, fused="on")
    if mode == "recondition":
        kw.update(dif_rcd=1e-3, cond_min=1e-2)
    if mode == "verbose":
        kw["verbose"] = 50
    jopt = J.PFDROptions(**kw)
    monitor = mode != "verbose"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rj = jpfdr(jsg, jnp.asarray(q), al=0.5, opt=jopt, monitor=monitor)
    capsys.readouterr()
    rt = T.pfdr_loss_d1_simplex(
        tsg, torch.from_numpy(q), al=0.5, monitor=monitor,
        opt=convert.pfdr_options(dataclasses.asdict(jopt)))
    it = rt.it
    assert it == int(rj.it)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=0,
                               atol=1e-12)
    if monitor:
        np.testing.assert_allclose(rt.obj[:it + 1].numpy(),
                                   np.asarray(rj.obj)[:it + 1], rtol=1e-10)
        np.testing.assert_allclose(rt.dif[:it].numpy(),
                                   np.asarray(rj.dif)[:it], rtol=1e-8,
                                   atol=1e-14)
    else:
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("PFDR iteration")]
        assert len(lines) == it // 50


@pytest.mark.parametrize("label_mode", [False, True], ids=["evolution",
                                                           "labels"])
def test_plain_iteration_matches_pallas(label_mode):
    """One call of ``stencil_simplex_iteration_plain`` against the JAX
    Pallas kernel in interpret mode, on a random state."""
    _, tsg = graphs(seed=5, wrap=(True, False))
    r = np.random.default_rng(6)
    f = len(tsg.shifts)
    live = (tsg.la_d1.numpy() > 0).reshape(f, 1, H, W)
    p = r.dirichlet(np.ones(K), H * W).T.reshape(K, H, W)
    q = r.dirichlet(np.ones(K), H * W).T.reshape(K, H, W)
    laf = r.uniform(0.5, 1.5, (1, H, W))
    ga = r.uniform(0.1, 1.0, (K, H, W))
    gap = ga / ga.max(axis=0, keepdims=True)
    prev = (np.argmax(r.random((K, H, W)), axis=0)[None].astype(float)
            if label_mode else r.dirichlet(np.ones(K), H * W).T.reshape(
                K, H, W))
    zu, zv = r.normal(size=(2, f, K, H, W))
    wu, wv, th = r.uniform(0.05, 0.5, (3, f, K, H, W)) * live
    w_d1u = np.where(live, r.uniform(0.05, 0.95, (f, K, H, W)), 0.5)
    args = (p, q, laf, ga, gap, prev, zu, zv, wu, wv, w_d1u, 1.0 - w_d1u, th)
    kw = dict(shifts=tsg.shifts, rho=1.4, al=0.5, has_laf=True,
              label_mode=label_mode)
    out_j = jkernel(*(jnp.asarray(a) for a in args), **kw, interpret=True)
    out_t = sfs.stencil_simplex_iteration_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
    for a_t, a_j in zip(out_t, out_j):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-13,
                                   atol=1e-13)


def test_kernel_loop_resume_and_auto_route():
    """The kernel loop's state converts back to the vertex-major layout and
    resumes bit for bit; ``fused="auto"`` on CPU tensors runs the staged
    loop, which agrees with the kernel loop."""
    _, tsg = graphs(seed=8)
    q = torch.from_numpy(observations(seed=9))
    on = T.PFDROptions(rho=1.5, dif_tol=0.0, it_max=150, fused="on")
    full = T.pfdr_loss_d1_simplex(tsg, q, al=1.0, opt=on)
    _, st = T.pfdr_loss_d1_simplex(tsg, q, al=1.0,
                                   opt=dataclasses.replace(on, it_max=60),
                                   return_state=True)
    assert st.p.shape == (H * W, K) and st.zu.shape == (tsg.num_edges, K)
    resumed = T.pfdr_loss_d1_simplex(tsg, q, al=1.0, opt=on, state0=st)
    assert resumed.it == full.it == 150
    assert torch.equal(resumed.p, full.p)
    staged = T.pfdr_loss_d1_simplex(
        tsg, q, al=1.0, opt=dataclasses.replace(on, fused="auto"))
    assert staged.it == 150
    np.testing.assert_allclose(staged.p.numpy(), full.p.numpy(), rtol=0,
                               atol=1e-12)
