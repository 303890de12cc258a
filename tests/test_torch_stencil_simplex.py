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

from ._torch_cuda_source import (assert_struct_mirrors, cuda_constant,
                                 cuda_source)

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


def random_planes(tsg, k, label_mode, seed):
    """A random state of one multi-label iteration on ``tsg`` with ``k``
    labels (the live edges' weights where ``la_d1 > 0``)."""
    r = np.random.default_rng(seed)
    f = len(tsg.shifts)
    live = (tsg.la_d1.numpy() > 0).reshape(f, 1, H, W)
    p = r.dirichlet(np.ones(k), H * W).T.reshape(k, H, W)
    q = r.dirichlet(np.ones(k), H * W).T.reshape(k, H, W)
    laf = r.uniform(0.5, 1.5, (1, H, W))
    ga = r.uniform(0.1, 1.0, (k, H, W))
    gap = ga / ga.max(axis=0, keepdims=True)
    prev = (np.argmax(r.random((k, H, W)), axis=0)[None].astype(float)
            if label_mode else r.dirichlet(np.ones(k), H * W).T.reshape(
                k, H, W))
    zu, zv = r.normal(size=(2, f, k, H, W))
    wu, wv, th = r.uniform(0.05, 0.5, (3, f, k, H, W)) * live
    w_d1u = np.where(live, r.uniform(0.05, 0.95, (f, k, H, W)), 0.5)
    return (p, q, laf, ga, gap, prev, zu, zv, wu, wv, w_d1u, 1.0 - w_d1u, th)


@pytest.mark.parametrize("k,label_mode,wrap,path", [
    pytest.param(K, False, (True, False), "plain", id="evolution"),
    pytest.param(K, True, (True, False), "plain", id="labels"),
    pytest.param(2, False, (True, True), "graph", id="graph-K2-wrapped"),
    pytest.param(3, False, (True, True), "graph", id="graph-K3-wrapped"),
    pytest.param(9, False, (True, True), "graph", id="graph-K9-wrapped"),
    pytest.param(3, True, (True, True), "graph",
                 id="graph-K3-labels-wrapped")])
def test_plain_iteration_matches_pallas(k, label_mode, wrap, path):
    """One call against the JAX Pallas kernel in interpret mode, on a
    random state: ``stencil_simplex_iteration_plain``, or the plan path of
    ``StencilGraphD1.fused_simplex_iteration`` (the plain version on CPU
    tensors, nothing launched)."""
    _, tsg = graphs(seed=5, wrap=wrap)
    args = random_planes(tsg, k, label_mode, seed=6)
    kw = dict(rho=1.4, al=0.5, has_laf=True, label_mode=label_mode)
    out_j = jkernel(*(jnp.asarray(a) for a in args), shifts=tsg.shifts,
                    **kw, interpret=True)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if path == "plain":
        out_t = sfs.stencil_simplex_iteration_plain(*targs,
                                                    shifts=tsg.shifts, **kw)
    else:
        launches = sfs.fused_stencil_simplex_iteration.launches
        out_t = tsg.fused_simplex_iteration(*targs, **kw)
        assert sfs.fused_stencil_simplex_iteration.launches == launches
        assert tsg._simplex_plans == {}
    for a_t, a_j in zip(out_t, out_j):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-13,
                                   atol=1e-13)


def test_plan_key_reuse_and_rebuild():
    """A launch plan is reused for fields of the same dtypes, shapes and
    devices and the same constants, and a new one is made when the dtype,
    K, the label mode, the loss or ``has_laf`` changes."""
    _, tsg = graphs(seed=5)

    def key(k=K, dtype=torch.float64, label_mode=False, al=0.5,
            has_laf=True):
        args = random_planes(tsg, k, label_mode, seed=1)
        fields = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
                  for a in args]
        return sfs.plan_key(fields, tsg.shifts, rho=1.4, al=al,
                            has_laf=has_laf, label_mode=label_mode)

    base = key()
    assert key() == base and hash(key()) == hash(base)
    others = [key(dtype=torch.float32), key(k=3), key(label_mode=True),
              key(al=1.0), key(has_laf=False)]
    assert len({base, *others}) == 1 + len(others)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 31, 32])
def test_launch_shape_covers_every_cell_and_label_once(k):
    """The kernel's block layout: 32 m cells a block times the K labels,
    at most 1024 threads, a warp inside one label plane; thread ``t`` of
    block ``b`` takes label ``t // cells`` of cell ``b cells + t % cells``,
    which covers every (label, cell) of the field once."""
    h, w = 13, 29
    cells, threads, blocks = sfs.launch_shape(h, w, k)
    assert cells % 32 == 0 and threads == k * cells
    assert threads <= sfs.MAX_THREADS and (threads <= 256 or k > 8)
    t = np.arange(threads)
    lab, cell = t // cells, t % cells
    seen = np.zeros((k, h * w), int)
    for b in range(blocks):
        c = b * cells + cell
        np.add.at(seen, (lab[c < h * w], c[c < h * w]), 1)
    assert (seen == 1).all()
    assert sfs.launch_shape(140, 140, 4) == (64, 256, 307)


def test_plan_struct_mirrors_the_cuda_source():
    """``_Plan`` has ``SimplexPlan``'s fields at the same offsets, and the
    constants mirrored from the source agree."""
    src = cuda_source("stencil_fused_simplex.cu")
    assert_struct_mirrors(src, "SimplexPlan", sfs._Plan)
    assert cuda_constant(src, "kMaxLabels") == sfs.MAX_LABELS
    assert cuda_constant(src, "kMaxSimplexThreads") == sfs.MAX_THREADS
    assert cuda_constant(src, "kMaxFamilies") == sfs.MAX_FAMILIES


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
