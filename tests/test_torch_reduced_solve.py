"""The one reduced problem of the three quadratic cut-pursuit loops
(``solvers/cut_pursuit.py``): every reduced solve of the host loop, the
per-iteration device loop and the chained loop goes through
``reduced_solve``, which counts it, and the premultiplication rule
``pre_at`` at its boundary.  On the CPU; this file imports no JAX."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as tcp
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_chain as tch
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_device as tcd
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import ONEHOT_MAX
from cp_pfdr_graph_d1_tpu_torch.utils import monitor

torch.set_num_threads(1)

H, W, N = 10, 12, 24

# (loop, CPOptions of it): the host loop on the kernel route, the device
# loop on the staged route (CPU tensors), the chain from its warm partition
LOOPS = {
    "host": dict(cut="host", pfdr_fused="on"),
    "device": dict(cut="device", chain="off", pfdr_fused="auto"),
    "chain": dict(cut="device", chain="on", pfdr_fused="auto"),
}


def lasso():
    """A fused LASSO on a stencil grid: ``(op, obs, graph, la_l1)``."""
    r = np.random.default_rng(3)
    a = r.normal(size=(N, H * W)) / 5
    x = np.zeros((H, W))
    x[2:7, 3:8] = 1.0
    x[6:9, 8:11] = 0.4
    y = a @ x.ravel() + 0.02 * r.normal(size=N)
    g = T.StencilGraphD1.create((H, W), {(0, 1): 0.05, (1, 0): 0.05},
                                dtype=torch.float64, device="cpu")
    return (T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y), g,
            np.full(H * W, 0.01))


def options(loop):
    kw = dict(LOOPS[loop])
    fused = kw.pop("pfdr_fused")
    return T.CPOptions(dif_tol=1e-4, it_max=8, cut_it_max=20000,
                       chain_init_pfdr=40, inexact_cap=150,
                       pfdr=T.PFDROptions(rho=1.5, dif_tol=1e-7, it_max=600,
                                          fused=fused), **kw)


@pytest.mark.parametrize("loop", list(LOOPS))
def test_every_reduced_solve_goes_through_reduced_solve(monkeypatch, loop):
    """Wrapped in every loop module, ``reduced_solve`` sees every reduced
    solve: the whole-solve kernels and the staged loop run only inside it,
    its calls number the traced ``reduced.launches``, their iterations sum
    to ``reduced.iters``, and the solve's result equals, bit for bit, that
    of the unwrapped loop."""
    op, obs, g, la_l1 = lasso()
    opt = options(loop)

    def solve():
        return tcp.cp_quadratic_d1(op, obs, g, la_l1=la_l1, positivity=True,
                                   opt=opt)

    plain = solve()
    calls, inside = [], [0]
    outside = []
    orig = tcp.reduced_solve

    def wrapped(*args, **kw):
        inside[0] += 1
        try:
            out = orig(*args, **kw)
        finally:
            inside[0] -= 1
        calls.append(int(out[1]))
        return out

    def only_inside(name):
        fn = getattr(tcp, name)

        def checked(*args, **kw):
            if not inside[0]:
                outside.append(name)
            return fn(*args, **kw)
        monkeypatch.setattr(tcp, name, checked)

    for mod in (tcp, tcd, tch):
        monkeypatch.setattr(mod, "reduced_solve", wrapped)
    only_inside("_kernel_solve")
    only_inside("pfdr_quadratic_d1")
    with profile(activities=[ProfilerActivity.CPU]):
        res = solve()
    rec = monitor.trace_records()[-1]
    assert calls and not outside
    assert rec["counters"]["reduced.launches"] == len(calls)
    assert rec["counters"]["reduced.iters"] == sum(calls)
    assert res.it == plain.it and np.array_equal(res.cv, plain.cv)
    assert res.rx.dtype == plain.rx.dtype
    assert np.array_equal(res.rx.view(np.uint8), plain.rx.view(np.uint8))


# (components, observation rows, iterations of the last reduced solve,
# premultiplied): the reference's rule num_comp < 2 N p // (N + p), at the
# threshold and one below it
PRE_AT_CASES = [
    (33, 24, 60, True), (34, 24, 60, False),          # 2880 // 84 = 34
    (179, 91, 10000, True), (180, 91, 10000, False),  # 1820000 // 10091
    (2, 3, 5, True), (3, 3, 5, False),                # 30 // 8 = 3, not 3.75
    (1, 24, 1, False), (0, 24, 1, True),              # p = 1: 48 // 25 = 1
    (1, 0, 1000, False),                              # no observation rows
]


@pytest.mark.parametrize("num_comp,n_obs,p,want", PRE_AT_CASES)
def test_premultiplication_rule_at_its_boundary(num_comp, n_obs, p, want):
    assert tcp.pre_at(num_comp, n_obs, p) is want


@pytest.mark.parametrize("rv_cap,onehot_max,pre_at,kind", [
    (64, ONEHOT_MAX, True, "GramOp"), (64, ONEHOT_MAX, False, "DenseOp"),
    (64, 32, True, "DenseOp"), (64, 64, True, "GramOp")])
def test_contraction_premultiplies_only_within_the_onehot_cap(
        rv_cap, onehot_max, pre_at, kind):
    """``reduce_operator`` takes the rule's answer within its one-hot cap
    and never premultiplies beyond it (segment sums)."""
    op, obs, g, _ = lasso()
    r = np.random.default_rng(1)
    num_comp = 40
    cv = torch.as_tensor(np.sort(np.concatenate([
        np.arange(num_comp), r.integers(0, num_comp, H * W - num_comp)])))
    r_op, mat, ry, _ = tcp.reduce_operator(op, obs, cv, num_comp, rv_cap,
                                           pre_at=pre_at,
                                           onehot_max=onehot_max)
    assert type(r_op).__name__ == kind
    assert mat.shape == ((rv_cap, rv_cap) if kind == "GramOp"
                         else (N, rv_cap))
