"""The reduced solves' set-up (``ops/reduced_setup.py``): its plain version
against the chain it replaces (the metric computed at the contraction,
then ``initial_precondition``), bit for bit, on every operator route; the
route of the power iteration; the power iteration's start kept on the
device; the counts of the kernel route in a traced solve, with the launch
replaced by its plain version; the incidence lists the kernel walks.  On
the CPU.  The kernel against its plain version runs on the card only
(``-m card``); this file imports no JAX, so that the card's tests run
without it."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cp_pfdr_graph_d1_tpu_torch import (BandedGraphD1, GraphD1, VertexProx,
                                        api)
from cp_pfdr_graph_d1_tpu_torch.config import OPERATOR_NORM_NB_INIT, Lipsch
from cp_pfdr_graph_d1_tpu_torch.graph import incidence_csr
from cp_pfdr_graph_d1_tpu_torch.operators import DenseOp, DiagOp, GramOp
from cp_pfdr_graph_d1_tpu_torch.ops import power_iter
from cp_pfdr_graph_d1_tpu_torch.ops import reduced_setup as rs
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as tcp
from cp_pfdr_graph_d1_tpu_torch.ops.power_iter import (MatApply,
                                                      dense_operator_norm,
                                                      operator_norm)
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import \
    initial_precondition
from cp_pfdr_graph_d1_tpu_torch.utils import monitor

from ._torch_cuda_source import (assert_struct_mirrors, cuda_constant,
                                 cuda_source)

torch.set_num_threads(1)

RV_CAP = 128
# reduced problems by route: (operator kind of the contraction, pre_at,
# observation rows); "dense_twice" has as many rows as columns, so the power
# iteration applies the operator twice a step and the metric is computed
# at the contraction
MODES = {"pre_at": ("dense", True, 24), "dense": ("dense", False, 24),
         "dense_twice": ("dense", False, RV_CAP), "gram": ("gram", False, 24),
         "diag": ("diag", False, 24)}


def reduced_problem(mode, rv=100, seed=0, dtype=torch.float64,
                    device="cpu", n=None):
    """``(kind, op_arr, obs, cv, rgraph, r_la_l1, x0, pre_at)`` of a ring
    of RV_CAP vertices contracted onto ``rv`` components, its reduced ring
    padded with zero-weight loops, on ``device``."""
    kind, pre_at, rows = MODES[mode]
    r = np.random.default_rng(seed)
    a = r.standard_normal((n or rows, RV_CAP)) / np.sqrt(n or rows)
    y = a @ (r.random(RV_CAP) > 0.7) + 0.01 * r.standard_normal(len(a))
    op_arr, obs = {"gram": (a.T @ a, a.T @ y),
                   "diag": ((a * a).sum(axis=0), a.T @ y)}.get(kind, (a, y))
    cv = np.sort(np.concatenate([np.arange(rv),
                                 r.integers(0, rv, RV_CAP - rv)]))
    reu = np.concatenate([np.arange(rv), np.arange(RV_CAP - rv) % RV_CAP])
    rev = np.concatenate([(np.arange(rv) + 1) % rv,
                          np.arange(RV_CAP - rv) % RV_CAP])
    rla = np.concatenate([0.2 + r.random(rv), np.zeros(RV_CAP - rv)])
    rgraph = GraphD1.create(reu, rev, rla, num_vertices=RV_CAP, dtype=dtype,
                            device=device)
    t = lambda z: torch.as_tensor(z, dtype=dtype, device=device)  # noqa
    x0 = np.zeros(RV_CAP)
    x0[:rv] = r.uniform(0, 0.5, rv)
    return (kind, t(op_arr), t(obs), torch.as_tensor(cv, device=device),
            rgraph, t(np.full(RV_CAP, 0.02)), t(x0), pre_at)


def contract(kind, op_arr, obs, cv, pre_at):
    """``(r_op, mat, ry, lipsch)`` of :func:`reduced_problem`'s operator,
    contracted as the host loop does (one-hot products)."""
    op = {"dense": DenseOp, "gram": GramOp, "diag": DiagOp}[kind](op_arr)
    return tcp.reduce_operator(op, obs, cv, RV_CAP, RV_CAP, pre_at=pre_at,
                               onehot_max=RV_CAP)


def seed_metric(mode, mat):
    """The DIAG Lipschitz metric as the contraction computed it before the
    set-up took over its power iteration, from the reduced operator's
    array ``mat``."""
    if mode == "diag":
        return mat
    if mode in ("pre_at", "gram"):
        d = torch.sqrt(torch.clamp(torch.diagonal(mat), min=0))
        d_safe = torch.where(d > 0, d, torch.ones_like(d))
        eq = mat / (d_safe[:, None] * d_safe[None, :])
        return torch.diagonal(mat) * operator_norm(MatApply(eq), RV_CAP,
                                                   mat.dtype, mat.device)
    cn = torch.sqrt((mat * mat).sum(dim=0))
    cn_safe = torch.where(cn > 0, cn, torch.ones_like(cn))
    return cn * cn * dense_operator_norm(mat / cn_safe)


def seed_kernel_solve_inputs(r_op, mat, ry, lipsch, rgraph, r_la_l1, x0,
                             rv, *, vprox, rho, dif_tol, sort_edges):
    """``kernel_solve_inputs`` as it was before the set-up became one
    function: ``initial_precondition`` on a metric computed beforehand."""
    pre = initial_precondition(r_op, ry, rgraph, r_la_l1, rho, lipsch,
                               Lipsch.DIAG)
    op_kind = tcp._op_kind(r_op)
    aty = r_op.apply_t(ry) if op_kind == "dense" else ry
    eu, ev = rgraph.eu, rgraph.ev
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    if sort_edges:
        perm = torch.sort(torch.minimum(eu, ev), stable=True).indices
        eu, ev, ec = eu[perm], ev[perm], ec[:, perm].contiguous()
    args = (op_kind, mat.contiguous(), aty.contiguous(), pre.ga.contiguous(),
            pre.th_l1.contiguous(), x0.contiguous(),
            torch.stack([x0[eu], x0[ev]]), ec, eu, ev)
    return args, pre


@pytest.mark.parametrize("l1", [True, False])
@pytest.mark.parametrize("sort_edges", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_setup_equals_the_chain_it_replaces(mode, sort_edges, l1):
    """The kernel route's inputs from the contraction's pending metric (the
    set-up's plain version) equal, bit for bit, those of the metric the
    contraction computed before and ``initial_precondition``: the dense
    operator premultiplied and not (through the small Gram, or twice a
    step), the Gram and the diagonal operators, edges sorted or not, with
    and without l1 weights."""
    kind, op_arr, obs, cv, rgraph, r_la_l1, x0, pre_at = reduced_problem(
        mode)
    r_la_l1 = r_la_l1 if l1 else None
    kw = dict(vprox=VertexProx(kind="l1", positivity=True), rho=1.5,
              dif_tol=1e-6, sort_edges=sort_edges)
    r_op, mat, ry, pending = contract(kind, op_arr, obs, cv, pre_at)
    assert isinstance(pending, rs.PendingMetric) == (
        mode not in ("dense_twice", "diag"))
    lipsch = seed_metric(mode, mat)
    assert torch.equal(rs.metric_value(pending), lipsch)
    want, pre = seed_kernel_solve_inputs(r_op, mat, ry, lipsch, rgraph,
                                         r_la_l1, x0, 100, **kw)
    got, got_kw = tcp.kernel_solve_inputs(
        r_op, mat, ry, tcp.settle_metric(pending), rgraph, r_la_l1, x0,
        100, **kw)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    out = rs.reduced_setup_plain(r_op, ry, pending, rgraph, r_la_l1, x0,
                                 rho=1.5)
    assert torch.equal(out.lipsch, lipsch)
    assert torch.equal(out.ga, pre.ga) and torch.equal(out.th_l1, pre.th_l1)
    assert got_kw["rv"] == 100 and got_kw["rho"] == 1.5


def on_card(p):
    """A stand-in for a [p, p] matrix on a CUDA device."""
    return SimpleNamespace(is_cuda=True, shape=(p, p))


def test_route_of_the_power_iteration():
    """The kernel runs the power iteration of a matrix of at most
    FUSED_POWER_MAX_DIM rows, on a CUDA device; elsewhere the metric is
    computed before the launch.  At the cap the iterate fits shared
    memory in float64."""
    cap = rs.FUSED_POWER_MAX_DIM
    assert rs.power_in_kernel(on_card(91))
    assert rs.power_in_kernel(on_card(256))
    assert rs.power_in_kernel(on_card(cap))
    assert not rs.power_in_kernel(on_card(cap + 1))
    assert not rs.power_in_kernel(on_card(0))
    assert not rs.power_in_kernel(torch.zeros(128, 128))
    assert rs.smem_bytes(cap, 8) <= rs.MAX_SMEM_BYTES
    # on the CPU a pending metric is computed, a tensor passes
    kind, op_arr, obs, cv, *_, pre_at = reduced_problem("pre_at")
    _, _, _, pending = contract(kind, op_arr, obs, cv, pre_at)
    value = rs.settle_metric(pending)
    assert torch.equal(value, rs.metric_value(pending))
    assert rs.settle_metric(value) is value


def test_the_wrapper_mirrors_the_cuda_source():
    """The shared-memory size, the restarts and the launch's argument
    struct of ``csrc/reduced_setup.cu`` are those the wrapper assumes."""
    src = cuda_source("reduced_setup.cu")
    assert cuda_constant(src, "kPowerRestarts") == OPERATOR_NORM_NB_INIT
    assert cuda_constant(src, "kSetupThreads") == 1024
    assert all(cuda_constant(src, f"kSetup{k.title()}") == v
               for k, v in rs._KIND.items())
    assert_struct_mirrors(src, "SetupParams", rs._Params)
    assert "sizeof(T) * (2 * kPowerRestarts + 1) * (size_t)p;" in src
    assert f"kSetupSmemLimit = 232448 - {232_448 - rs.MAX_SMEM_BYTES};" in src


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_power_start_is_made_once_per_shape(dtype):
    """The power iteration's start on the device equals threefry_uniform's
    (the JAX package's PRNGKey(0) uniform) for the buckets 8 to 4096, and
    is made once per shape, type and device."""
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    dim = 8
    while dim <= 4096:
        x = power_iter.start_columns(dim, OPERATOR_NORM_NB_INIT, tdtype,
                                     "cpu")
        assert x.dtype == tdtype and tuple(x.shape) == (dim, 10)
        np.testing.assert_array_equal(
            x.numpy(), power_iter.threefry_uniform((dim, 10), dtype))
        assert power_iter.start_columns(dim, OPERATOR_NORM_NB_INIT, tdtype,
                                        torch.device("cpu")) is x
        dim *= 2


def graph_cases():
    r = np.random.default_rng(5)
    nv = 40
    eu = r.integers(0, nv, 150).astype(np.int32)
    ev = r.integers(0, nv, 150).astype(np.int32)
    ev[:10] = eu[:10]                       # self-loops count twice
    la = r.random(150)
    dev = GraphD1(torch.as_tensor(eu, dtype=torch.int64),
                  torch.as_tensor(ev, dtype=torch.int64),
                  torch.as_tensor(la), nv)
    return [("host", GraphD1.create(eu, ev, la, num_vertices=nv,
                                    dtype=torch.float64, device="cpu")),
            ("device", dev),
            ("banded", BandedGraphD1.create(eu, ev, la, num_vertices=nv,
                                            dtype=torch.float64, tile=64,
                                            device="cpu"))]


@pytest.mark.parametrize("case", ["host", "device", "banded"])
def test_incidence_lists_are_the_containers_order(case):
    """``incidence_lists`` (the set-up kernel's vertex sums walk them, and
    ``solve_small`` takes them) equals ``incidence_csr`` of the graph's
    device endpoints, whether the graph was made from host arrays (built
    there, one copy to the device) or from device tensors, and is built
    once."""
    g = dict(graph_cases())[case]
    want = incidence_csr(g.eu, g.ev, g.num_vertices)
    got = g.incidence_lists()
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert g.incidence_lists() is got


@pytest.mark.parametrize("where", ["host", "device"])
def test_incidence_csr_checks_the_endpoints(where):
    """``incidence_csr`` builds the same lists from numpy arrays as from
    tensors, and refuses an endpoint outside the vertex range from
    either."""
    r = np.random.default_rng(2)
    eu = r.integers(0, 30, 80)
    ev = r.integers(0, 30, 80)
    wrap = (lambda z: z) if where == "host" else torch.as_tensor
    got = incidence_csr(wrap(eu), wrap(ev), 30)
    want = incidence_csr(torch.as_tensor(eu), torch.as_tensor(ev), 30)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == np.int32
    for bad in (-1, 30):
        eu2 = eu.copy()
        eu2[7] = bad
        with pytest.raises(ValueError, match="outside the 30 vertices"):
            incidence_csr(wrap(eu2), wrap(ev), 30)


def test_device_counters_are_read_with_the_next_int():
    """A device counter of a traced solve is read with the solve's next
    ``read_int`` (or at its end); untraced, it is dropped."""
    @monitor.solve_entry("t.solve")
    def solve():
        monitor.count_device("t.a", torch.tensor(3, dtype=torch.int32))
        monitor.count_device("t.a", torch.tensor(4))
        first = monitor.read_int(torch.tensor(9, dtype=torch.int32))
        monitor.count_device("t.b", torch.tensor(5))
        return first

    monitor.trace_records()
    with profile(activities=[ProfilerActivity.CPU]):
        assert solve() == 9
    (rec,) = monitor.trace_records()
    assert rec["counters"] == {"t.a": 7, "t.b": 5}
    assert solve() == 9


H, W, N = 10, 10, 24


def grid_solve(**kw):
    r = np.random.default_rng(0)
    idx = np.arange(H * W).reshape(H, W)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    a = r.normal(size=(N, H * W)) / 5
    x = np.zeros((H, W))
    x[2:7, 3:8] = 1.0
    y = a @ x.ravel() + 0.01 * r.normal(size=N)
    return api.cp_quadratic_d1_l1(
        y, a, eu.astype(np.int32), ev.astype(np.int32),
        np.full(eu.shape, 0.05), np.full(H * W, 0.01), positivity=True,
        CP_difTol=1e-4, CP_itMax=15, PFDR_rho=1.5, PFDR_difTol=1e-6,
        PFDR_itMax=10_000, device="cpu", **kw)


def traced_counters(monkeypatch):
    orig = api._cp_options

    def options(*args, **kw):
        o = orig(*args, **kw)
        return dataclasses.replace(o, pfdr=dataclasses.replace(o.pfdr,
                                                               fused="on"))
    monkeypatch.setattr(api, "_cp_options", options)
    monitor.trace_records()
    with profile(activities=[ProfilerActivity.CPU]):
        out = grid_solve()
    (rec,) = monitor.trace_records()
    return out, rec["counters"]


STEPS = 7


def test_kernel_route_counts_its_launches_and_steps(monkeypatch):
    """On the kernel route (its launch replaced by the plain version, which
    writes STEPS power steps to the device) a traced host-cut solve counts a
    ``reduced.setup_fused`` for each reduced solve and the launches' steps
    in ``lipschitz.steps``, read with the iterations, and hands back the
    plain route's answer."""
    plain, c_plain = traced_counters(monkeypatch)
    assert "reduced.setup_fused" not in c_plain
    assert c_plain["lipschitz.steps"] > 0

    def launch(kind, mat, lipsch, rgraph, r_la_l1, x0, rho, out, steps):
        r_op = {"dense": DenseOp, "gram": GramOp, "diag": DiagOp}[kind](mat)
        ref = rs.reduced_setup_plain(r_op, ry_of[id(mat)], lipsch, rgraph,
                                     r_la_l1, x0, rho=rho)
        for o, v in zip(out[1:], ref[1:]):
            o.copy_(v)
        if steps is not None:
            steps.fill_(STEPS)

    launches = rs.reduced_setup.launches
    monkeypatch.setattr(rs, "power_in_kernel", lambda *a: True)
    monkeypatch.setattr(rs, "_launch", launch)
    ry_of = {}

    def fused(*args, rho):
        ry_of[id(args[1])] = args[2]   # the launch does not take ry
        return rs._fused(*args, rho)
    monkeypatch.setattr(tcp, "reduced_setup", fused)
    fused, c = traced_counters(monkeypatch)
    n = c["reduced.launches"]
    assert c["reduced.setup_fused"] == n == c_plain["reduced.launches"]
    assert rs.reduced_setup.launches - launches == n
    assert c["lipschitz.steps"] == c_plain["lipschitz.steps"] + STEPS * n
    np.testing.assert_array_equal(fused.rX, plain.rX)
    np.testing.assert_array_equal(fused.Cv, plain.Cv)


# -- the card ----------------------------------------------------------------

def rel_err(a, b):
    """Largest difference over the largest magnitude of ``b``."""
    diff, top = float((a - b).abs().max()), float(b.abs().max())
    return diff / top if top else diff


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["pre_at", "dense", "gram", "diag"])
def test_setup_kernel_matches_its_plain_version(monkeypatch, mode, dtype):
    """On the card, at the EEG cell's shapes (91 observation rows, 128
    reduced vertices): the kernel against its plain version, the metric and
    every output to 1e-12 relative in float64 with equal power steps, 1e-5
    in float32; two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kind, op_arr, obs, cv, rgraph, r_la_l1, x0, pre_at = reduced_problem(
        mode, dtype=dtype, device="cuda", n=91)
    r_op, mat, ry, pending = contract(kind, op_arr, obs, cv, pre_at)
    # the power steps each side counts, read here rather than traced
    steps = {"kernel": [], "plain": []}
    monkeypatch.setattr(rs, "count_device", lambda name, t: steps[
        "kernel"].append(int(t)))
    monkeypatch.setattr(power_iter, "count", lambda name, n: steps[
        "plain"].append(int(n)))
    launches = rs.reduced_setup.launches
    got = rs._fused(r_op, mat, ry, pending, rgraph, r_la_l1, x0, 1.5)
    again = rs._fused(r_op, mat, ry, pending, rgraph, r_la_l1, x0, 1.5)
    want = rs.reduced_setup_plain(r_op, ry, pending, rgraph, r_la_l1, x0,
                                  rho=1.5)
    assert rs.reduced_setup.launches == launches + 2
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for name, g, w, a in zip(rs.SetupOut._fields, got, want, again):
        assert rel_err(g, w) <= tol, name
        assert torch.equal(g, a), name
    if mode == "diag":
        assert steps == {"kernel": [], "plain": []}
        return
    assert len(steps["kernel"]) == 2 and steps["kernel"][0] > 0
    assert steps["kernel"][0] == steps["kernel"][1]
    if dtype == torch.float64:
        assert steps["kernel"][:1] == steps["plain"]


@pytest.mark.card
def test_eeg_example_sets_up_every_reduced_solve_in_the_kernel():
    """Over the port's EEG example on the card, every reduced solve is set
    up by the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import examples.torch_example_EEG_CP as eeg
    monitor.trace_records()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ds, dsa = eeg.main(device="cuda")
    (rec,) = monitor.trace_records()
    c = rec["counters"]
    assert c["reduced.launches"] > 0
    assert c["reduced.setup_fused"] == c["reduced.launches"]
    assert c["lipschitz.steps"] > 0
    assert dsa >= 0.6 and ds >= 0.4


@pytest.mark.card
@pytest.mark.parametrize("chain", ["off", "on"])
def test_device_loops_set_up_in_the_kernel(monkeypatch, chain):
    """On the card, the per-iteration device loop and the chained loop
    (reduced graphs made on the device: their incidence lists come from a
    sort there) set up their reduced solves in the kernel, and reach the
    objective of the same loop on the plain set-up to 1e-6 in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, PFDROptions,
                                            StencilGraphD1)
    h, w, n = 12, 16, 24
    r = np.random.default_rng(0)
    a = r.normal(size=(n, h * w)) / np.sqrt(n)
    x_true = np.zeros((h, w))
    x_true[4:8, 4:8] = 2.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=n)
    g = StencilGraphD1.create((h, w), {(0, 1): 0.05, (1, 0): 0.05},
                              dtype=torch.float64, device="cuda")
    eu, ev, la = g.host_coo()
    la_l1 = np.full(h * w, 0.01)
    opt = CPOptions(dif_tol=1e-5, it_max=10, cut="device", chain=chain,
                    cut_it_max=20_000,
                    pfdr=PFDROptions(rho=1.5, dif_tol=1e-7, it_max=4000))

    def objective():
        res = tcp.cp_quadratic_d1(
            DenseOp(torch.as_tensor(a, device="cuda")),
            torch.as_tensor(y, device="cuda"), g, la_l1=la_l1,
            positivity=True, opt=opt)
        x = np.asarray(res.rx, np.float64)[res.cv]
        return (0.5 * np.sum((y - a @ x) ** 2) + np.sum(la * np.abs(
            x[eu] - x[ev])) + np.sum(la_l1 * np.abs(x)))

    before = rs.reduced_setup.launches
    got = objective()
    assert rs.reduced_setup.launches > before
    monkeypatch.setattr(tcp, "reduced_setup", lambda *args, rho: (
        rs.reduced_setup_plain(args[0], *args[2:7], rho=rho)))
    launches = rs.reduced_setup.launches
    want = objective()
    assert rs.reduced_setup.launches == launches
    assert abs(got - want) <= 1e-6 * abs(want)
