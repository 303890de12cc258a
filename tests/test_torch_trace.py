"""The port's tracer (``utils.monitor``): the spans and counters a host-cut
solve and a device-route solve (the chained and per-iteration device
loops) record while a ``torch.profiler`` records, none without one, a new
buffer for a new session, the benchmark's readers of those records, and
the port names the benchmark's traced runs wrap.  On the CPU; the clock
test runs on the card only (``-m card``)."""
import ast
import dataclasses
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cp_pfdr_graph_d1_tpu_torch import api
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit
from cp_pfdr_graph_d1_tpu_torch.utils import monitor

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
PORT = "cp_pfdr_graph_d1_tpu_torch"

H, W, N = 10, 10, 24
SOLVE_KW = dict(positivity=True, CP_difTol=1e-4, CP_itMax=15, PFDR_rho=1.5,
                PFDR_difTol=1e-6, PFDR_itMax=10_000, device="cpu")

# (span, parent) pairs of a host-cut solve through the API; None is the
# solve itself
TREE = {("api.inputs", None), ("cp.solve", None),
        ("cp.init", "cp.solve"), ("cp.iter", "cp.solve"),
        ("cp.gradient", "cp.iter"), ("cp.cut", "cp.iter"),
        ("cp.maxflow", "cp.cut"), ("cp.components", "cp.iter"),
        ("cp.contraction", "cp.iter"), ("cp.reduced", "cp.iter"),
        ("cp.reduced.graph", "cp.reduced"),
        ("cp.reduced.operator", "cp.reduced"),
        ("cp.reduced.lipschitz", "cp.reduced"),
        ("cp.reduced.launch", "cp.reduced"),
        ("cp.reduced.wait", "cp.reduced"), ("cp.merge", "cp.iter"),
        ("cp.polish", "cp.solve"), ("cp.reduced", "cp.polish")}
KERNEL_ONLY = {("cp.reduced.precondition", "cp.reduced")}


def problem(seed=0):
    r = np.random.default_rng(seed)
    idx = np.arange(H * W).reshape(H, W)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    la = np.full(eu.shape, 0.05)
    a = (r.normal(size=(N, H * W)) / 5).astype(np.float32)
    x = np.zeros((H, W))
    x[2:7, 3:8] = 1.0
    y = (a @ x.ravel() + 0.01 * r.normal(size=N)).astype(np.float32)
    la_l1 = np.full(H * W, 0.01, np.float32)
    return eu.astype(np.int32), ev.astype(np.int32), la, a, y, la_l1


def solve(prob, **kw):
    eu, ev, la, a, y, la_l1 = prob
    return api.cp_quadratic_d1_l1(y, a, eu, ev, la, la_l1,
                                  **dict(SOLVE_KW, **kw))


def quick_solve(prob):
    """Two outer iterations of few inner ones: a solve to count."""
    return solve(prob, CP_itMax=2, PFDR_itMax=300)


def with_fused(monkeypatch, fused):
    """The API's options with ``pfdr.fused`` set: "on" runs the reduced
    solves on the whole-solve kernels' plain versions, "off" on the staged
    loop."""
    orig = api._cp_options

    def options(*args, **kw):
        o = orig(*args, **kw)
        return dataclasses.replace(o, pfdr=dataclasses.replace(o.pfdr,
                                                               fused=fused))
    monkeypatch.setattr(api, "_cp_options", options)


def traced(fn):
    """``fn()`` under a CPU profile, and the records of its solves (the
    read before it starts the buffer anew)."""
    monitor.trace_records()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, monitor.trace_records()


def parent_name(rec, s):
    return None if s["parent"] is None else rec["spans"][s["parent"]]["name"]


def assert_nested_and_covered(rec):
    """A span lies inside its parent and after its elder sibling, its self
    time is its time less its children's, and the API's inputs and
    ``cp.solve``'s children cover 95 % of the solve."""
    spans = rec["spans"]
    last_end = {}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        lo, hi = ((rec["start_ns"], rec["end_ns"]) if s["parent"] is None
                  else (spans[s["parent"]]["start_ns"],
                        spans[s["parent"]]["end_ns"]))
        assert lo <= s["start_ns"] and s["end_ns"] <= hi
        assert s["start_ns"] >= last_end.get(s["parent"], lo)
        last_end[s["parent"]] = s["end_ns"]
    for k, s in enumerate(spans):
        kids = sum(c["total_ns"] for c in spans if c["parent"] == k)
        assert s["self_ns"] == s["total_ns"] - kids
    solve_k = next(k for k, s in enumerate(spans) if s["name"] == "cp.solve")
    covered = sum(s["total_ns"] for s in spans
                  if s["parent"] == solve_k or s["name"] == "api.inputs")
    assert covered >= 0.95 * rec["total_ns"]


@pytest.mark.parametrize("fused", ["on", "off"])
def test_a_traced_solve_records_its_span_tree_and_counters(monkeypatch,
                                                           fused):
    with_fused(monkeypatch, fused)
    prob = problem()
    calls = []
    orig = cut_pursuit.reduced_solve

    def counted(*args, **kw):
        out = orig(*args, **kw)
        calls.append(int(out[1]))
        return out
    monkeypatch.setattr(cut_pursuit, "reduced_solve", counted)
    out, recs = traced(lambda: solve(prob))
    assert len(recs) == 1
    rec = recs[0]
    spans = rec["spans"]
    pairs = {(s["name"], parent_name(rec, s)) for s in spans}
    assert pairs == TREE | (KERNEL_ONLY if fused == "on" else set())
    assert sum(1 for s in spans if s["name"] == "cp.iter") == out.it
    assert_nested_and_covered(rec)
    # counters: one launch per reduced solve the loop ran (the iterations
    # that activated edges, then the polish), with the iterations each
    # handed back
    c = rec["counters"]
    def n_spans(name):
        return sum(1 for s in spans if s["name"] == name)
    n_reduced = n_spans("cp.reduced")
    assert c["reduced.launches"] == len(calls) == n_reduced
    assert n_reduced == n_spans("cp.components") + 1
    assert c["reduced.iters"] == sum(calls)
    eu, ev, la, a, y, la_l1 = prob
    assert c["h2d.bytes"] >= a.nbytes + y.nbytes
    assert c["d2h.bytes"] > 0 and c["lipschitz.steps"] > 0
    assert 0 < c["maxflow.edges"] <= n_spans("cp.maxflow") * len(eu)
    assert rec["dropped_spans"] == 0


def test_nothing_is_recorded_without_a_profiler():
    prob = problem(1)
    assert monitor.span("cp.cut") is monitor.span("cp.iter")
    _, recs = traced(lambda: quick_solve(prob))
    assert len(recs) == 1
    out = quick_solve(prob)
    assert out.it > 0
    again = monitor.trace_records()
    assert [r["solve"] for r in again] == [recs[0]["solve"]]
    assert again[0]["counters"] == recs[0]["counters"]


def test_a_new_profiler_session_starts_from_an_empty_buffer():
    prob = problem(2)
    cpu = [ProfilerActivity.CPU]
    _, first = traced(lambda: quick_solve(prob))
    # a session after the last session's records were read
    with profile(activities=cpu):
        quick_solve(prob)
    second = monitor.trace_records()
    assert len(first) == len(second) == 1
    assert second[0]["solve"] > first[0]["solve"]
    # a session after an untraced solve, the last session's two unread
    with profile(activities=cpu):
        quick_solve(prob)
        quick_solve(prob)
    quick_solve(prob)
    with profile(activities=cpu):
        quick_solve(prob)
    third = monitor.trace_records()
    assert len(third) == 1 and third[0]["solve"] > second[0]["solve"] + 2


def test_spans_and_counters_outside_a_solve_are_no_ops():
    before = monitor.trace_records()
    with profile(activities=[ProfilerActivity.CPU]):
        with monitor.span("cp.cut"):
            monitor.count("h2d.bytes", 8)
    assert monitor.trace_records() == before


# -- the device routes (cut="device") ----------------------------------------

# (span, parent) pairs the device routes add; the reduced solve's own spans
# (cp.reduced.*) sit under cp.device_reduced
DEVICE_TREE = {
    "off": {("api.inputs", None), ("cp.solve", None),
            ("cp.init", "cp.solve"), ("cp.iter", "cp.solve"),
            ("cp.device_cut", "cp.iter"),
            ("cp.device_cut.wait", "cp.device_cut"),
            ("cp.device_components", "cp.iter"),
            ("cp.device_reduced", "cp.iter"),
            ("cp.device_merge", "cp.iter")},
    "on": {("cp.warm", "cp.solve"), ("cp.settle", "cp.solve"),
           ("cp.device_components", "cp.settle"),
           ("cp.device_reduced", "cp.settle"),
           ("cp.device_merge", "cp.settle"), ("cp.polish", "cp.solve"),
           ("cp.device_components", "cp.polish"),
           ("cp.device_reduced", "cp.polish"),
           ("cp.device_merge", "cp.polish")}}
DEVICE_TREE["on"] |= DEVICE_TREE["off"]


def stencil_solve(prob, **kw):
    """The grid problem on a stencil graph (the kernels' container) through
    the API's device route."""
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    _, _, _, a, y, la_l1 = prob
    g = StencilGraphD1.create((H, W), {(0, 1): 0.05, (1, 0): 0.05},
                              dtype=torch.float32, device="cpu")
    return api.cp_quadratic_d1_l1(y, a, None, None, None, la_l1, graph=g,
                                  cut="device", **dict(SOLVE_KW, **kw))


@pytest.mark.parametrize("chain", ["on", "off"])
def test_a_traced_device_solve_records_its_span_tree_and_counters(chain):
    out, recs = traced(lambda: stencil_solve(problem(), chain=chain))
    assert len(recs) == 1
    rec = recs[0]
    spans = rec["spans"]
    pairs = {(s["name"], parent_name(rec, s)) for s in spans}
    device = {p for p in pairs if not p[0].startswith("cp.reduced")}
    assert device == DEVICE_TREE[chain]
    assert {p[1] for p in pairs - device} == {"cp.device_reduced"}
    assert sum(1 for s in spans if s["name"] == "cp.iter") == out.it
    assert_nested_and_covered(rec)

    def n_spans(name):
        return sum(1 for s in spans if s["name"] == name)
    c = rec["counters"]
    # two cuts a round (positivity: both directions), each whole chunks of
    # min(250, cut_it_max) PDHG steps
    assert c["mincut.launches"] == 2 * n_spans("cp.device_cut")
    assert c["mincut.steps"] % 250 == 0
    assert c["mincut.steps"] >= 250 * c["mincut.launches"]
    assert c["reduced.launches"] == n_spans("cp.device_reduced") > 0
    assert c["reduced.iters"] >= c["reduced.launches"]
    assert ("warm.components" in c) == (chain == "on")
    assert c.get("warm.components", 1) >= 1
    assert "cut.uncertified" not in c and "chain.fallbacks" not in c
    assert rec["dropped_spans"] == 0


def test_a_discarded_chain_and_a_host_redone_cut_are_counted():
    """A cut capped at one PDHG step never certifies: the chain discards
    itself, the device loop continues the cut, then redoes it on the host
    (CPU tensors), and the counters say so."""
    import warnings
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, DenseOp, PFDROptions,
                                            StencilGraphD1)
    _, _, _, a, y, la_l1 = problem(5)
    g = StencilGraphD1.create((H, W), {(0, 1): 0.05, (1, 0): 0.05},
                              dtype=torch.float32, device="cpu")
    opt = CPOptions(dif_tol=1e-4, it_max=3, cut="device", chain="on",
                    cut_it_max=1, pfdr=PFDROptions(rho=1.5, it_max=300))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, recs = traced(lambda: cut_pursuit.cp_quadratic_d1(
            DenseOp(torch.from_numpy(a)), torch.from_numpy(y), g,
            la_l1=la_l1, positivity=True, opt=opt))
    messages = " ".join(str(w.message) for w in caught)
    assert "chained PDHG cut" in messages and "host min-cut" in messages
    c = recs[0]["counters"]
    assert c["chain.fallbacks"] == 1
    assert c["cut.uncertified"] >= 2 and c["cut.uncertified"] % 2 == 0
    assert out.it >= 1


@pytest.mark.parametrize("chain", ["on", "off"])
def test_device_routes_record_and_read_nothing_without_a_profiler(
        monkeypatch, chain):
    """Untraced, the device routes' spans and counters are the shared
    no-ops and no device counter is read: the tracer's counter read never
    runs."""
    prob = problem(6)
    _, recs = traced(lambda: stencil_solve(prob, chain=chain, CP_itMax=2))
    assert len(recs) == 1

    def no_read(*args):
        raise AssertionError("an untraced solve read a device counter")
    monkeypatch.setattr(monitor, "_read_counters", no_read)
    out = stencil_solve(prob, chain=chain, CP_itMax=2)
    assert out.it > 0
    again = monitor.trace_records()
    assert [r["solve"] for r in again] == [recs[0]["solve"]]


# -- the benchmark's readers of the records ----------------------------------

def reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class FakeRun:
    traced_solves = 2


def hand_records():
    """Two solves: spans as (name, parent index, start, end) in ns."""
    def rec(spans, counters):
        out = []
        for name, parent, t0, t1 in spans:
            out.append(dict(name=name, parent=parent, start_ns=t0, end_ns=t1,
                            total_ns=t1 - t0, self_ns=0))
        return dict(solve=0, start_ns=0, end_ns=10**9, total_ns=10**9,
                    self_ns=0, counters=counters, dropped_spans=0,
                    spans=out)
    one = rec([("cp.solve", None, 0, 900_000_000),
               ("cp.iter", 0, 0, 500_000_000),
               ("cp.cut", 1, 0, 200_000_000),
               ("cp.components", 1, 200_000_000, 203_000_000),
               ("cp.contraction", 1, 203_000_000, 204_000_000),
               ("cp.reduced", 1, 204_000_000, 400_000_000),
               ("cp.reduced.wait", 5, 300_000_000, 400_000_000),
               ("cp.polish", 0, 500_000_000, 600_000_000),
               ("cp.reduced", 7, 500_000_000, 600_000_000),
               ("cp.reduced.wait", 8, 540_000_000, 600_000_000)],
              {"h2d.bytes": 7_000_000, "d2h.bytes": 500_000,
               "reduced.launches": 2, "reduced.iters": 4000})
    two = rec([("cp.solve", None, 0, 100_000_000),
               ("cp.iter", 0, 0, 100_000_000),
               ("cp.cut", 1, 0, 100_000_000)],
              {"h2d.bytes": 2_500_000, "reduced.launches": 1,
               "reduced.iters": 2000})
    return [one, two]


def test_readers_read_the_records(monkeypatch):
    monkeypatch.setattr(monitor, "trace_records", hand_records)
    run = FakeRun()
    assert reader("host_cut_ms")(run) == pytest.approx(150.0)
    assert reader("contraction_ms")(run) == pytest.approx(2.0)
    # (196 - 100) + (100 - 60) ms over two solves
    assert reader("reduced_setup_ms")(run) == pytest.approx(68.0)
    assert reader("reduced_iters")(run) == pytest.approx(2000.0)
    assert reader("hd_mb")(run) == pytest.approx(5.0)
    # records of another number of solves than the slice held, none at
    # all, or a port without the records: nothing to read
    run.traced_solves = 3
    names = ("host_cut_ms", "contraction_ms", "reduced_setup_ms",
             "reduced_iters", "hd_mb")
    assert all(reader(n)(run) is None for n in names)
    monkeypatch.setattr(monitor, "trace_records", list)
    assert all(reader(n)(FakeRun()) is None for n in names)
    monkeypatch.delattr(monitor, "trace_records")
    assert all(reader(n)(FakeRun()) is None for n in names)


def test_resident_share_reads_the_records(monkeypatch):
    """``resident_share``: the resident launches over the reduced solves of
    the slice, in %; nothing to read where the port has no resident
    schedule, as on a port before it."""
    from cp_pfdr_graph_d1_tpu_torch.ops import solve_small

    def records():
        recs = hand_records()
        recs[0]["counters"]["reduced.resident"] = 2
        return recs
    monkeypatch.setattr(monitor, "trace_records", records)
    run = FakeRun()
    assert reader("resident_share")(run) == pytest.approx(200 / 3)
    monkeypatch.setattr(monitor, "trace_records", hand_records)
    assert reader("resident_share")(run) == 0.0
    run.traced_solves = 3
    assert reader("resident_share")(run) is None
    monkeypatch.setattr(monitor, "trace_records", list)
    assert reader("resident_share")(FakeRun()) is None
    monkeypatch.setattr(monitor, "trace_records", records)
    monkeypatch.delattr(solve_small, "RESIDENT")
    assert reader("resident_share")(FakeRun()) is None


def device_records():
    """Two device-route solves, the first with a warm partition."""
    def rec(spans, counters):
        out = [dict(name=name, parent=parent, start_ns=t0, end_ns=t1,
                    total_ns=t1 - t0, self_ns=0)
               for name, parent, t0, t1 in spans]
        return dict(solve=0, start_ns=0, end_ns=10**9, total_ns=10**9,
                    self_ns=0, counters=counters, dropped_spans=0,
                    spans=out)
    one = rec([("cp.solve", None, 0, 900_000_000),
               ("cp.warm", 0, 0, 300_000_000),
               ("cp.iter", 0, 300_000_000, 600_000_000),
               ("cp.device_cut", 2, 300_000_000, 400_000_000),
               ("cp.device_cut.wait", 3, 350_000_000, 400_000_000),
               ("cp.iter", 0, 600_000_000, 900_000_000),
               ("cp.device_cut", 5, 600_000_000, 650_000_000)],
              {"mincut.launches": 4, "mincut.steps": 3000})
    two = rec([("cp.solve", None, 0, 100_000_000),
               ("cp.iter", 0, 0, 100_000_000),
               ("cp.device_cut", 1, 0, 50_000_000)],
              {"mincut.launches": 2, "mincut.steps": 1000})
    return [one, two]


def test_device_readers_read_the_records(monkeypatch):
    monkeypatch.setattr(monitor, "trace_records", device_records)
    run = FakeRun()
    assert reader("warm_ms")(run) == pytest.approx(150.0)
    assert reader("device_cut_ms")(run) == pytest.approx(100.0)
    assert reader("pdhg_steps")(run) == pytest.approx(4000 / 6)
    names = ("warm_ms", "device_cut_ms", "pdhg_steps")
    # the host route's records hold none of their spans and counters
    monkeypatch.setattr(monitor, "trace_records", hand_records)
    assert all(reader(n)(run) is None for n in names)
    monkeypatch.setattr(monitor, "trace_records", device_records)
    run.traced_solves = 3
    assert all(reader(n)(run) is None for n in names)
    monkeypatch.setattr(monitor, "trace_records", list)
    assert all(reader(n)(FakeRun()) is None for n in names)
    monkeypatch.delattr(monitor, "trace_records")
    assert all(reader(n)(FakeRun()) is None for n in names)


# -- the port names the benchmark's traced runs wrap -------------------------

def wrapped_names():
    """``(module, attr)`` of every ``SPANS`` entry of the benchmark's
    families and every recorder target of ``harness/trace.py``."""
    names = []
    for path in sorted((BENCH / "families").glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"family_{path.stem}",
                                                      path)
        family = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(family)
        names += [(module, fn) for module, fn, _ in family.SPANS]
    for node in ast.walk(ast.parse((BENCH / "harness/trace.py").read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "Recorder"
                and all(isinstance(a, ast.Constant) for a in node.args[:2])):
            names.append((node.args[0].value, node.args[1].value))
    return names


def test_every_name_the_benchmark_wraps_is_in_the_port(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    names = wrapped_names()
    assert ("solvers.cut_pursuit", "fused_pfdr_solve_small") in names
    assert ("solvers.cut_pursuit", "_steepest_cut") in names
    for module, attr in names:
        mod = importlib.import_module(f"{PORT}.{module}")
        assert callable(getattr(mod, attr, None)), f"{module}.{attr}"


def test_the_solve_small_recorder_reads_the_kernel_route(monkeypatch):
    """The benchmark's recorder of ``solve_small`` launches reads the
    positional arguments of ``_kernel_solve``'s call."""
    monkeypatch.syspath_prepend(str(BENCH))
    trace = importlib.import_module("harness.trace")
    with_fused(monkeypatch, "on")
    rec = trace.solve_small_recorder()
    rec.on = True
    try:
        solve(problem(3))
    finally:
        rec.restore()
    assert rec.records
    for kind, rv_cap, n_edges, n_rows, size, its in rec.records:
        assert (kind, n_rows, size) in (("dense", N, 4), ("gram", 0, 4))
        assert rv_cap >= 128 and n_edges >= 128 and int(its) > 0


# -- the card ----------------------------------------------------------------

@pytest.mark.card
def test_a_span_brackets_its_kernel_on_the_profilers_clock():
    """A port span around one kernel launch and a synchronise, in a CPU and
    CUDA profile, brackets that kernel's device interval within 50 us in
    each of five profiles after a first one (a process's first profile can
    place the card's events a tenth of a millisecond early), and ends
    within 50 us of the kernel's end in at least one: the host may wake
    late from the synchronise, a clock offset would show in every
    profile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(4096, 4096, device="cuda")
    (x @ x).sum().item()

    @monitor.solve_entry("test.kernel")
    def one_launch():
        y = x @ x
        torch.cuda.synchronize()
        return y

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        one_launch()
    tol, tails = 50_000, []
    for _ in range(5):
        with profile(activities=activities) as prof:
            one_launch()
        span = monitor.trace_records()[-1]["spans"][0]
        assert span["name"] == "test.kernel"
        kernels = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and e.name() != "test.kernel"]
        start, end, name = max(kernels, key=lambda k: k[1] - k[0])
        print(f"kernel {name[:40]}: {(start - span['start_ns']) / 1e3:.1f} "
              f"us after the span's start, "
              f"{(span['end_ns'] - end) / 1e3:.1f} us before its end")
        assert span["start_ns"] - tol <= start
        assert end <= span["end_ns"] + tol
        tails.append(span["end_ns"] - end)
    assert min(tails) <= tol
