"""CPU tests of the benchmark's harness (``benchmark/``): loading by name,
the traffic generator, the frozen roofline arithmetic, the plain references
against the port, the controls and planted faults, and the refusal to run
without a card.  Run with ``python -m pytest benchmark/tests``; a test that
needs the card decides so inside the test."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))

from harness import cell, roofline, spec, trace, traffic  # noqa: E402

BENCH_CELLS = tuple(w["name"] for w in spec.load_benchmark(ROOT)["workloads"])
SEED = 2**31 + 11

# A denoising cell of the test copy only (no public deployment fixes its
# settings yet): the ROF family, its reference and the cut's metrics run
# end to end through files and entries added to the copy.
TEST_ROF = {
    "name": "test-rof", "family": "rof", "reference": "rof",
    "dtype": "float32", "shifts": [[0, 1], [1, 0]], "weight": 0.35,
    "cp": {"dif_tol": 1e-4, "it_max": 12, "cut": "device", "chain": "off",
           "cut_tol": 1e-5, "cut_it_max": 50000},
    "pfdr": {"rho": 1.8, "dif_tol": 1e-5, "it_max": 2000},
    "check": {"control": "reference:bfloat16", "solves": 3,
              "reference_iters": 3000,
              "limits": {"objective_excess": 1e-2}}}
TEST_CARTOON = {
    "kind": "cartoon", "pool": 8, "pool_seed": 5, "side": 48, "rects": 12,
    "rect_size": [6, 14], "value": [0.3, 1.5], "margin_lo": 4,
    "margin_hi": 16, "noise_sigma": 0.15, "warmup_solves": 1,
    "trace_first": 1, "trace_solves": 2}
ROF_CELL = "test-rof.48"
CELLS = (ROF_CELL, "eeg-fused-lasso.host-cut")


def add_cell(root: Path, config: dict, mix_name: str, mix: dict,
             cell: str, end_to_end=(), per_layer=()):
    """Adds a configuration, a mix and a cell to the copy at ``root`` as
    new files and entries, and lists the cell under every metric of its
    cells' kind plus the named ones."""
    b = root / "benchmark"
    (b / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (b / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name=config["name"], source="a test", reduced=[], why="a test",
        file=f"benchmark/configs/{config['name']}.json"))
    bench["workloads"].append(dict(name=cell, config=config["name"],
                                   traffic=mix_name, chips=1, why="a test"))
    for section, extra in (("end_to_end", end_to_end),
                           ("per_layer", per_layer)):
        have = {m["name"] for m in bench[section]}
        for m in bench[section]:
            if "workloads" in m and m["name"] not in ("solve_small_roofline",):
                m["workloads"].append(cell)
        for m in extra:
            if m["name"] not in have:
                bench[section].append(dict(m, workloads=[cell]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def tiny_copy(dst: Path) -> Path:
    """A checkout of BENCHMARK.json and benchmark/ whose cells run in
    seconds on the CPU: the same files at test sizes, and the denoising
    test cell added."""
    shutil.copytree(BENCH_DIR, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")

    def edit(rel, fn):
        p = dst / "benchmark" / rel
        d = json.loads(p.read_text())
        fn(d)
        p.write_text(json.dumps(d))

    edit("traffic/eeg-samples.json", lambda m: m.update(
        source_radius=0.4, warmup_solves=1, trace_first=1, trace_solves=2))
    edit("configs/eeg-fused-lasso.json", lambda c: (
        c["mesh"].update(n_theta=16, n_phi=24), c.update(n_electrodes=12)))
    add_cell(dst, TEST_ROF, "test-cartoon", TEST_CARTOON, ROF_CELL,
             end_to_end=[dict(name="solve_ms_p95", unit="ms",
                              better="lower", bound=0.25,
                              source="host_clock")],
             per_layer=[dict(name=n, unit=u, better=b,
                             source="device_trace", layer="cut kernel",
                             moves="solve_ms")
                        for n, u, b in (("mincut_fused_ms", "ms", "lower"),
                                        ("mincut_fused_roofline", "%",
                                         "higher"))])
    return dst


def run_tiny(root: Path, name: str, traced=False, seconds=0.3, seed=SEED,
             control=False):
    return cell.run(name, seed, seconds, traced,
                    t_start_ns=time.perf_counter_ns(), device="cpu",
                    root=root, bench_dir=root / "benchmark", control=control)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


# -- names, files, loading ---------------------------------------------------

def test_benchmark_json_names_and_units():
    bench = spec.load_benchmark(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("bad", ["a b", "x,y", "a/b", "", "-a", "é"])
def test_bad_names_are_refused(bad):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"][0]["name"] = bad
    with pytest.raises(ValueError):
        spec.validate(bench)


@pytest.mark.parametrize("name", BENCH_CELLS)
def test_cells_load_by_name(name):
    bench = spec.load_benchmark(ROOT)
    c = spec.load_cell(bench, name)
    assert c["family"].System and c["reference"].judge
    assert c["config"]["name"] == c["entry"]["config"]
    e2e = [m["name"] for m, _ in c["metrics"]["end_to_end"]]
    assert "solve_ms" in e2e and "setup_s" in e2e
    assert c["metrics"]["per_layer"]


def test_new_config_mix_and_metric_are_files_alone(tmp_path):
    """A dummy configuration, mix and metric, added as new files and
    entries only, run through the harness."""
    root = tiny_copy(tmp_path)
    (root / "benchmark/metrics/dummy_solves.py").write_text(
        "def read(run):\n    return run.solves\n")
    add_cell(root, dict(TEST_ROF, name="dummy-rof"), "dummy-mix",
             dict(TEST_CARTOON, side=32, rects=2), "dummy-rof.32",
             end_to_end=[dict(name="dummy_solves", unit="solves",
                              better="higher", bound=0.1,
                              source="host_clock")])
    result, _, _ = run_tiny(root, "dummy-rof.32")
    assert result["metrics"]["dummy_solves"]["value"] >= 1
    assert result["correct"]


# -- traffic -----------------------------------------------------------------

def test_cartoon_is_deterministic_in_seed_and_index():
    mix = dict(TEST_CARTOON, side=64, margin_hi=20, rect_size=[6, 16])
    a = traffic.Cartoon(mix, SEED, "cpu", torch.float32)
    b = traffic.Cartoon(mix, SEED, "cpu", torch.float32)
    assert torch.equal(a.draw(traffic.WINDOW, 3), b.draw(traffic.WINDOW, 3))
    assert not torch.equal(a.draw(traffic.WINDOW, 3),
                           a.draw(traffic.WINDOW, 4))
    assert not torch.equal(a.draw(traffic.WINDOW, 0),
                           a.draw(traffic.WARMUP, 0))
    c = traffic.Cartoon(mix, SEED + 1, "cpu", torch.float32)
    assert not torch.equal(a.draw(traffic.WINDOW, 3),
                           c.draw(traffic.WINDOW, 3))


def test_eeg_samples_are_deterministic_and_share_the_geometry():
    conf = json.loads((BENCH_DIR / "configs/eeg-fused-lasso.json")
                      .read_text())
    mix = json.loads((BENCH_DIR / "traffic/eeg-samples.json").read_text())
    a, b = traffic.EEG(conf, mix, SEED), traffic.EEG(conf, mix, SEED)
    c = traffic.EEG(conf, mix, 7)
    assert a.phi.shape == (91, 19800) and a.phi.dtype == np.float32
    assert np.array_equal(a.draw(0, 5), b.draw(0, 5))
    assert not np.array_equal(a.draw(0, 5), a.draw(0, 6))
    assert not np.array_equal(a.draw(0, 5), c.draw(0, 5))
    assert np.array_equal(a.phi, c.phi)


# -- the frozen roofline arithmetic -------------------------------------------

def test_roofline_reproduces_the_kernel_table():
    # 724 x 724, two families, one 250-step cut: 51.9 us (operations)
    t, by = roofline.bound_s(*roofline.mincut_work(724 * 724, 2, 250))
    assert by == "operations" and round(t * 1e6, 1) == 51.9
    # dense reduced solve, rv 2641 in rv_cap 4096, 8192 edges, 91 rows,
    # 300 iterations: 7.74 us (operations)
    t, by = roofline.bound_s(*roofline.solve_small_work(
        "dense", 4096, 8192, 91, 300))
    assert by == "operations" and round(t * 1e6, 2) == 7.74


# -- no JAX ------------------------------------------------------------------

def test_forbidden_modules_compare_whole_top_level_names():
    assert cell.modules_found(["cp_pfdr_graph_d1_tpu_torch.ops", "jaxtyping",
                               "numpy"]) == []
    assert cell.modules_found(["jax.numpy", "cp_pfdr_graph_d1_tpu.api",
                               "flax"]) == ["cp_pfdr_graph_d1_tpu", "flax",
                                            "jax"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    import ast
    for path in BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in cell.FORBIDDEN + ("bench",), (path, n)
                if path.parent.name == "reference":
                    assert top != "cp_pfdr_graph_d1_tpu_torch", (path, n)


def test_a_run_loads_no_jax(tiny):
    code = (
        "import sys, time; t=time.perf_counter_ns();"
        f"sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}];"
        "from harness import cell;"
        f"cell.run({ROF_CELL!r}, 5, 0.1, False, t_start_ns=t, "
        f"device='cpu', root=__import__('pathlib').Path({str(tiny)!r}), "
        f"bench_dir=__import__('pathlib').Path({str(tiny)!r}) / 'benchmark');"
        "print(cell.modules_found())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- the command refuses the CPU ---------------------------------------------

def test_run_py_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown here")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", BENCH_CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


# -- rehearsal of both cells on the CPU --------------------------------------

@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_correct(tiny, name, traced):
    result, lines, _ = run_tiny(tiny, name, traced)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert lines[-1].startswith("check failed_solves")
    assert result["checks"]["failed_solves"] == dict(value=0, limit=0)
    m = result["metrics"]
    if traced:
        assert "cp_iters" in m and "idle_share" in m
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    else:
        assert m["solve_ms"]["value"] > 0 and m["setup_s"]["value"] > 0
        assert ("solve_ms_p95" in m) == (name == ROF_CELL)


def test_reduce_profile_unions_and_labels_gaps():
    ev = [("marker", 1000, 1010), ("k1", 2000, 3000), ("k2", 2500, 3500),
          ("k1", 6000, 7000)]
    spans = [("solve", 1600, 7400), ("host_cut", 4000, 5000)]
    p = trace.reduce_profile(ev, 1000, 8000, spans)
    assert p["window_ns"] == 7000
    assert p["busy_ns"] == 10 + 1500 + 1000
    assert p["kernels"]["k1"] == (2000, 2)
    assert p["idle_by"]["host_cut"] == 2500      # 3500 .. 6000
    assert p["idle_by"]["harness"] == 990 + 1000  # 1010 .. 2000, 7000 .. 8000


# -- the plain references against the port, the controls and faults -----------

def test_rof_reference_agrees_with_the_port_in_float64():
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, IdentityOp,
                                            PFDROptions, StencilGraphD1)
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1
    ref = spec.load_module("reference", "rof")
    conf = TEST_ROF
    mix = dict(TEST_CARTOON, side=40, rect_size=[5, 12], margin_lo=3,
               margin_hi=14, rects=3)
    y = traffic.Cartoon(mix, SEED, "cpu", torch.float64).draw(0, 0)
    g = StencilGraphD1.create((40, 40), {(0, 1): 0.35, (1, 0): 0.35},
                              dtype=torch.float64, device="cpu")
    opt = CPOptions(dif_tol=1e-6, it_max=40, cut="device", chain="off",
                    cut_tol=1e-8, pfdr=PFDROptions(rho=1.8, dif_tol=1e-9,
                                                   it_max=20000))
    res = cp_quadratic_d1(IdentityOp(), y, g, opt=opt)
    x = res.rx[res.cv]
    numbers = ref.judge(dict(conf, check=dict(conf["check"],
                                              reference_iters=20000)),
                        [dict(y=y.reshape(40, 40))], [x], "cpu")
    assert abs(numbers["objective_excess"]) < 1e-7


def test_fused_lasso_reference_agrees_with_the_port_in_float64():
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1, api
    ref = spec.load_module("reference", "fused_lasso")
    conf = json.loads((BENCH_DIR / "configs/eeg-fused-lasso.json")
                      .read_text())
    conf["mesh"].update(n_theta=16, n_phi=24)
    conf["n_electrodes"] = 12
    mix = json.loads((BENCH_DIR / "traffic/eeg-samples.json").read_text())
    mix.update(source_radius=0.4)
    eeg = traffic.EEG(conf, mix, SEED)
    y0, y = eeg.draw(0, 0), eeg.draw(0, 1)
    lam = ref.penalty(conf, eeg.phi, y0)
    g = StencilGraphD1.create((16, 24), {(0, 1): lam, (1, 0): lam,
                                         (1, 1): lam}, wrap=(False, True),
                              dtype=torch.float64, device="cpu")
    opts = dict(conf["options"], CP_difTol=1e-7, PFDR_difTol=1e-10,
                PFDR_itMax=100000)
    out = api.cp_quadratic_d1_l1(
        y.astype(np.float64), eeg.phi.astype(np.float64), None, None, None,
        np.full(eeg.num_v, lam), graph=g, device="cpu", **opts)
    x = out.rX[out.Cv]
    numbers = ref.judge(dict(conf, check=dict(conf["check"],
                                              reference_iters=40000)),
                        [dict(phi=eeg.phi, y=y, y0=y0)], [x], "cpu")
    assert abs(numbers["objective_excess"]) < 1e-6
    assert numbers["stationarity"] < 1e-6


def test_rof_control_in_bfloat16_fails_the_limit(tiny):
    """The reference in bfloat16 in the program's place, through the run's
    own window, sample and verdict, reads not correct; the program, on the
    same seed, correct."""
    result, lines, _ = run_tiny(tiny, ROF_CELL, control=True)
    assert result["correct"] is False, lines
    limit = TEST_ROF["check"]["limits"]["objective_excess"]
    assert result["checks"]["objective_excess"]["value"] > limit
    assert any("the control 'reference:bfloat16'" in ln for ln in lines)
    assert run_tiny(tiny, ROF_CELL)[0]["correct"]


def test_eeg_control_with_tf32_on_the_card():
    """At the cell's own size and load, through ``control.py``: the program
    reads correct, the program with TF32 products on reads not correct."""
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload",
         "eeg-fused-lasso.host-cut", "--seeds", "3", "--control-seeds", "3"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = {r["kind"]: r for r in map(json.loads, out.stdout.splitlines())}
    assert rows["program"]["correct"] is True, rows
    assert rows["control"]["correct"] is False, rows
    assert len(rows["control"]["checked"]) == 16


# -- the sample checked, the verdict, the trace's hooks ------------------------

def test_sample_takes_the_slowest_and_one_solve_of_each_pool_entry():
    pool = 4
    records = [dict(index=i, cv=np.zeros(1, int), latency=1.0 + (i == 9))
               for i in range(11)] + [dict(index=11, cv=None, latency=9.0)]
    picked = cell.sample(records, SEED, pool, pool)
    assert 9 in [r["index"] for r in picked]
    entries = [traffic.pool_index(SEED, pool, traffic.WINDOW, r["index"])
               for r in picked]
    assert sorted(entries) == list(range(pool))
    assert [r["index"] for r in picked] == \
        [r["index"] for r in cell.sample(records, SEED, pool, pool)]
    assert len(cell.sample(records, SEED, 2, pool)) == 2
    assert cell.sample(records[-1:], SEED, pool, pool) == []


def test_verdict():
    limits = {"a": 1e-5, "b": 1e-3}
    assert cell.verdict({"a": 1e-6, "b": 1e-4}, limits, 0)[1]
    assert not cell.verdict({"a": 2e-5, "b": 1e-4}, limits, 0)[1]
    assert not cell.verdict({"a": float("nan"), "b": 1e-4}, limits, 0)[1]
    assert not cell.verdict({"a": 1e-6}, limits, 0)[1]
    checks, ok = cell.verdict({"a": 1e-6, "b": 1e-4}, limits, 1)
    assert not ok and checks["failed_solves"] == dict(value=1, limit=0)
    assert list(checks) == ["a", "b", "failed_solves"]


def test_a_recorder_that_sees_no_launch_of_a_running_kernel_stops_the_run():
    rec = trace.solve_small_recorder()
    try:
        ran = {"solve_small": (5000, 3)}
        with pytest.raises(RuntimeError, match="solve_small"):
            trace.check_recorders([rec], lambda p: ran.get(p, (0, 0)))
        # a kernel taken off the path leaves its metric silent
        trace.check_recorders([rec], lambda p: (0, 0))
        rec.records.append(("dense", 8, 8, 2, 4, 10))
        trace.check_recorders([rec], lambda p: ran.get(p, (0, 0)))
    finally:
        rec.restore()
    gone = trace.Recorder("solvers.cut_pursuit", "no_such_wrapper",
                          "solve_small", None)
    with pytest.raises(RuntimeError, match="has no such attribute"):
        trace.check_recorders([gone], lambda p: (1, 1))


def test_spans_leave_out_a_function_the_port_no_longer_has():
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit
    orig = cut_pursuit._merge_close
    spans = trace.Spans([("solvers.cut_pursuit", "no_such_function", "x"),
                         ("solvers.cut_pursuit", "_merge_close", "merge")])
    try:
        assert spans.missing == ["solvers.cut_pursuit.no_such_function"]
        assert cut_pursuit._merge_close is not orig
    finally:
        spans.restore()
    assert cut_pursuit._merge_close is orig


def _fault_state_unchanged(monkeypatch):
    """The reduced solve hands its warm start back unchanged."""
    from cp_pfdr_graph_d1_tpu_torch.solvers import (cut_pursuit,
                                                    cut_pursuit_device)

    class Same:
        def __init__(self, x0):
            self.x, self.it = x0, 1

    def same(*args, x0=None, **kw):
        return Same(x0)
    for mod in (cut_pursuit, cut_pursuit_device):
        monkeypatch.setattr(mod, "pfdr_quadratic_d1", same)


def _fault_half_left_out(monkeypatch):
    """Half of the data left out, the mean of the rest in its place."""
    from cp_pfdr_graph_d1_tpu_torch import api
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit

    def halve(y):
        y = y.clone() if isinstance(y, torch.Tensor) else np.array(y)
        h = len(y) // 2
        y[h:] = y[:h].mean()
        return y
    orig_cp, orig_api = cut_pursuit.cp_quadratic_d1, api.cp_quadratic_d1_l1
    monkeypatch.setattr(cut_pursuit, "cp_quadratic_d1",
                        lambda op, obs, g, **kw: orig_cp(op, halve(obs), g,
                                                         **kw))
    monkeypatch.setattr(api, "cp_quadratic_d1_l1",
                        lambda y, *a, **kw: orig_api(halve(y), *a, **kw))


def _fault_answer_altered(monkeypatch):
    """The largest part's value moved by 0.05 where the solver returns."""
    from cp_pfdr_graph_d1_tpu_torch import api
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit

    def alter(cv, rx):
        rx = np.array(rx)
        rx[np.bincount(cv).argmax()] += 0.05
        return rx
    orig_cp, orig_api = cut_pursuit.cp_quadratic_d1, api.cp_quadratic_d1_l1

    def cp(*a, **kw):
        res = orig_cp(*a, **kw)
        return res._replace(rx=alter(res.cv, res.rx))

    def eeg(*a, **kw):
        out = orig_api(*a, **kw)
        return out._replace(rX=alter(out.Cv, out.rX))
    monkeypatch.setattr(cut_pursuit, "cp_quadratic_d1", cp)
    monkeypatch.setattr(api, "cp_quadratic_d1_l1", eeg)


@pytest.mark.parametrize("fault", [_fault_state_unchanged,
                                   _fault_half_left_out,
                                   _fault_answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_reads_not_correct(tiny, monkeypatch, fault,
                                               name):
    fault(monkeypatch)
    result, lines, _ = run_tiny(tiny, name)
    assert result["correct"] is False, lines
