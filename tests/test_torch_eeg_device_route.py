"""Upstream's EEG fused LASSO on the port's device-resident cut-pursuit,
through the API users call (``api.cp_quadratic_d1_l1(..., cut=, chain=)``),
and the benchmark's configuration and cell that run it
(``eeg-fused-lasso-device``, ``eeg-fused-lasso.device-chain``).

On the CPU in float64, on a small sphere of the configuration's kind: the
chained and per-iteration device loops reach the host route's objective
within 1e-3 (the bound of ``tests/test_torch_cut_pursuit_device.py``'s
chain against the host route) and pass the benchmark's reference
(``benchmark/reference/fused_lasso.judge``) within the configuration's
limits; the API's defaults are the host route, bit for bit.
"""
import hashlib
import importlib
import inspect
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1, api

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CONFIG = "eeg-fused-lasso-device"
CELL = "eeg-fused-lasso.device-chain"
SEED = 2**31 + 11
# the small sphere: 12 x 20 vertices, 8 electrodes, patches wide enough to
# cover a few vertices each
SMALL = dict(n_theta=12, n_phi=20, n_electrodes=8, source_radius=0.4)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The benchmark's modules (``harness.spec``, ``harness.traffic``,
    ``harness.cell``), imported from ``benchmark/``."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(str(BENCH))
    mods = {m: importlib.import_module(f"harness.{m}")
            for m in ("spec", "traffic", "cell")}
    yield mods
    mp.undo()


def small_problem(harness, config: str = CONFIG, index: int = 1):
    """The configuration's problem on the small sphere: ``(config, phi,
    y0, y, lam, graph)`` in float64 on the CPU, sample ``index`` of the
    window."""
    spec, traffic = harness["spec"], harness["traffic"]
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    conf["mesh"].update(n_theta=SMALL["n_theta"], n_phi=SMALL["n_phi"])
    conf["n_electrodes"] = SMALL["n_electrodes"]
    mix = json.loads((BENCH / "traffic" / "eeg-samples.json").read_text())
    mix.update(source_radius=SMALL["source_radius"])
    eeg = traffic.EEG(conf, mix, SEED)
    y0, y = eeg.draw(traffic.WINDOW, 0), eeg.draw(traffic.WINDOW, index)
    lam = spec.load_module("reference", "fused_lasso").penalty(
        conf, eeg.phi, y0)
    m = conf["mesh"]
    graph = StencilGraphD1.create(
        (m["n_theta"], m["n_phi"]), {tuple(s): lam for s in m["shifts"]},
        wrap=tuple(m["wrap"]), dtype=torch.float64, device="cpu")
    return conf, eeg.phi, y0, y, lam, graph


def solve(conf, phi, y, lam, graph, **route):
    """``api.cp_quadratic_d1_l1`` with the configuration's upstream
    options, in float64 on the CPU; ``route`` the cut and chain keywords
    (none: the API's defaults)."""
    opts = {k: v for k, v in conf["options"].items()
            if k not in ("cut", "chain")}
    return api.cp_quadratic_d1_l1(
        y.astype(np.float64), phi.astype(np.float64), None, None, None,
        np.full(phi.shape[1], lam), graph=graph, device="cpu", **opts,
        **route)


def objective(conf, phi, y, lam, out, reference):
    m = conf["mesh"]
    eu, ev = reference.sphere_edges(m["n_theta"], m["n_phi"])
    return reference.objective(out.rX[out.Cv], phi.astype(np.float64),
                               y.astype(np.float64), eu, ev, lam)


@pytest.mark.parametrize("chain", ["on", "off"])
def test_device_route_through_the_api_matches_the_host_route(harness,
                                                             chain):
    conf, phi, y0, y, lam, graph = small_problem(harness)
    base = harness["spec"].load_module("reference", "fused_lasso")
    host = solve(conf, phi, y, lam, graph, cut="host")
    dev = solve(conf, phi, y, lam, graph, cut="device", chain=chain)
    f_host = objective(conf, phi, y, lam, host, base)
    f_dev = objective(conf, phi, y, lam, dev, base)
    assert f_dev <= f_host * (1 + 1e-3)
    assert f_host <= f_dev * (1 + 1e-3)
    assert dev.it >= 1 and dev.Cv.shape == (phi.shape[1],)
    limits = conf["check"]["limits"]
    judge = harness["spec"].load_module("reference", conf["reference"]).judge
    numbers = judge(conf, [dict(phi=phi, y=y, y0=y0)],
                    [dev.rX[dev.Cv].astype(np.float64)], "cpu")
    for name, limit in limits.items():
        assert numbers[name] <= limit, (name, numbers)


def test_the_api_defaults_are_the_host_route_bit_for_bit(harness):
    conf, phi, _, y, lam, graph = small_problem(harness, index=2)
    default = solve(conf, phi, y, lam, graph)
    host = solve(conf, phi, y, lam, graph, cut="host", chain="auto")
    assert default.it == host.it
    assert np.array_equal(default.Cv, host.Cv)
    assert np.array_equal(default.rX, host.rX)
    assert np.array_equal(default.Dif, host.Dif)
    with pytest.raises(TypeError):
        # keyword-only: the reference's positional layout is unchanged
        api.cp_quadratic_d1_l1(y, phi, None, None, None, None, False, 1e-4,
                               15, 1.5, 1e-3, 0.0, 1e-7, 10_000, 0, False,
                               False, None, graph, "auto", "cpu", "device")


@pytest.mark.parametrize("entry", ["cp_quadratic_d1_l1_AtA",
                                   "cp_l22_d1_l1"])
def test_sibling_entries_take_the_device_route(entry, monkeypatch):
    """``cut`` and ``chain`` reach :class:`CPOptions` from the two other
    l1 entries."""
    seen = []
    run = api._cp_run

    def record(op, obs, g, la_l1, positivity, bounds, duplex, opt, *rest):
        seen.append((opt.cut, opt.chain))
        return run(op, obs, g, la_l1, positivity, bounds, duplex, opt, *rest)

    monkeypatch.setattr(api, "_cp_run", record)
    r = np.random.default_rng(4)
    h, w = 6, 8
    idx = np.arange(h * w).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:].ravel()])
    la = np.full(eu.shape, 0.05)
    kw = dict(positivity=True, CP_itMax=3, PFDR_itMax=500, device="cpu")
    if entry == "cp_l22_d1_l1":
        y = r.normal(size=h * w)
        args = (y, None, eu, ev, la, 0.01)
    else:
        a = r.normal(size=(10, h * w)) / 3
        y = a.T @ r.normal(size=10)
        args = (y, a.T @ a, eu, ev, la, 0.01)
    getattr(api, entry)(*args, **kw)
    getattr(api, entry)(*args, cut="device", chain="off", **kw)
    assert seen == [("host", "auto"), ("device", "off")]


# -- the benchmark's configuration and cell -----------------------------------

# SHA-256 of the canonical JSON (``json.dumps(entries, sort_keys=True)``)
# of the entries that BENCHMARK.json held before the device-chain cell, and
# their number: a cell is added by appending entries, so these stay.
ENTRIES_BEFORE = {
    "configs": (1, "25aa7c069d4d8548d70bf53e12a375045655636feced50b10e99b3f33"
                   "d1bf339"),
    "workloads": (1, "48be907aa4ae70792e4e771e5393b97e15e029323f6fb9f34d196d"
                     "a0b58c5227"),
    "end_to_end": (2, "b133dadb7ce1c8965027f72b0ece11e6f99ce8c5769135ae27f9a"
                      "b3da52b93b4"),
    "per_layer": (9, "f26722ed91eaf328fcc997c5b9f27ea3f652fd0f1e4f22a65e81cd"
                     "f2e192c425"),
}
NEW_METRICS = ("warm_ms", "device_cut_ms", "pdhg_steps", "mincut_fused_ms",
               "mincut_fused_roofline")


def test_the_cell_loads_by_name_and_leaves_the_entries_before_it(harness):
    spec = harness["spec"]
    bench = spec.load_benchmark(ROOT)
    raw = json.loads((ROOT / "BENCHMARK.json").read_text())
    for section, (n, digest) in ENTRIES_BEFORE.items():
        got = json.dumps(raw[section][:n], sort_keys=True).encode()
        assert hashlib.sha256(got).hexdigest() == digest, section
    c = spec.load_cell(bench, CELL)
    assert c["entry"] == dict(c["entry"], config=CONFIG,
                              traffic="eeg-samples", chips=1)
    host = spec.load_cell(bench, "eeg-fused-lasso.host-cut")
    # the existing family, mix and judge; the reference adds its own
    # lower-precision solves as the control
    assert c["family"].__file__ == host["family"].__file__
    assert c["mix"] == host["mix"]
    assert inspect.getsourcefile(c["reference"].judge) == \
        host["reference"].__file__
    assert c["config"]["check"]["control"] == "reference:float16"
    # the cell's own metrics, then the reduced-solve kernel's schedule
    # share, which both cells report
    assert [m["name"] for m, _ in c["metrics"]["per_layer"]] == \
        list(NEW_METRICS) + ["resident_share"]
    assert [m["name"] for m, _ in c["metrics"]["end_to_end"]] == \
        ["solve_ms", "setup_s"]
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "solve_ms"
    # the same problem, held to the same answer: only the route and the
    # control differ
    conf, base = c["config"], host["config"]
    assert conf["options"] == dict(base["options"], cut="device",
                                   chain="auto")
    assert conf["check"] == dict(base["check"], control="reference:float16")
    own = ("name", "source", "reference", "options", "check", "assumed")
    assert {k: v for k, v in conf.items() if k not in own} == \
        {k: v for k, v in base.items() if k not in own}
    assert conf["name"] == CONFIG
    assert {"cut_tol", "cut_it_max", "chain_init_pfdr", "inexact_cap"} <= \
        set(conf["assumed"]["device_cut"].replace(",", " ").split())


@pytest.mark.parametrize("run", ["untraced", "traced", "control"])
def test_the_cell_runs_on_the_cpu_at_a_test_size(harness, tmp_path, run):
    """The cell through ``harness.cell.run`` on a copy of the benchmark at
    the small sphere, with ``chain="on"`` (``"auto"`` takes the chain on
    the card only): correct, and traced, the port's span and counter
    readers read a number (the card's kernel readers find nothing on the
    CPU); the configuration's control (the reference's own solves in
    float16) in the program's place reads not correct, over both
    limits."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    conf_path = tmp_path / "benchmark" / "configs" / f"{CONFIG}.json"
    conf = json.loads(conf_path.read_text())
    conf["mesh"].update(n_theta=SMALL["n_theta"], n_phi=SMALL["n_phi"])
    conf["n_electrodes"] = SMALL["n_electrodes"]
    conf["options"]["chain"] = "on"
    conf_path.write_text(json.dumps(conf))
    mix_path = tmp_path / "benchmark" / "traffic" / "eeg-samples.json"
    mix = json.loads(mix_path.read_text())
    mix.update(source_radius=SMALL["source_radius"], warmup_solves=1,
               trace_first=0, trace_solves=1)
    mix_path.write_text(json.dumps(mix))
    traced = run == "traced"
    result, lines, _ = harness["cell"].run(
        CELL, SEED, 0.3, traced, t_start_ns=time.perf_counter_ns(),
        device="cpu", root=tmp_path, bench_dir=tmp_path / "benchmark",
        control=run == "control")
    if run == "control":
        assert result["correct"] is False, lines
        for name, check in result["checks"].items():
            if name != "failed_solves":
                assert check["value"] > check["limit"], (name, lines)
        return
    assert result["correct"] and result["failed"] == 0, lines
    m = result["metrics"]
    if traced:
        for name in ("warm_ms", "device_cut_ms", "pdhg_steps"):
            assert m[name]["value"] > 0, (name, lines)
        assert "mincut_fused_ms" not in m
    else:
        assert m["solve_ms"]["value"] > 0 and m["setup_s"]["value"] > 0
