"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

* ``benchmark/configs/<config>.json``: the configuration; its ``family``
  names the driver ``benchmark/families/<family>.py`` (how the port is
  called) and its ``reference`` the plain reference
  ``benchmark/reference/<reference>.py``;
* ``benchmark/traffic/<traffic>.json``: the traffic mix, read by
  :mod:`.traffic`;
* ``benchmark/metrics/<metric>.py``: one reader per metric, end-to-end and
  per-layer alike, each a ``read(run)`` that returns a number or None.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _check_name(kind: str, name) -> str:
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} is not 1-64 of [A-Za-z0-9_.-] "
                         f"starting with a letter, digit or '_'")
    return name


def validate(bench: dict) -> None:
    """Raises on a name, unit or reference that the contract refuses."""
    seen = set()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            name = _check_name(section, entry["name"])
            key = "metric" if section in ("end_to_end", "per_layer") \
                else section
            if (key, name) in seen:
                raise ValueError(f"two {section} entries are named {name!r}")
            seen.add((key, name))
    configs = {c["name"] for c in bench["configs"]}
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        for k in c["reduced"]:
            _check_name("reduced key", k)
    for w in bench["workloads"]:
        _check_name("config", w["config"])
        _check_name("traffic", w["traffic"])
        if w["config"] not in configs:
            raise ValueError(f"cell {w['name']} names no configuration")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT_RE.fullmatch(m["unit"]):
            raise ValueError(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            raise ValueError(f"metric {m['name']}: better {m['better']!r}")
        for cell in m.get("workloads", ()):
            if cell not in cells:
                raise ValueError(f"metric {m['name']} lists unknown cell "
                                 f"{cell!r}")


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from the checkout's "
                                f"root")
    bench = json.loads(path.read_text())
    validate(bench)
    return bench


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """``benchmark/<kind>/<name>.py`` as a module (the file's name may hold
    '.' and '-', so it is loaded by path)."""
    path = bench_dir / kind / f"{_check_name(kind, name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` that ``cell`` reports: those that list it
    under ``workloads``, or that have no such list."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(bench: dict, cell: str, bench_dir: Path = BENCH_DIR) -> dict:
    """Everything one cell needs: its entry, configuration, mix, family
    driver, reference and the readers of the metrics it reports."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    entry = work[cell]
    conf_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = _json(bench_dir.parent / conf_entry["file"])
    mix = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    metrics = {}
    for section in ("end_to_end", "per_layer"):
        metrics[section] = [(m, load_module("metrics", m["name"], bench_dir))
                            for m in metrics_of(bench, section, cell)]
    return dict(entry=entry, config=config, mix=mix,
                family=load_module("families", config["family"], bench_dir),
                reference=load_module("reference", config["reference"],
                                      bench_dir),
                metrics=metrics)
