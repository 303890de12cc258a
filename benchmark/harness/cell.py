"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the check against the plain reference, and the result line.

The loop is closed: one client sends the next solve when the previous one
has returned.  The window starts after the warm-up and ends with the first
solve that returns once ``seconds`` have passed, so that it holds whole
solves only; ``solve_ms`` is its length over the solves it completed.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import roofline, spec, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "cp_pfdr_graph_d1_tpu")


class Run:
    """What the metric readers read (``benchmark/metrics/<name>.py``)."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.latencies_s = []      # host clock, call to result, per solve
        self.cp_iters = []         # CPResult.it / CPOutput.it per solve
        self.profile = None        # trace.reduce_profile of the slice
        self.traced_solves = 0
        self.launches = {}         # kernel -> [(bytes, operations)]

    @property
    def solves(self) -> int:
        return len(self.latencies_s)

    def kernel_ns(self, prefix: str):
        """``(device ns, events)`` of the kernels whose name, without its
        namespace, starts with ``prefix``, over the traced slice; None
        without a trace."""
        if self.profile is None:
            return None
        ns = n = 0
        for name, (t, c) in self.profile["kernels"].items():
            if trace.short_name(name).split("::")[-1].startswith(prefix):
                ns += t
                n += c
        return ns, n

    def roofline_share(self, kernel: str, prefix: str):
        """Percent: the mean least time of the recorded launches over
        their mean device time; None where either is missing."""
        work = self.launches.get(kernel)
        dev = self.kernel_ns(prefix)
        if not work or not dev or not dev[1] or not dev[0]:
            return None
        least = sum(roofline.bound_s(b, f)[0] for b, f in work) / len(work)
        return 100.0 * least / (dev[0] * 1e-9 / dev[1])


def modules_found(modules=None):
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package (whole names: the port's name only begins with the latter)."""
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_power(dev):
    """``"<name>, <power limit>"`` from nvidia-smi, or None off the card."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[dev.index or 0].strip() if lines else None


def answer(cv, rx) -> np.ndarray:
    """A solve's answer ``x = rX[Cv]``, in float64."""
    return np.asarray(rx, np.float64)[np.asarray(cv)]


def sample(records, seed: int, k: int, pool: int):
    """The solves to check: the slowest that completed, then one solve of
    each other pool entry that the window walked, the entries in an order
    and each solve drawn from the seed, ``k`` solves at most."""
    done = [r for r in records if r["cv"] is not None]
    if not done:
        return []
    slowest = max(done, key=lambda r: r["latency"])

    def entry(r):
        return traffic.pool_index(seed, pool, traffic.WINDOW, r["index"])
    by_entry = {}
    for r in done:
        if entry(r) != entry(slowest):
            by_entry.setdefault(entry(r), []).append(r)
    g = traffic.rng(seed, traffic.CHECK)
    entries = sorted(by_entry)
    picked = [slowest]
    for e in g.permutation(len(entries))[:k - 1]:
        solves = by_entry[entries[e]]
        picked.append(solves[int(g.integers(len(solves)))])
    return sorted(picked, key=lambda r: r["index"])


def verdict(numbers: dict, limits: dict, failed: int):
    """``(checks, correct)``: each number of ``limits`` beside its limit (a
    number the reference did not give reads ``inf``), and the solves that
    raised beside 0; correct where none is over its limit (NaN is)."""
    checks = {k: dict(value=numbers.get(k, float("inf")), limit=limit)
              for k, limit in limits.items()}
    checks["failed_solves"] = dict(value=failed, limit=0)
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def _program_switch(how: str):
    """The program's own lower-precision path that a control switches on:
    ``"tf32"``, TF32 matrix products (the port turns them off on import).
    Returns what restores the previous setting."""
    if how != "tf32":
        raise ValueError(f"unknown program control {how!r}")
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = True
    return lambda: setattr(matmul, "allow_tf32", prev)


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        t_start_ns: int, device="cuda", root=spec.ROOT,
        bench_dir=spec.BENCH_DIR, log=sys.stderr, control=False):
    """Runs the cell once; returns ``(result dict, check lines, Run)``.

    ``control``: run the configuration's control (``check.control``) in
    the program's place, through the same window, sample and verdict:
    ``"program:<switch>"`` runs the program with that lower-precision path
    on, ``"reference:<dtype>"`` hands the reference's own solves in that
    torch dtype to the check.  ``control.py`` uses it; ``run.py`` never."""
    bench = spec.load_benchmark(root)
    cell = spec.load_cell(bench, cell_name, bench_dir)
    config, mix, fam = cell["config"], cell["mix"], cell["family"]
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    side, how = (config["check"]["control"].split(":") if control
                 else (None, None))

    system = fam.System(config, mix, seed, dev)
    restore = _program_switch(how) if side == "program" else None
    for k in range(int(mix["warmup_solves"])):
        system.solve(system.inputs(traffic.WARMUP, k))
    _sync(dev)
    out = Run()
    out.setup_s = (time.perf_counter_ns() - t_start_ns) * 1e-9

    recorders, spans = [], trace.Spans()
    if traced:
        recorders = [trace.mincut_recorder(), trace.solve_small_recorder()]
        spans = trace.Spans(fam.SPANS)
    first = int(mix["trace_first"])
    n_trace = int(mix["trace_solves"])
    records, failed = [], 0
    prof = marker_ns = end_ns = None
    i = 0
    t0 = time.perf_counter()
    while True:
        if traced and i == first:
            from torch.profiler import ProfilerActivity, profile
            _sync(dev)
            # the card's activity; on the CPU (tests) the host's operators
            # stand in, so that the reduction runs end to end
            prof = profile(activities=[ProfilerActivity.CUDA
                                       if dev.type == "cuda"
                                       else ProfilerActivity.CPU])
            prof.start()
            _sync(dev)
            marker_ns = time.perf_counter_ns()
            torch.zeros(1, device=dev)
            for r in recorders:
                r.on = True
            spans.on = True
        td = time.perf_counter()
        with spans.span("draw"):
            obs = system.inputs(traffic.WINDOW, i)
        ta = time.perf_counter()
        try:
            with spans.span("solve"):
                cv, rx, it = system.solve(obs)
        except Exception:  # a solve that raises is a failed request
            traceback.print_exc(file=log)
            failed += 1
            cv = rx = it = None
        tb = time.perf_counter()
        records.append(dict(index=i, cv=cv, rx=rx, it=it, latency=tb - ta,
                            draw=ta - td))
        i += 1
        if prof is not None and end_ns is None and i == first + n_trace:
            _sync(dev)
            end_ns = time.perf_counter_ns()
            spans.on = False
            for r in recorders:
                r.on = False
            prof.stop()
        if tb - t0 >= seconds and (not traced or end_ns is not None):
            break
    out.window_s = tb - t0
    if restore is not None:
        restore()
    done = [r for r in records if r["cv"] is not None]
    out.latencies_s = [r["latency"] for r in done]
    out.cp_iters = [int(r["it"]) for r in done]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    if traced:
        out.traced_solves = n_trace
        out.profile = trace.reduce_profile(trace.device_events(prof, dev.type),
                                           marker_ns, end_ns, spans.spans)
        mc, ss = recorders
        out.launches["mincut_fused"] = [
            roofline.mincut_work(v, f, int(steps), size)
            for v, f, size, steps in mc.records]
        out.launches["solve_small"] = [
            roofline.solve_small_work(kind, rv_cap, ne, rows, int(its), size)
            for kind, rv_cap, ne, rows, size, its in ss.records]
        for r in recorders:
            r.restore()
        spans.restore()
        trace.check_recorders(recorders, out.kernel_ns)
        bound_by = {k: sorted({roofline.bound_s(*w)[1] for w in v})
                    for k, v in out.launches.items() if v}

    # the check, once the window has closed and the program's state is
    # freed: a sample of the solves against the plain reference
    system.close()
    del obs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    chk, ref = config["check"], cell["reference"]
    picked = sample(records, seed, int(chk["solves"]), int(mix["pool"]))
    handed = [system.handed(traffic.WINDOW, r["index"]) for r in picked]
    if side == "reference":
        answers = ref.control_answers(config, handed, dev, getattr(torch, how))
    else:
        answers = [answer(r["cv"], r["rx"]) for r in picked]
    numbers = ref.judge(config, handed, answers, dev) if picked else {}
    checks, correct = verdict(numbers, chk["limits"], failed)

    section = "per_layer" if traced else "end_to_end"
    metrics, silent = {}, []
    for m, reader in cell["metrics"][section]:
        value = reader.read(out)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        else:
            silent.append(m["name"])
    info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
                count=1, memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=len(records), failed=failed,
                  metrics=metrics, device=info)
    if traced and out.profile is not None:
        p = out.profile
        info["busy_s"] = p["busy_ns"] * 1e-9
        info["window_s"] = p["window_ns"] * 1e-9
        merged = {}
        for n, (t, _) in p["kernels"].items():
            short = trace.short_name(n)
            merged[short] = merged.get(short, 0.0) + t * 1e-9
        result["breakdown"] = dict(
            device_ops=[[n, t] for n, t in sorted(
                merged.items(), key=lambda t: -t[1])[:10]],
            idle_gaps=[[n, t * 1e-9] for n, t in sorted(
                p["idle_by"].items(), key=lambda t: -t[1])[:10]])
    card = card_power(dev)
    if card:
        result["card"] = card
    result["solves_checked"] = [r["index"] for r in picked]
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    draw_ms = 1e3 * sum(r["draw"] for r in records) / len(records)
    lines.insert(0, f"info: {len(records)} solves in {out.window_s:.3f} s, "
                    f"drawing the inputs {draw_ms:.3f} ms a solve (host "
                    f"clock, in the window); card {card}")
    if traced:
        lines.insert(1, f"info: roofline shares bound by {bound_by} "
                        f"(peaks at 700 W; card {card})")
        if spans.missing:
            lines.insert(1, f"info: the port has none of {spans.missing}; "
                            f"their time is labelled by the enclosing span")
    if silent:
        lines.insert(1, f"info: found nothing to read: {silent}")
    shown = {k: v for k, v in numbers.items() if k not in chk["limits"]}
    if shown:
        lines.insert(1, f"info: the reference's numbers not compared: {shown}")
    if control:
        lines.insert(1, f"info: the control {chk['control']!r} in the "
                        f"program's place")
    return result, lines, out


def emit(result: dict, lines, log=sys.stderr):
    """The check lines last on standard error, the result last on standard
    output."""
    for ln in lines:
        print(ln, file=log)
    log.flush()
    print(json.dumps(result), flush=True)
