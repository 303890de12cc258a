"""What a traced run (``--trace 1``) reads, and its reduction to numbers.

* :class:`Recorder`: thin wrappers installed, for the traced slice only,
  where the solvers call a kernel's wrapper (``mincut_fused``,
  ``solve_small``); each keeps the launch's shapes and the 0-d tensor of
  steps or iterations the kernel returned, read once the window has closed.
  No synchronisation is added.  They wrap names inside the port: where the
  card ran the kernel and the recorder saw no call, the run stops with a
  message (:func:`check_recorders`) rather than leave a roofline silent.
* :class:`Spans`: host spans around functions of the port and around the
  harness's own steps, on the host's clock, to say what the host was doing
  while the card idled.  A function the port no longer has is left out and
  named in the run's information lines.
* :func:`reduce_profile`: torch.profiler's device events of the slice
  (CUDA activity only) to busy time, time per kernel and idle gaps.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from collections import defaultdict

PORT = "cp_pfdr_graph_d1_tpu_torch"


class Recorder:
    """Wraps ``module.attr`` (a kernel wrapper) for the traced slice; each
    call appends ``describe(args, kwargs, out)`` to ``records``.
    ``kernel`` is the prefix of the kernel's name on the card: a slice in
    which the card ran that kernel and the recorder saw no call means that
    the port no longer calls the wrapper by this name (see
    :func:`check_recorders`)."""

    def __init__(self, module: str, attr: str, kernel: str, describe):
        self.module = importlib.import_module(f"{PORT}.{module}")
        self.attr = attr
        self.kernel = kernel
        self.target = f"{PORT}.{module}.{attr}"
        self.orig = getattr(self.module, attr, None)
        self.describe = describe
        self.records = []
        self.on = False
        if self.orig is None:
            return

        def wrapped(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            if self.on:
                self.records.append(self.describe(args, kwargs, out))
            return out

        # the wrapper takes over the function's attributes (its launch
        # counter, which a function of its own module may update through
        # the module's name), and hands them back on restore
        wrapped.__dict__.update(self.orig.__dict__)
        self.wrapped = wrapped
        setattr(self.module, attr, wrapped)

    def restore(self):
        if self.orig is None:
            return
        self.orig.__dict__.update(self.wrapped.__dict__)
        setattr(self.module, self.attr, self.orig)


def check_recorders(recorders, kernel_ns) -> None:
    """Raises where the traced slice ran a recorder's kernel on the card
    and the recorder saw no call: its roofline would read nothing although
    the kernel ran.  ``kernel_ns(prefix)`` gives ``(ns, launches)``.  A
    kernel that did not run at all (taken off the path) leaves its metric
    silent instead."""
    for r in recorders:
        dev = kernel_ns(r.kernel)
        if r.records or not dev or not dev[1]:
            continue
        how = ("has no such attribute" if r.orig is None
               else "was not called through it")
        raise RuntimeError(
            f"trace: the card ran {dev[1]} {r.kernel}* kernel(s) in the "
            f"traced slice, but {r.target} {how}, so the launches' steps "
            f"or iterations cannot be read: the port moved or renamed the "
            f"wrapper that benchmark/harness/trace.py records")


def mincut_recorder() -> Recorder:
    """``ops.mincut_fused.fused_pdhg_min_cut``, where
    ``device_cut_stencil_fused`` calls it: (cells, families, itemsize,
    steps tensor)."""
    def describe(args, kwargs, out):
        x0 = args[4]
        return (x0.numel(), len(kwargs["shifts"]), x0.element_size(), out[4])
    return Recorder("ops.mincut_fused", "fused_pdhg_min_cut", "mincut",
                    describe)


def solve_small_recorder() -> Recorder:
    """``fused_pfdr_solve_small`` as ``solvers.cut_pursuit._kernel_solve``
    calls it: (operator kind, rv_cap, edges, operator rows, itemsize,
    iterations tensor)."""
    def describe(args, kwargs, out):
        op_kind, op, x0, eu = args[0], args[1], args[5], args[8]
        n_rows = op.shape[0] if op_kind == "dense" else 0
        return (op_kind, x0.shape[0], eu.shape[0], n_rows,
                x0.element_size(), out[2])
    return Recorder("solvers.cut_pursuit", "fused_pfdr_solve_small",
                    "solve_small", describe)


class Spans:
    """Host spans: ``(label, start_ns, end_ns)`` on ``perf_counter_ns``."""

    def __init__(self, targets=()):
        self.spans = []
        self.on = False
        self.missing = []      # targets the port no longer has
        self._restore = []
        for module, fn, label in targets:
            mod = importlib.import_module(f"{PORT}.{module}")
            orig = getattr(mod, fn, None)
            if orig is None:
                # its time is then labelled by the enclosing span
                self.missing.append(f"{module}.{fn}")
                continue
            setattr(mod, fn, self._wrap(orig, label))
            self._restore.append((mod, fn, orig))

    def _wrap(self, fn, label):
        def wrapped(*args, **kwargs):
            with self.span(label):
                return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def span(self, label):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if self.on:
                self.spans.append((label, t0, time.perf_counter_ns()))

    def restore(self):
        for mod, fn, orig in self._restore:
            setattr(mod, fn, orig)


def device_events(prof, device_type: str = "cuda"):
    """``[(name, start_ns, end_ns)]`` of every kernel, copy and memset the
    profiler saw on the card (``device_type`` "cpu": every host operator),
    in start order."""
    from torch.autograd import DeviceType
    want = DeviceType.CUDA if device_type == "cuda" else DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:   # older torch: microseconds
            start, dur = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        out.append((e.name(), start, start + dur))
    out.sort(key=lambda t: t[1])
    return out


def _union(intervals):
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def short_name(name: str, width: int = 60) -> str:
    """A kernel's name without its template arguments and parameters."""
    base = name.split("(")[0]
    if "<" in base:
        base = base.split("<")[0]
    base = base.replace("void ", "").strip() or name
    return base[:width]


def reduce_profile(events, marker_host_ns: int, end_host_ns: int, spans):
    """Busy time, time by kernel and idle gaps of the traced slice.

    ``events``: :func:`device_events`, the first being the marker that the
    harness launched at host time ``marker_host_ns`` on an idle card; the
    slice ends at host time ``end_host_ns`` (after a synchronise).  Idle
    gaps are labelled by the innermost host span that covers their middle
    (``"harness"`` if none)."""
    if not events:
        return None
    offset = events[0][1] - marker_host_ns     # device clock - host clock
    start = events[0][1]
    end = end_host_ns + offset
    body = [(n, s, e) for n, s, e in events[1:] if s < end]
    busy = _union([(max(s, start), min(e, end)) for _, s, e in events])
    busy_ns = sum(e - s for s, e in busy)
    by_name = defaultdict(lambda: [0, 0])
    for n, s, e in body:
        by_name[n][0] += e - s
        by_name[n][1] += 1
    gaps = []
    prev = start
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if end > prev:
        gaps.append((prev, end))
    hs = sorted(((s + offset, e + offset, lab) for lab, s, e in spans),
                key=lambda t: t[0])
    starts = [s for s, _, _ in hs]
    idle_by = defaultdict(int)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "harness"
        # the innermost span over the middle is the latest-starting one
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if hs[k][1] >= mid:
                label = hs[k][2]
                break
        idle_by[label] += g1 - g0
    return dict(window_ns=end - start, busy_ns=busy_ns,
                kernels={n: tuple(v) for n, v in by_name.items()},
                idle_by=dict(idle_by), n_events=len(body))
