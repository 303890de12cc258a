"""Monitoring utilities (counterpart of
``cp_pfdr_graph_d1_tpu.utils.monitor``).

The reference's only instrumentation is wall-clock ``Time[]``, objective
``Obj[]`` and evolution ``Dif[]`` arrays plus printf progress
(``CP_PFDR_graph_quadratic_d1_l1.cpp:255-258,323-329``).  The solvers
return the same trace arrays (:class:`SolveTrace` summarizes them), and
:func:`profile` records a ``torch.profiler`` trace of a solve.

While a ``torch.profiler`` records (:func:`profile`, or any other), each
solve also records its stages: spans ``(name, parent, start, end)`` and
counters, kept in memory and returned by :func:`trace_records`.  A solve
asks once, at its entry (:func:`solve_entry`), whether a profiler records;
when none does, every :func:`span` and :func:`count` is a shared no-op.
A counter kept on the device (:func:`count_device`) is read with the
solve's next :func:`read_int`, in the same copy, only while traced.
Span times are ``time.time_ns()``, the clock of the profiler's events, so
a span lines up with the kernels of the same profile; each span is also a
``record_function`` range of its name, so the profiler's own trace shows
the stages over the kernels.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

# spans kept over the buffered solves: past it the oldest solves go, and a
# solve that alone holds more drops the rest of its spans (and counts them)
MAX_SPANS = 1 << 18

_OFF = contextlib.nullcontext()


class SolveTrace(NamedTuple):
    """User-facing monitoring contract (the reference's ``Time`` / ``Obj``
    / ``Dif``)."""
    time: np.ndarray
    obj: np.ndarray
    dif: np.ndarray

    def summary(self) -> str:
        parts = [f"{len(self.time) - 1} iterations"]
        if len(self.time):
            parts.append(f"{self.time[-1]:.3f}s")
        if len(self.obj):
            parts.append(f"objective {self.obj[0]:.6g} -> {self.obj[-1]:.6g}")
        if len(self.dif):
            parts.append(f"final evolution {self.dif[-1]:.3g}")
        return ", ".join(parts)


# the cheapest ``record_function`` range this torch has
_RANGE = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.autograd.profiler.record_function)


class _Solve:
    __slots__ = ("id", "start_ns", "end_ns", "spans", "stack", "counters",
                 "on_device", "dropped")

    def __init__(self, solve_id: int):
        self.id = solve_id
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.spans = []       # [name, parent index or -1, start_ns, end_ns]
        self.stack = []       # indices of the open spans, innermost last
        self.counters = {}
        self.on_device = []   # (name, 0-d device int) not read yet
        self.dropped = 0


class _Open(threading.local):
    """The solve open in this thread (the class attribute is every
    thread's default, so the off path raises and catches nothing)."""
    solve = None


class _SolveScope:
    def __init__(self, tracer: "Tracer"):
        self.tracer = tracer

    def __enter__(self):
        self.tracer._open_solve()

    def __exit__(self, *exc):
        self.tracer._close_solve()


class _SpanScope:
    __slots__ = ("solve", "name", "index", "range")

    def __init__(self, solve: _Solve, name: str):
        self.solve = solve
        self.name = name

    def __enter__(self):
        s = self.solve
        self.range = _RANGE(self.name)
        self.range.__enter__()
        if len(s.spans) >= MAX_SPANS:
            s.dropped += 1
            self.index = None
            return
        self.index = len(s.spans)
        s.spans.append([self.name, s.stack[-1] if s.stack else -1,
                        time.time_ns(), 0])
        s.stack.append(self.index)

    def __exit__(self, *exc):
        if self.index is not None:
            s = self.solve
            s.spans[self.index][3] = time.time_ns()
            s.stack.pop()
        self.range.__exit__(*exc)


class Tracer:
    """Spans and counters of the solves that run while a ``torch.profiler``
    records.  The module's functions (:func:`solve_entry`, :func:`span`,
    :func:`count`, :func:`trace_records`) use one tracer; a solve belongs
    to the thread that entered it.

    The buffer holds the solves traced since the last solve that ran
    untraced or the last :meth:`records` call: the first traced solve after
    either starts it anew, so that a profiler session started after other
    work, or after the previous session's records were read, reads its own
    solves only."""

    def __init__(self):
        self._local = _Open()
        self._lock = threading.Lock()
        self._done = deque()
        self._n_spans = 0
        self._next_id = 0
        self._stale = True

    def solve(self):
        """Context of one solve: opens a record when a profiler records and
        no solve is open in this thread (a nested entry joins the open
        solve), else a no-op."""
        if self._local.solve is not None:
            return _OFF
        if not torch._C._autograd._profiler_enabled():
            self._stale = True
            return _OFF
        return _SolveScope(self)

    def span(self, name: str):
        """Context of one span of the open solve, a child of the innermost
        open span; a no-op when no solve is traced."""
        s = self._local.solve
        if s is None:
            return _OFF
        return _SpanScope(s, name)

    def count(self, name: str, n) -> None:
        """Adds ``n`` to the open solve's counter ``name``."""
        s = self._local.solve
        if s is not None:
            s.counters[name] = s.counters.get(name, 0) + int(n)

    def count_device(self, name: str, t) -> None:
        """Adds the 0-d integer tensor ``t`` to the open solve's counter
        ``name`` at its next :meth:`read_int` (or its end); untraced, a
        no-op that reads nothing."""
        s = self._local.solve
        if s is not None:
            s.on_device.append((name, t))

    def read_int(self, t) -> int:
        """``int(t)`` of a 0-d integer tensor; in a traced solve the device
        counters not read yet come with it, in the same copy."""
        s = self._local.solve
        if s is None or not s.on_device:
            return int(t)
        return _read_counters(s, t.reshape(1).to(torch.int64))[0]

    def read_floats(self, t) -> list:
        """``t.tolist()`` of a 1-D float64 tensor; in a traced solve the
        device counters not read yet come with it, in the same copy."""
        s = self._local.solve
        if s is None or not s.on_device:
            return t.tolist()
        return _read_counters(s, t)

    def _open_solve(self):
        with self._lock:
            if self._stale:
                self._done.clear()
                self._n_spans = 0
                self._stale = False
            solve_id = self._next_id
            self._next_id += 1
        self._local.solve = _Solve(solve_id)

    def _close_solve(self):
        s = self._local.solve
        self._local.solve = None
        if s.on_device:
            _read_counters(s)
        s.end_ns = time.time_ns()
        with self._lock:
            self._done.append(s)
            self._n_spans += len(s.spans)
            while self._n_spans > MAX_SPANS and len(self._done) > 1:
                self._n_spans -= len(self._done.popleft().spans)

    def records(self) -> list:
        """The buffered solves, oldest first, each a dict: ``solve`` (its
        id), ``start_ns``, ``end_ns``, ``total_ns``, ``self_ns`` (the time
        no top-level span covers), ``counters`` ({name: int}),
        ``dropped_spans`` and ``spans``, each a dict of ``name``,
        ``parent`` (the index of the parent span in ``spans``, None for a
        top-level span), ``start_ns``, ``end_ns``, ``total_ns`` and
        ``self_ns`` (its time less its child spans').  Times are
        ``time.time_ns()``, the profiler's clock."""
        with self._lock:
            solves = list(self._done)
            self._stale = True
        out = []
        for s in solves:
            child_ns = [0] * (len(s.spans) + 1)   # [-1]: the solve's
            for _, parent, t0, t1 in s.spans:
                child_ns[parent] += t1 - t0
            spans = [dict(name=name, parent=None if parent < 0 else parent,
                          start_ns=t0, end_ns=t1, total_ns=t1 - t0,
                          self_ns=t1 - t0 - child_ns[k])
                     for k, (name, parent, t0, t1) in enumerate(s.spans)]
            total = s.end_ns - s.start_ns
            out.append(dict(solve=s.id, start_ns=s.start_ns,
                            end_ns=s.end_ns, total_ns=total,
                            self_ns=total - child_ns[-1],
                            counters=dict(s.counters),
                            dropped_spans=s.dropped, spans=spans))
        return out


def _read_counters(s: _Solve, head=None) -> list:
    """Adds the solve's device counters to its counters in one read, after
    the 1-D tensor ``head`` when given (in its type); returns ``head``'s
    values."""
    dtype = torch.int64 if head is None else head.dtype
    vals = [v.reshape(1).to(dtype) for _, v in s.on_device]
    n = 0 if head is None else head.numel()
    if head is not None:
        vals.insert(0, head.reshape(-1))
    vals = torch.cat(vals).tolist()
    for (name, _), v in zip(s.on_device, vals[n:]):
        s.counters[name] = s.counters.get(name, 0) + int(v)
    s.on_device.clear()
    return vals[:n]


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
count_device = _TRACER.count_device
read_int = _TRACER.read_int
read_floats = _TRACER.read_floats
trace_records = _TRACER.records


def solve_entry(span_name: str | None = None):
    """Decorator of a solve's entry point: the call is one traced solve
    (or joins the open one), and, with ``span_name``, one span of it."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            with _TRACER.solve():
                if span_name is None:
                    return fn(*args, **kwargs)
                with _TRACER.span(span_name):
                    return fn(*args, **kwargs)
        return entry
    return wrap


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype, device)`` of a host array, its bytes
    added to the traced solve's ``h2d.bytes``."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    count("h2d.bytes", t.nbytes)
    return t


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array, their bytes added to the traced
    solve's ``d2h.bytes``."""
    a = t.detach().cpu().numpy()
    count("d2h.bytes", a.nbytes)
    return a


@contextlib.contextmanager
def profile(log_dir: str):
    """Records a ``torch.profiler`` trace of the enclosed work (host
    activity, and CUDA activity when a device is present) and writes it to
    ``log_dir`` as a TensorBoard / Chrome trace file; yields the profiler.
    The solves run inside also record their spans and counters
    (:func:`trace_records`); the spans show in the trace as ranges of
    their names."""
    from torch.profiler import (ProfilerActivity, tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
