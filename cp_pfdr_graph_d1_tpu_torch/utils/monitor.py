"""Monitoring utilities (counterpart of
``cp_pfdr_graph_d1_tpu.utils.monitor``).

The reference's only instrumentation is wall-clock ``Time[]``, objective
``Obj[]`` and evolution ``Dif[]`` arrays plus printf progress
(``CP_PFDR_graph_quadratic_d1_l1.cpp:255-258,323-329``).  The solvers
return the same trace arrays (:class:`SolveTrace` summarizes them);
:class:`StageProfiler` times the stages of the cut-pursuit outer loop, and
:func:`profile` records a ``torch.profiler`` trace of a solve.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import NamedTuple

import numpy as np


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


class StageProfiler:
    """Wall-clock per-stage accumulator, enabled by ``CP_PROFILE=1``.  Call
    :meth:`tick` after each stage; :meth:`report` prints the breakdown.

    CUDA work is asynchronous: a stage that ends without reading a device
    value back is charged for enqueueing its work, and the stage that next
    waits for the device is charged for running it.
    """

    def __init__(self, enabled: bool | None = None):
        self.enabled = (os.environ.get("CP_PROFILE") == "1"
                        if enabled is None else enabled)
        self._clock = time.monotonic
        self._t = self._clock() if self.enabled else 0.0
        self.stages: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def tick(self, stage: str):
        if not self.enabled:
            return
        now = self._clock()
        self.stages[stage] = self.stages.get(stage, 0.0) + (now - self._t)
        self.counts[stage] = self.counts.get(stage, 0) + 1
        self._t = now

    def report(self, label: str = "cut-pursuit"):
        if not self.enabled or not self.stages:
            return
        total = sum(self.stages.values())
        print(f"[CP_PROFILE] {label}: {total * 1000:.1f} ms total",
              file=sys.stderr)
        for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            n = self.counts[k]
            print(f"[CP_PROFILE]   {k:24s} {v * 1000:8.1f} ms "
                  f"({100 * v / total:5.1f}%)  x{n}  "
                  f"{v * 1000 / max(n, 1):7.2f} ms/call", file=sys.stderr)


@contextlib.contextmanager
def profile(log_dir: str):
    """Records a ``torch.profiler`` trace of the enclosed work (host
    activity, and CUDA activity when a device is present) and writes it to
    ``log_dir`` as a TensorBoard / Chrome trace file; yields the profiler."""
    import torch
    from torch.profiler import (ProfilerActivity, tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
