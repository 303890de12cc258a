"""Stage timer of the cut-pursuit outer loop (counterpart of
``StageProfiler`` in ``cp_pfdr_graph_d1_tpu.utils.monitor``)."""
from __future__ import annotations

import os
import sys
import time


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
