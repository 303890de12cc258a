"""End to end: the 95th percentile (numpy's linear interpolation) of the
host-clock latency of every solve of the window, from the call to the
result on the host, in ms."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3 \
        if run.solves else None
