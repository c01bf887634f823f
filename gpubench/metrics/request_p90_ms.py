"""The 90th percentile of every answered request's latency in the window,
submit to answer on the benchmark's clock, in ms (linear interpolation
between order statistics)."""
import numpy as np


def read(rec):
    if not rec.latencies_s:
        return None
    return float(np.percentile(np.asarray(rec.latencies_s), 90)) * 1e3
