"""Mean of how late the benchmark's senders sent each request after it
was due: the load generator's own delay, inside every latency."""

import numpy as np


def read(run):
    lag = getattr(run, "lag", None)
    if lag is None or not np.isfinite(lag).any():
        return None
    return float(np.nanmean(lag) * 1e3)
