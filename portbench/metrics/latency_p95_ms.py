"""The 95th percentile, in ms, of the window's requests' latencies: from
issuing a request's batch to holding its answers on the host."""
import numpy as np


def read(run):
    if not run.get("latencies_s"):
        return None
    return float(np.percentile(run["latencies_s"], 95)) * 1e3
