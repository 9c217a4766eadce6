"""The 95th percentile over every evaluation of the window of its latency,
from the call to the synchronize() after which its forces can be read."""
import numpy as np


def read(obs):
    if obs.mode != "eval" or not obs.latency_s:
        return None
    return float(np.percentile(np.asarray(obs.latency_s) * 1e3, 95))
