"""Device kernels of the traced window (no copies or sets) per evaluation."""


def read(obs):
    if obs.mode != "eval" or obs.trace is None or not obs.trace_calls:
        return None
    n = len(obs.trace.kernels())
    return n / obs.trace_calls if n else None
