"""Device kernels of the traced window (no copies or sets) per training step."""


def read(obs):
    if obs.mode != "train" or obs.trace is None or not obs.trace_calls:
        return None
    n = len(obs.trace.kernels())
    return n / obs.trace_calls if n else None
