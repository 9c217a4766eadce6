"""Per cent of the traced window in which no kernel, copy or set ran on the
device (1 - the union of their intervals over the window)."""
from benchmark.core.readers import device_idle


def read(obs):
    return device_idle(obs, "train")
