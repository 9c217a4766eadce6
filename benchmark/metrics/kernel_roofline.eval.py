"""Per cent of their roofline at which the port's own kernels ran in the
traced window: the sum over their launches of the least time the H100
could take at each launch's shapes (counts/work.py) over the sum of their
device times."""
from benchmark.core.readers import kernel_roofline, record_kernel_launches


def instrument(obs):
    return record_kernel_launches(obs)


def read(obs):
    return kernel_roofline(obs, "eval")
