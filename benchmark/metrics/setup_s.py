"""Set-up seconds: everything before the window (imports, CUDA start, the
kernels from their build cache, the traffic, the weights, the batches, a
first call on every batch), on the host's clock."""


def read(obs):
    return obs.setup_s
