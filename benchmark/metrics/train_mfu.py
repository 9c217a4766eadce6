"""Model FLOPs of the training steps that the traced run times without the
profiler, over (their seconds x 67 TFLOP/s, the H100's float32 peak
outside the tensor cores). A step counts 9x the configuration's forward FLOPs
at the batch's real sizes (counts/<config>.py)."""
from benchmark.core.readers import mfu


def read(obs):
    return mfu(obs, "train")
