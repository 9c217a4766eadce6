"""Axis helper; counterpart of ``gcnn_keras_tpu/ops/axis.py``."""


def get_positive_axis(axis: int, rank: int) -> int:
    if axis < 0:
        axis += rank
    if not 0 <= axis < rank:
        raise ValueError(f"axis {axis} out of range for rank {rank}")
    return axis
