"""Learning-rate schedules as functions of the step count; counterpart of
``gcnn_keras_tpu/training/schedules.py`` and of ``optax.linear_schedule``,
which the training engine uses.

``Trainer(schedule=...)`` sets update k's learning rate to ``schedule(k)``,
k counted from 0, as optax's ``scale_by_learning_rate`` does with its step
count. ``linear_schedule`` and ``warmup_cosine_decay_schedule`` (the
``optax`` schedules of the training scripts) compute in float32 as optax
does: the first returns its values exactly, the second within a float32
rounding (numpy's float32 cosine is not XLA's); the others compute in
double precision, where the JAX package's computes in float32.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    """``optax.linear_schedule``: ``init_value`` until ``transition_begin``,
    then linear to ``end_value`` over ``transition_steps`` steps, then
    ``end_value``; constant ``init_value`` if ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)
    delta, end = np.float32(init_value - end_value), np.float32(end_value)

    def schedule(count: int) -> float:
        count = min(max(count - transition_begin, 0), transition_steps)
        frac = np.float32(1) - np.float32(count) / np.float32(transition_steps)
        return float(delta * frac + end)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then ``peak_value`` times the
    cosine decay ``(1 - alpha) (0.5 (1 + cos(pi t / T)))^exponent + alpha``
    over ``T = decay_steps - warmup_steps`` steps (``alpha = end_value /
    peak_value``), then ``end_value``."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("warmup_cosine_decay_schedule needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    t_decay = np.float32(decay_steps - warmup_steps)
    one, half, f32 = np.float32(1), np.float32(0.5), np.float32

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        t = min(f32(count - warmup_steps), t_decay)
        cosine = half * (one + np.cos(f32(np.pi) * t / t_decay, dtype=np.float32))
        decayed = (one - f32(alpha)) * cosine ** f32(exponent) + f32(alpha)
        return float(f32(peak_value) * decayed)

    return schedule


def linear_warmup_exponential_decay(lr_start: float, warmup_steps: int,
                                    decay_steps: float, decay_rate: float = 0.5,
                                    lr_min: float = 0.0) -> Schedule:
    """Linear warm-up to ``lr_start``, then ``decay_rate`` every
    ``decay_steps``, never below ``lr_min``."""
    def schedule(step: int) -> float:
        warm = min(step / max(warmup_steps, 1), 1.0)
        decay = decay_rate ** ((step - warmup_steps) / decay_steps) \
            if step > warmup_steps else 1.0
        return max(lr_start * warm * decay, lr_min)

    return schedule


def linear_learning_rate(lr_start: float, lr_stop: float, steps_total: int,
                         steps_const: int = 0) -> Schedule:
    """Constant for ``steps_const`` steps, then linear to ``lr_stop`` at
    ``steps_total``."""
    def schedule(step: int) -> float:
        frac = min(max((step - steps_const) / max(steps_total - steps_const, 1), 0.0), 1.0)
        return lr_start + (lr_stop - lr_start) * frac

    return schedule


def linear_warmup_linear_decay(lr_start: float, lr_stop: float,
                               warmup_steps: int, steps_total: int) -> Schedule:
    """Linear warm-up, then linear decay from ``lr_start`` to ``lr_stop``."""
    def schedule(step: int) -> float:
        warm = min(step / max(warmup_steps, 1), 1.0)
        frac = min(max((step - warmup_steps) / max(steps_total - warmup_steps, 1), 0.0), 1.0)
        return warm * (lr_start + (lr_stop - lr_start) * frac)

    return schedule


def cosine_annealing(lr_start: float, steps_total: int, lr_min: float = 0.0) -> Schedule:
    """Half a cosine from ``lr_start`` to ``lr_min`` over ``steps_total``."""
    def schedule(step: int) -> float:
        frac = min(max(step / max(steps_total, 1), 0.0), 1.0)
        return lr_min + 0.5 * (lr_start - lr_min) * (1 + math.cos(math.pi * frac))

    return schedule


def get_schedule(name: str, **kwargs) -> Schedule:
    table = {
        "linear_warmup_exponential_decay": linear_warmup_exponential_decay,
        "linear": linear_learning_rate,
        "linear_warmup_linear": linear_warmup_linear_decay,
        "cosine_annealing": cosine_annealing,
        "constant": lambda lr, **kw: (lambda step: lr),
    }
    return table[name](**kwargs)
