"""Atomic masses for the MD integrators; counterpart of
``gcnn_keras_tpu/utils/constants.py`` (``atomic_masses``,
``masses_from_numbers``), copied so that the port imports nothing of the
JAX package."""
from __future__ import annotations

import numpy as np

# standard atomic weights (amu), Z = 1..36 plus common heavier elements
atomic_masses = {
    1: 1.008, 2: 4.0026, 3: 6.94, 4: 9.0122, 5: 10.81, 6: 12.011,
    7: 14.007, 8: 15.999, 9: 18.998, 10: 20.180, 11: 22.990, 12: 24.305,
    13: 26.982, 14: 28.085, 15: 30.974, 16: 32.06, 17: 35.45, 18: 39.948,
    19: 39.098, 20: 40.078, 21: 44.956, 22: 47.867, 23: 50.942, 24: 51.996,
    25: 54.938, 26: 55.845, 27: 58.933, 28: 58.693, 29: 63.546, 30: 65.38,
    31: 69.723, 32: 72.630, 33: 74.922, 34: 78.971, 35: 79.904, 36: 83.798,
    47: 107.87, 53: 126.90, 78: 195.08, 79: 196.97, 80: 200.59, 82: 207.2,
}


def masses_from_numbers(numbers, default: float = 12.011) -> np.ndarray:
    """Per-atom masses (amu, float32) from atomic numbers; an unknown Z
    takes ``default`` (carbon): integrator masses change the dynamics, not
    energies or forces."""
    z = np.asarray(numbers).astype(int)
    return np.array([atomic_masses.get(int(v), default) for v in z], dtype=np.float32)
