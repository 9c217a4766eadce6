"""Unit constants and atomic masses; counterpart of
``gcnn_keras_tpu/utils/constants.py`` (kgcnn's ``utils/constants.py``),
copied so that the port imports nothing of the JAX package."""
from __future__ import annotations

import numpy as np

# length
angstrom_to_bohr = 1.8897261254578281
bohr_to_angstrom = 1.0 / angstrom_to_bohr

# energy
hartree_to_ev = 27.211386245988
ev_to_hartree = 1.0 / hartree_to_ev
hartree_to_kcalmol = 627.509474063
kcalmol_to_hartree = 1.0 / hartree_to_kcalmol
kjmol_to_hartree = 1.0 / 2625.4996394799
hartree_to_kjmol = 2625.4996394799

# force
hartree_bohr_to_ev_angstrom = hartree_to_ev * angstrom_to_bohr
hartree_bohr_to_kcalmol_angstrom = hartree_to_kcalmol * angstrom_to_bohr

# charge / esp
coulomb_constant_au = 1.0  # atomic units
debye_to_eA = 0.20819434

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
