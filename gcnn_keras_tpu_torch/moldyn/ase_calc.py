"""The ASE calculator bridge; counterpart of
``gcnn_keras_tpu/moldyn/ase_calc.py`` (kgcnn's ``AtomsToGraphConverter``
and ``KgcnnSingleCalculator``).

ASE is optional. ``TPUGraphCalculator`` (alias ``KgcnnSingleCalculator``)
is defined where ``ase`` imports and is None otherwise; its ``calculate``
runs ``calculator_results``, which takes any object with ASE's
``get_atomic_numbers``, ``get_positions``, ``pbc`` and ``get_cell``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


class AtomsToGraphConverter:
    """Map ``ase.Atoms`` getters to graph keys; a periodic ``Atoms`` (any
    ``pbc`` set) also gives ``graph_lattice``."""

    def __init__(self, properties: Optional[Dict[str, str]] = None):
        self.properties = properties or {
            "node_number": "get_atomic_numbers",
            "node_coordinates": "get_positions",
        }

    def __call__(self, atoms) -> dict:
        g = {}
        for key, getter in self.properties.items():
            g[key] = np.asarray(getattr(atoms, getter)())
        if getattr(atoms, "pbc", None) is not None and np.any(atoms.pbc):
            g["graph_lattice"] = np.asarray(atoms.get_cell()[:], dtype=np.float32)
        return g


def calculator_results(model_predictor: Callable[[List[dict]], List[dict]],
                       converter: AtomsToGraphConverter, atoms) -> dict:
    """The calculator's ``results`` for ``atoms``: ``energy`` (a float),
    ``forces`` and ``charges`` where the predictor returns ``energy``,
    ``force`` and ``charge``. ASE's float64 arrays reach the predictor as
    float32, the models' dtype (the JAX package's arrays take it on their
    way to the device)."""
    graph = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in converter(atoms).items()}
    result = model_predictor([graph])[0]
    out = {}
    if "energy" in result:
        out["energy"] = float(np.asarray(result["energy"]).reshape(-1)[0])
    if "force" in result:
        out["forces"] = np.asarray(result["force"])
    if "charge" in result:
        out["charges"] = np.asarray(result["charge"])
    return out


try:
    from ase.calculators.calculator import Calculator, all_changes

    class TPUGraphCalculator(Calculator):
        """An ASE calculator that takes energies, forces and charges from a
        model predictor (``MolDynamicsModelPredictor``)."""

        implemented_properties = ["energy", "forces", "charges"]

        def __init__(self, model_predictor, converter: Optional[AtomsToGraphConverter] = None,
                     **kwargs):
            super().__init__(**kwargs)
            self.model_predictor = model_predictor
            self.converter = converter or AtomsToGraphConverter()

        def calculate(self, atoms=None, properties=None, system_changes=all_changes):
            super().calculate(atoms=atoms, properties=properties,
                              system_changes=system_changes)
            self.results.update(calculator_results(self.model_predictor, self.converter,
                                                   self.atoms))

    KgcnnSingleCalculator = TPUGraphCalculator  # the reference's name
except ImportError:  # ase not installed
    TPUGraphCalculator = None
    KgcnnSingleCalculator = None
