"""The OpenBabel molecule backend; counterpart of
``gcnn_keras_tpu/mol/graph_babel.py`` (kgcnn's ``MolecularGraphOpenBabel``).

OpenBabel is optional, as in the reference: this module imports without
it, ``babel_available()`` reports it, and building a
``MolecularGraphOpenBabel`` then raises ``ImportError``. The API is the
RDKit backend's (``graph_rdkit.py``): ``from_smiles``, ``from_mol_block``,
``to_mol_block``, the node and edge property accessors, and the conformer
and charge utilities.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np

from .base import MolGraphInterface

logger = logging.getLogger(__name__)

try:  # pragma: no cover - openbabel not installed in this environment
    from openbabel import openbabel
    if "BABEL_DATADIR" not in os.environ:
        logger.warning("System variable 'BABEL_DATADIR' is not set; "
                       "set os.environ['BABEL_DATADIR'] if lookups fail.")
    _HAVE_BABEL = True
except ImportError:
    openbabel = None
    _HAVE_BABEL = False


def babel_available() -> bool:
    return _HAVE_BABEL


class MolecularGraphOpenBabel(MolGraphInterface):
    """A molecular graph on an ``OBMol``.

    Per-atom / per-bond property names follow the reference's fun-dict
    pattern: any ``Is*``/``Has*`` predicate or ``Get<Name>`` accessor on
    ``OBAtom``/``OBBond`` is resolved dynamically, so the reference's
    documented property keys (``IsAromatic``, ``BondOrder``,
    ``FormalCharge``, ...) all work without replicating its 100-entry
    tables.
    """

    def __init__(self, mol=None, make_directed: bool = False):
        if not _HAVE_BABEL:
            raise ImportError(
                "MolecularGraphOpenBabel requires the optional `openbabel` "
                "package (conda install openbabel)")
        super().__init__(mol=mol, make_directed=make_directed)

    # -------------------------------------------------------------- io ---
    def from_smiles(self, smiles: str, sanitize: bool = True,
                    add_hydrogen: bool = True, make_conformers: bool = True,
                    optimize_conformer: bool = True, **kwargs):
        conv = openbabel.OBConversion()
        conv.SetInFormat("smi")
        mol = openbabel.OBMol()
        if not conv.ReadString(mol, smiles):
            self.mol = None
            return self
        self.mol = mol
        if add_hydrogen:
            self.add_hs()
        if make_conformers:
            self.make_conformer()
            if optimize_conformer:
                self.optimize_conformer()
        return self

    def from_mol_block(self, mol_block: str, keep_hs: bool = True, **kwargs):
        conv = openbabel.OBConversion()
        conv.SetInFormat("mol")
        mol = openbabel.OBMol()
        if not conv.ReadString(mol, mol_block):
            self.mol = None
            return self
        if not keep_hs:
            mol.DeleteHydrogens()
        self.mol = mol
        return self

    def from_xyz(self, xyz_string: str, **kwargs):
        conv = openbabel.OBConversion()
        conv.SetInFormat("xyz")
        mol = openbabel.OBMol()
        conv.ReadString(mol, xyz_string)
        self.mol = mol
        return self

    def to_mol_block(self) -> Optional[str]:
        if self.mol is None:
            return None
        conv = openbabel.OBConversion()
        conv.SetOutFormat("mol")
        return conv.WriteString(self.mol)

    def to_smiles(self) -> Optional[str]:
        if self.mol is None:
            return None
        conv = openbabel.OBConversion()
        conv.SetOutFormat("smi")
        return conv.WriteString(self.mol).strip()

    # ------------------------------------------------------- conformers ---
    def make_conformer(self, **kwargs) -> bool:
        if self.mol is None:
            return False
        builder = openbabel.OBBuilder()
        return builder.Build(self.mol)

    def optimize_conformer(self, force_field: str = "mmff94",
                           steps: int = 100, **kwargs) -> bool:
        if self.mol is None:
            return False
        ff = openbabel.OBForceField.FindType(force_field)
        if ff is None:
            return False
        ok = ff.Setup(self.mol)
        ff.SteepestDescent(steps, **kwargs)
        ff.GetCoordinates(self.mol)
        return ok

    def add_hs(self, **kwargs):
        self.mol.AddHydrogens()

    def remove_hs(self, **kwargs):
        self.mol.DeleteHydrogens()

    def compute_partial_charges(self, method: str = "gasteiger", **kwargs):
        model = openbabel.OBChargeModel.FindType(method)
        if model is None:
            return False
        return model.ComputeCharges(self.mol)

    # -------------------------------------------------------- properties ---
    @property
    def node_number(self) -> np.ndarray:
        return np.array([a.GetAtomicNum()
                         for a in openbabel.OBMolAtomIter(self.mol)],
                        dtype=np.int64)

    @property
    def node_coordinates(self) -> np.ndarray:
        return np.array([[a.GetX(), a.GetY(), a.GetZ()]
                         for a in openbabel.OBMolAtomIter(self.mol)],
                        dtype=np.float64)

    @property
    def edge_indices(self) -> np.ndarray:
        idx = []
        for b in openbabel.OBMolBondIter(self.mol):
            i, j = b.GetBeginAtomIdx() - 1, b.GetEndAtomIdx() - 1
            idx.append([i, j])
            if not self._make_directed:
                idx.append([j, i])
        if not idx:
            return np.zeros((0, 2), dtype=np.int64)
        idx = np.array(idx, dtype=np.int64)
        order = np.lexsort((idx[:, 1], idx[:, 0]))
        return idx[order]

    @staticmethod
    def _resolve(obj, name: str):
        """Reference fun-dict semantics: Is*/Has* predicates verbatim,
        everything else through Get<name>."""
        if hasattr(obj, name) and callable(getattr(obj, name)):
            return getattr(obj, name)()
        if hasattr(obj, f"Get{name}"):
            return getattr(obj, f"Get{name}")()
        raise ValueError(f"Unknown OpenBabel property {name!r} on "
                         f"{type(obj).__name__}")

    def node_attributes(self, properties: List[str], encoder: dict) -> np.ndarray:
        rows = []
        for a in openbabel.OBMolAtomIter(self.mol):
            row = []
            for p in properties:
                v = self._resolve(a, p)
                enc = encoder.get(p)
                v = enc(v) if enc is not None else v
                row.extend(np.atleast_1d(np.asarray(v, dtype=np.float64)))
            rows.append(row)
        return np.array(rows, dtype=np.float64)

    def edge_attributes(self, properties: List[str], encoder: dict):
        vals = []
        pairs = []
        for b in openbabel.OBMolBondIter(self.mol):
            row = []
            for p in properties:
                v = self._resolve(b, p)
                enc = encoder.get(p)
                v = enc(v) if enc is not None else v
                row.extend(np.atleast_1d(np.asarray(v, dtype=np.float64)))
            i, j = b.GetBeginAtomIdx() - 1, b.GetEndAtomIdx() - 1
            pairs.append(([i, j], row))
            if not self._make_directed:
                pairs.append(([j, i], row))
        pairs.sort(key=lambda t: (t[0][0], t[0][1]))
        idx = np.array([p[0] for p in pairs], dtype=np.int64) \
            if pairs else np.zeros((0, 2), dtype=np.int64)
        vals = np.array([p[1] for p in pairs], dtype=np.float64) \
            if pairs else np.zeros((0, len(properties)))
        return idx, vals
