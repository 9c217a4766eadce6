"""The RDKit molecule backend; counterpart of
``gcnn_keras_tpu/mol/graph_rdkit.py`` (kgcnn's ``MolecularGraphRDKit``).
RDKit is optional: this module imports without it, and building a
``MolecularGraphRDKit`` then raises ``ImportError``."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .base import MolGraphInterface

try:
    from rdkit import Chem
    from rdkit.Chem import AllChem, Descriptors
    _HAS_RDKIT = True
except ImportError:
    _HAS_RDKIT = False


def _require_rdkit():
    if not _HAS_RDKIT:
        raise ImportError("rdkit is required for MolecularGraphRDKit; "
                          "install rdkit or use precomputed graph properties")


# standard atom/bond feature getters keyed like the reference's encoder maps
ATOM_FEATURES: Dict[str, Callable] = {} if not _HAS_RDKIT else {
    "Symbol": lambda a: a.GetSymbol(),
    "AtomicNum": lambda a: a.GetAtomicNum(),
    "NumExplicitHs": lambda a: a.GetNumExplicitHs(),
    "NumImplicitHs": lambda a: a.GetNumImplicitHs(),
    "TotalNumHs": lambda a: a.GetTotalNumHs(),
    "IsAromatic": lambda a: int(a.GetIsAromatic()),
    "TotalDegree": lambda a: a.GetTotalDegree(),
    "TotalValence": lambda a: a.GetTotalValence(),
    "Mass": lambda a: a.GetMass(),
    "IsInRing": lambda a: int(a.IsInRing()),
    "Hybridization": lambda a: str(a.GetHybridization()),
    "ChiralityPossible": lambda a: int(a.HasProp("_ChiralityPossible"))
    if a.HasProp("_ChiralityPossible") else 0,
    "FormalCharge": lambda a: a.GetFormalCharge(),
    "NumRadicalElectrons": lambda a: a.GetNumRadicalElectrons(),
}

BOND_FEATURES: Dict[str, Callable] = {} if not _HAS_RDKIT else {
    "BondType": lambda b: str(b.GetBondType()),
    "IsAromatic": lambda b: int(b.GetIsAromatic()),
    "IsConjugated": lambda b: int(b.GetIsConjugated()),
    "IsInRing": lambda b: int(b.IsInRing()),
    "Stereo": lambda b: str(b.GetStereo()),
}


class MolecularGraphRDKit(MolGraphInterface):
    def __init__(self, mol=None, make_directed: bool = False):
        _require_rdkit()
        super().__init__(mol=mol, make_directed=make_directed)

    def from_smiles(self, smiles: str, sanitize: bool = True,
                    add_hydrogen: bool = True, make_conformers: bool = True,
                    optimize_conformer: bool = True):
        mol = Chem.MolFromSmiles(smiles, sanitize=sanitize)
        if mol is None:
            self.mol = None
            return self
        if add_hydrogen:
            mol = Chem.AddHs(mol)
        if make_conformers:
            try:
                AllChem.EmbedMolecule(mol, randomSeed=42)
                if optimize_conformer:
                    AllChem.MMFFOptimizeMolecule(mol)
            except Exception:
                pass
        self.mol = mol
        return self

    def from_mol_block(self, mol_block: str, sanitize: bool = True, **kwargs):
        self.mol = Chem.MolFromMolBlock(mol_block, sanitize=sanitize,
                                        removeHs=False)
        return self

    def to_mol_block(self):
        return Chem.MolToMolBlock(self.mol) if self.mol else None

    @property
    def node_number(self):
        return np.array([a.GetAtomicNum() for a in self.mol.GetAtoms()],
                        dtype=np.int64)

    @property
    def node_coordinates(self):
        if self.mol.GetNumConformers() == 0:
            return None
        conf = self.mol.GetConformer()
        return np.array(conf.GetPositions(), dtype=np.float32)

    @property
    def edge_indices(self):
        out = []
        for b in self.mol.GetBonds():
            i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
            out.append([i, j])
            out.append([j, i])
        out = np.array(sorted(out), dtype=np.int64) if out else \
            np.zeros((0, 2), dtype=np.int64)
        return out

    def node_attributes(self, properties: List[str], encoder: Optional[dict] = None):
        encoder = encoder or {}
        rows = []
        for a in self.mol.GetAtoms():
            feats = []
            for p in properties:
                v = ATOM_FEATURES[p](a)
                if p in encoder:
                    feats.extend(np.atleast_1d(encoder[p](v)))
                else:
                    feats.append(float(v) if not isinstance(v, str) else 0.0)
            rows.append(feats)
        return np.array(rows, dtype=np.float32)

    def edge_attributes(self, properties: List[str], encoder: Optional[dict] = None):
        encoder = encoder or {}
        rows = []
        idx = []
        for b in self.mol.GetBonds():
            feats = []
            for p in properties:
                v = BOND_FEATURES[p](b)
                if p in encoder:
                    feats.extend(np.atleast_1d(encoder[p](v)))
                else:
                    feats.append(float(v) if not isinstance(v, str) else 0.0)
            i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
            rows.append(feats); idx.append([i, j])
            rows.append(feats); idx.append([j, i])
        order = np.argsort([a * self.mol.GetNumAtoms() + b for a, b in idx]) \
            if idx else []
        attr = np.array(rows, dtype=np.float32)[order] if rows else \
            np.zeros((0, len(properties)), dtype=np.float32)
        return attr
