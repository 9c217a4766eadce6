"""The molecule interface of the chemistry backends; counterpart of
``gcnn_keras_tpu/mol/base.py`` (kgcnn's ``MolGraphInterface``)."""
from __future__ import annotations

from typing import List, Optional


class MolGraphInterface:
    """Unified access to a chemistry backend's molecule object."""

    def __init__(self, mol=None, make_directed: bool = False):
        self.mol = mol
        self._make_directed = make_directed

    def from_smiles(self, smiles: str, **kwargs):
        raise NotImplementedError

    def from_mol_block(self, mol_block: str, **kwargs):
        raise NotImplementedError

    def to_mol_block(self) -> Optional[str]:
        raise NotImplementedError

    @property
    def node_number(self) -> List[int]:
        raise NotImplementedError

    @property
    def node_coordinates(self):
        raise NotImplementedError

    @property
    def edge_indices(self):
        raise NotImplementedError

    def node_attributes(self, properties: List[str], encoder: dict):
        raise NotImplementedError

    def edge_attributes(self, properties: List[str], encoder: dict):
        raise NotImplementedError
