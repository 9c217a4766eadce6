"""The MoleculeNet CSV datasets; counterpart of
``gcnn_keras_tpu/data/datasets/moleculenet.py`` (kgcnn's
``MoleculeNetDataset`` and its ESOL, FreeSolv, Lipop, ClinTox, Tox21 and
SIDER): a CSV of SMILES with their labels, each SMILES made a molecule
with a conformer and its attribute graph by RDKit. The CSV is read by
``data/csv_table.py`` (the JAX class calls ``pandas.read_csv``); without
RDKit the first molecule raises ``ImportError``, after the CSV is fetched
and read."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..csv_table import read_csv
from ..dataset import MemoryGraphDataset
from ..download import DownloadDataset
from ...mol.encoder import OneHotEncoder

_DEFAULT_NODE_PROPS = ["Symbol", "TotalDegree", "FormalCharge", "NumRadicalElectrons",
                       "Hybridization", "IsAromatic", "TotalNumHs"]
_DEFAULT_EDGE_PROPS = ["BondType", "IsAromatic", "IsConjugated", "IsInRing"]
_DEEPCHEM = "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/"


class MoleculeNetDataset(MemoryGraphDataset):
    def __init__(self, data_directory: Optional[str] = None,
                 dataset_name: Optional[str] = None,
                 file_name: Optional[str] = None, **kwargs):
        super().__init__(data_directory=data_directory, dataset_name=dataset_name,
                         file_name=file_name, **kwargs)

    def prepare_data(self, smiles_column_name: str = "smiles",
                     label_column_name=None, add_hydrogen: bool = True,
                     make_conformers: bool = True, **kwargs):
        """The SMILES column as molecules with their graphs (needs RDKit);
        ``label_column_name`` (a name, a list of names or None) gives
        ``graph_labels``. The table is kept as ``table``."""
        from ...mol.graph_rdkit import MolecularGraphRDKit
        table = read_csv(self.file_path)
        self.table = table
        labels = table.values(label_column_name) if label_column_name else None
        node_enc = {"Symbol": OneHotEncoder(["C", "N", "O", "S", "F", "Cl", "Br", "I", "P", "H"]),
                    "Hybridization": OneHotEncoder(["SP", "SP2", "SP3"])}
        edge_enc = {"BondType": OneHotEncoder(["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"])}
        for i, smi in enumerate(table.column(smiles_column_name)):
            mg = MolecularGraphRDKit().from_smiles(
                smi, add_hydrogen=add_hydrogen, make_conformers=make_conformers)
            if mg.mol is None:
                continue
            g = {
                "node_number": mg.node_number,
                "node_symbol": mg.node_number,
                "edge_indices": mg.edge_indices,
                "node_attributes": mg.node_attributes(_DEFAULT_NODE_PROPS, node_enc),
                "edge_attributes": mg.edge_attributes(_DEFAULT_EDGE_PROPS, edge_enc),
            }
            coords = mg.node_coordinates
            if coords is not None:
                g["node_coordinates"] = coords
            if labels is not None:
                g["graph_labels"] = np.atleast_1d(np.asarray(labels[i], dtype=np.float32))
            self.append(g)
        return self

    read_in_memory = prepare_data


class _NamedMoleculeNet(MoleculeNetDataset):
    """A MoleculeNet dataset of a fixed CSV and columns."""

    _name = _file = _smiles = ""
    _label = None

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset(self._name, download_url=self._url,
                             download_file_name=self._file,
                             extract_gz=self._file.endswith(".gz"), reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name=self._name,
                         file_name=self._file[:-3] if self._file.endswith(".gz") else self._file,
                         **kwargs)

    def read_in_memory(self, **kwargs):
        return self.prepare_data(smiles_column_name=self._smiles,
                                 label_column_name=self._label)


class ESOLDataset(_NamedMoleculeNet):
    _url = _DEEPCHEM + "delaney-processed.csv"
    _name, _file, _smiles = "ESOL", "delaney-processed.csv", "smiles"
    _label = "measured log solubility in mols per litre"


class FreeSolvDataset(_NamedMoleculeNet):
    _url = _DEEPCHEM + "SAMPL.csv"
    _name, _file, _smiles, _label = "FreeSolv", "SAMPL.csv", "smiles", "expt"


class LipopDataset(_NamedMoleculeNet):
    _url = _DEEPCHEM + "Lipophilicity.csv"
    _name, _file, _smiles, _label = "Lipop", "Lipophilicity.csv", "smiles", "exp"


class ClinToxDataset(_NamedMoleculeNet):
    _url = _DEEPCHEM + "clintox.csv.gz"
    _name, _file, _smiles, _label = "ClinTox", "clintox.csv.gz", "smiles", "CT_TOX"


class Tox21MolNetDataset(_NamedMoleculeNet):
    """Tox21; ``read_in_memory`` takes ``prepare_data``'s arguments (no
    labels by default)."""
    _url = _DEEPCHEM + "tox21.csv.gz"
    _name, _file, _smiles = "Tox21", "tox21.csv.gz", "smiles"
    read_in_memory = MoleculeNetDataset.prepare_data


class SIDERDataset(_NamedMoleculeNet):
    """SIDER; ``read_in_memory`` takes ``prepare_data``'s arguments (no
    labels by default)."""
    _url = _DEEPCHEM + "sider.csv.gz"
    _name, _file, _smiles = "SIDER", "sider.csv.gz", "smiles"
    read_in_memory = MoleculeNetDataset.prepare_data


class MoleculeNetDataset2018(MoleculeNetDataset):
    """A MoleculeNet 2018 collection by name (kgcnn's
    ``MoleculeNetDataset2018``): ``dataset_name`` selects the deepchem CSV
    and its SMILES and label columns."""

    _TABLE = {
        "ESOL": ("delaney-processed.csv", "smiles",
                 "measured log solubility in mols per litre", False),
        "FreeSolv": ("SAMPL.csv", "smiles", "expt", False),
        "Lipop": ("Lipophilicity.csv", "smiles", "exp", False),
        "ClinTox": ("clintox.csv.gz", "smiles", "CT_TOX", True),
        "Tox21": ("tox21.csv.gz", "smiles", None, True),
        "SIDER": ("sider.csv.gz", "smiles", None, True),
        "BACE": ("bace.csv", "mol", "Class", False),
        "BBBP": ("BBBP.csv", "smiles", "p_np", False),
        "HIV": ("HIV.csv", "smiles", "HIV_active", False),
    }

    def __init__(self, dataset_name: str = "ESOL", reload: bool = False, **kwargs):
        if dataset_name not in self._TABLE:
            raise ValueError(f"unknown MoleculeNet2018 set {dataset_name!r}; "
                             f"known: {sorted(self._TABLE)}")
        fn, smi, label, is_gz = self._TABLE[dataset_name]
        dl = DownloadDataset(dataset_name, download_url=_DEEPCHEM + fn,
                             download_file_name=fn, extract_gz=is_gz, reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name=dataset_name,
                         file_name=fn[:-3] if is_gz else fn, **kwargs)
        self._smiles_col = smi
        self._label_col = label

    def read_in_memory(self, **kwargs):
        return self.prepare_data(smiles_column_name=self._smiles_col,
                                 label_column_name=self._label_col)


class QM9MolNetDataset(MoleculeNetDataset):
    """QM9 as MoleculeNet's CSV (kgcnn's ``QM9MolNetDataset``): 12
    regression targets."""

    _url = _DEEPCHEM + "qm9.csv"
    _targets = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
                "u0", "u298", "h298", "g298", "cv"]

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset("QM9MolNet", download_url=self._url,
                             download_file_name="qm9.csv", reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name="QM9MolNet",
                         file_name="qm9.csv", **kwargs)

    def read_in_memory(self, **kwargs):
        return self.prepare_data(smiles_column_name="smiles", label_column_name=self._targets)
