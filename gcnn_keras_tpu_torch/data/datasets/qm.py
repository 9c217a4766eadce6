"""The QM7, QM7b, QM8 and QM9 datasets; counterpart of
``gcnn_keras_tpu/data/datasets/qm.py`` (kgcnn's ``QMDataset`` and its QM
datasets): molecules with their coordinates and regression targets, from
the published archives. The label tables are read by ``data/csv_table.py``
(the JAX classes call ``pandas.read_csv``), the ``.mat`` files by
``scipy.io.loadmat``, the geometries by ``mol/io.py``."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..csv_table import read_csv
from ..dataset import MemoryGraphDataset
from ..download import DownloadDataset
from ...mol.io import read_sdf_coordinates, read_xyz_file

QM9_LABEL_NAMES = ["A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2",
                   "zpve", "U0", "U", "H", "G", "Cv"]

QM7B_LABEL_NAMES = ["ae_pbe0", "p_pbe0", "p_scs", "homo_gw", "homo_pbe0",
                    "homo_zindo", "lumo_gw", "lumo_pbe0", "lumo_zindo",
                    "ip_zindo", "ea_zindo", "e1_zindo", "emax_zindo",
                    "imax_zindo"]

QM8_LABEL_NAMES = ["E1-CC2", "E2-CC2", "f1-CC2", "f2-CC2", "E1-PBE0",
                   "E2-PBE0", "f1-PBE0", "f2-PBE0", "E1-CAM", "E2-CAM",
                   "f1-CAM", "f2-CAM"]

BOHR_TO_ANGSTROM = 0.529177


class QMDataset(MemoryGraphDataset):
    """Molecules from .xyz geometries with a table of labels."""

    def __init__(self, data_directory: Optional[str] = None,
                 dataset_name: Optional[str] = None, file_name: Optional[str] = None,
                 **kwargs):
        super().__init__(data_directory=data_directory, dataset_name=dataset_name,
                         file_name=file_name, **kwargs)

    def read_in_memory_xyz(self, file_path: str, label_array: Optional[np.ndarray] = None):
        for i, (z, xyz) in enumerate(read_xyz_file(file_path)):
            g = {"node_number": np.array(z, dtype=np.int64),
                 "node_coordinates": np.array(xyz, dtype=np.float32)}
            if label_array is not None:
                g["graph_labels"] = np.asarray(label_array[i], dtype=np.float32)
            self.append(g)
        return self

    def set_range(self, max_distance: float = 4.0, max_neighbours: int = 15):
        return self.map_list("set_range", max_distance=max_distance,
                             max_neighbours=max_neighbours)

    def set_angle(self):
        return self.map_list("set_angle")

    def _append_molecules(self, mols, labels) -> "QMDataset":
        """One graph per ``(z, xyz)`` of ``mols`` with its row of
        ``labels``."""
        for i, (z, xyz) in enumerate(mols):
            self.append({"node_number": np.array(z, dtype=np.int64),
                         "node_coordinates": np.array(xyz, dtype=np.float32),
                         "graph_labels": np.asarray(labels[i]).astype(np.float32)})
        return self

    def _append_mat(self, mat, labels) -> "QMDataset":
        """One graph per molecule of a quantum-machine.org ``.mat`` (``R``
        in bohr, ``Z`` padded with zeros) with its row of ``labels``."""
        coords, charges = mat["R"], mat["Z"]
        for i in range(labels.shape[0]):
            nz = charges[i] > 0
            self.append({
                "node_number": charges[i][nz].astype(np.int64),
                "node_coordinates": (coords[i][nz] * BOHR_TO_ANGSTROM).astype(np.float32),
                "graph_labels": labels[i].astype(np.float32)})
        return self


class QM9Dataset(QMDataset):
    """QM9: 134k small molecules with 15 regression targets (the deepchem
    ``qm9.zip``: ``gdb9.sdf`` and ``gdb9.sdf.csv``)."""

    _url = "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/molnet_publish/qm9.zip"

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset("QM9", download_url=self._url,
                             download_file_name="qm9.zip", unpack_zip=True, reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name="QM9", **kwargs)

    # the canonical label names -> the deepchem release's CSV headers
    # (lowercase thermodynamic columns); read_in_memory takes both
    _DEEPCHEM_COLUMNS = {"U0": "u0", "U": "u298", "H": "h298", "G": "g298",
                         "Cv": "cv"}

    def read_in_memory(self, label_column_name: str = "U0", **kwargs):
        sdf = os.path.join(self.data_directory, "gdb9.sdf")
        csv = os.path.join(self.data_directory, "gdb9.sdf.csv")
        if not os.path.exists(csv):
            raise FileNotFoundError(f"QM9 files missing under {self.data_directory} "
                                    "(offline? SyntheticQM9Dataset needs no file)")
        labels = read_csv(csv)
        mols = read_sdf_coordinates(sdf)
        col_name = label_column_name
        if col_name not in labels:
            col_name = self._DEEPCHEM_COLUMNS.get(col_name, col_name)
        if col_name not in labels:
            raise KeyError(f"label column {label_column_name!r} not in gdb9.sdf.csv "
                           f"(columns: {labels.columns})")
        return self._append_molecules(mols, labels.column(col_name)[:, None])


class QM7Dataset(QMDataset):
    """QM7: 7165 molecules, atomization energies (kcal/mol)."""

    _url = "http://quantum-machine.org/data/qm7.mat"

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset("QM7", download_url=self._url,
                             download_file_name="qm7.mat", reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name="QM7", **kwargs)

    def read_in_memory(self, **kwargs):
        path = os.path.join(self.data_directory, "qm7.mat")
        if not os.path.exists(path):
            raise FileNotFoundError(f"qm7.mat missing under {self.data_directory}")
        from scipy.io import loadmat
        mat = loadmat(path)
        return self._append_mat(mat, mat["T"].reshape(-1, 1))


class QM7bDataset(QMDataset):
    """QM7b: 7211 molecules, 14 properties at several levels of theory."""

    _url = "http://quantum-machine.org/data/qm7b.mat"

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset("QM7b", download_url=self._url,
                             download_file_name="qm7b.mat", reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name="QM7b", **kwargs)

    def read_in_memory(self, label_column_name=None, **kwargs):
        path = os.path.join(self.data_directory, "qm7b.mat")
        if not os.path.exists(path):
            raise FileNotFoundError(f"qm7b.mat missing under {self.data_directory}")
        from scipy.io import loadmat
        mat = loadmat(path)
        labels = mat["T"]  # (N, 14)
        if label_column_name is not None and isinstance(label_column_name, str):
            col = QM7B_LABEL_NAMES.index(label_column_name)
            labels = labels[:, col:col + 1]
        return self._append_mat(mat, labels)


class QM8Dataset(QMDataset):
    """QM8: 21786 molecules, 12 electronic-spectra targets (the deepchem
    ``gdb8.tar.gz``: ``qm8.sdf`` and ``qm8.sdf.csv``)."""

    _url = "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/gdb8.tar.gz"

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset("QM8", download_url=self._url,
                             download_file_name="gdb8.tar.gz", unpack_tar=True, reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name="QM8", **kwargs)

    def read_in_memory(self, label_column_name=None, **kwargs):
        sdf = os.path.join(self.data_directory, "qm8.sdf")
        csv = os.path.join(self.data_directory, "qm8.sdf.csv")
        if not os.path.exists(csv):
            raise FileNotFoundError(f"QM8 files missing under {self.data_directory} (offline?)")
        labels = read_csv(csv)
        cols = [label_column_name] if label_column_name else QM8_LABEL_NAMES
        return self._append_molecules(read_sdf_coordinates(sdf), labels.values(cols))
