"""The Materials Project / MatBench crystal datasets; counterpart of
``gcnn_keras_tpu/data/datasets/matproject.py`` (kgcnn's ``CrystalDataset``
and its ``MatProject*`` datasets): the structures of a matbench task's
``.json.gz`` as periodic graphs with their radius bonds
(``crystal/graph_builder.py``)."""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..dataset import MemoryGraphDataset
from ..download import DownloadDataset
from ...crystal.graph_builder import add_radius_bonds, structure_to_graph
from ...mol.io import SYMBOL_TO_Z


class CrystalDataset(MemoryGraphDataset):
    """Crystals from structures (kgcnn's ``data/crystal.py``)."""

    def structures_to_graphs(self, structures, labels=None, radius: float = 5.0,
                             max_neighbours: Optional[int] = 17):
        for i, s in enumerate(structures):
            g = add_radius_bonds(structure_to_graph(s), radius=radius,
                                 max_neighbours=max_neighbours)
            if labels is not None:
                g["graph_labels"] = np.atleast_1d(np.asarray(labels[i], dtype=np.float32))
            self.append(g)
        return self


class MatBenchDataset(CrystalDataset):
    """A matbench task's ``<task>.json.gz`` (``{"data": [[pymatgen
    Structure dict, target], ...]}``), fetched and unpacked under the
    class's name less ``Dataset``."""

    _task: str = ""  # e.g. "matbench_mp_e_form"
    _label_is_class: bool = False

    def __init__(self, reload: bool = False, **kwargs):
        name = type(self).__name__.replace("Dataset", "")
        url = f"https://ml.materialsproject.org/projects/{self._task}.json.gz"
        dl = DownloadDataset(name, download_url=url, download_file_name=f"{self._task}.json.gz",
                             extract_gz=True, reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name=name, **kwargs)

    def read_in_memory(self, radius: float = 5.0, max_neighbours: int = 17,
                       max_structures: Optional[int] = None, **kwargs):
        path = os.path.join(self.data_directory, f"{self._task}.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} missing (offline?)")
        with open(path) as f:
            rows = json.load(f)["data"]
        if max_structures:
            rows = rows[:max_structures]
        for struct_dict, label in rows:
            lattice = np.array(struct_dict["lattice"]["matrix"])
            frac = np.array([s["abc"] for s in struct_dict["sites"]])
            z = np.array([_specie_z(s) for s in struct_dict["sites"]])
            g = structure_to_graph({"frac_coords": frac, "lattice": lattice,
                                    "atomic_numbers": z})
            g = add_radius_bonds(g, radius=radius, max_neighbours=max_neighbours)
            if self._label_is_class:
                g["graph_labels"] = np.array([1.0 if label else 0.0], dtype=np.float32)
            else:
                g["graph_labels"] = np.array([label], dtype=np.float32)
            self.append(g)
        return self


class MatProjectEFormDataset(MatBenchDataset):
    """matbench_mp_e_form: formation energy per atom (eV/atom)."""
    _task = "matbench_mp_e_form"


class MatProjectGapDataset(MatBenchDataset):
    """matbench_mp_gap: DFT band gap (eV)."""
    _task = "matbench_mp_gap"


class MatProjectIsMetalDataset(MatBenchDataset):
    """matbench_mp_is_metal: metal or not."""
    _task = "matbench_mp_is_metal"
    _label_is_class = True


class MatProjectDielectricDataset(MatBenchDataset):
    """matbench_dielectric: refractive index."""
    _task = "matbench_dielectric"


class MatProjectJdft2dDataset(MatBenchDataset):
    """matbench_jdft2d: exfoliation energy of 2D materials (meV/atom)."""
    _task = "matbench_jdft2d"


class MatProjectLogGVRHDataset(MatBenchDataset):
    """matbench_log_gvrh: log10 of the VRH shear modulus."""
    _task = "matbench_log_gvrh"


class MatProjectLogKVRHDataset(MatBenchDataset):
    """matbench_log_kvrh: log10 of the VRH bulk modulus."""
    _task = "matbench_log_kvrh"


class MatProjectPerovskitesDataset(MatBenchDataset):
    """matbench_perovskites: perovskite formation energy (eV/cell)."""
    _task = "matbench_perovskites"


class MatProjectPhononsDataset(MatBenchDataset):
    """matbench_phonons: highest phonon peak frequency (1/cm)."""
    _task = "matbench_phonons"


def _specie_z(site: dict) -> int:
    return SYMBOL_TO_Z[site["species"][0]["element"]]


class MatBenchDataset2020(MatBenchDataset):
    """A matbench v0.1 task by name (kgcnn's ``MatBenchDataset2020``), e.g.
    ``dataset_name="matbench_mp_e_form"``."""

    def __init__(self, dataset_name: str = "matbench_mp_e_form", reload: bool = False,
                 **kwargs):
        self._task = dataset_name
        self._label_is_class = dataset_name in ("matbench_mp_is_metal",)
        super().__init__(reload=reload, **kwargs)
