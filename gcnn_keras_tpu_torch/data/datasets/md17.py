"""The MD17, revised MD17 and ISO17 trajectories; counterpart of
``gcnn_keras_tpu/data/datasets/md17.py`` (kgcnn's ``MD17Dataset``,
``MD17RevisedDataset`` and ``ISO17Dataset``): frames of small molecules
with their energies and forces."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..dataset import MemoryGraphDataset
from ..download import DownloadDataset


class MD17Dataset(MemoryGraphDataset):
    """An MD17 trajectory (quantum-machine.org's ``md17_<name>.npz``: ``z``,
    ``R``, ``E``, ``F``)."""

    _url_base = "http://www.quantum-machine.org/gdml/data/npz/"

    def __init__(self, trajectory_name: str = "aspirin_dft", reload: bool = False,
                 **kwargs):
        self.trajectory_name = trajectory_name
        url = self._url_base + (f"{trajectory_name}.zip" if "ccsd" in trajectory_name
                                else f"md17_{trajectory_name}.npz")
        dl = DownloadDataset(f"MD17.{trajectory_name}", download_url=url,
                             download_file_name=f"md17_{trajectory_name}.npz", reload=reload)
        super().__init__(data_directory=dl.data_directory,
                         dataset_name=f"MD17.{trajectory_name}", **kwargs)

    def _append_frames(self, z, R, E, F, max_frames: Optional[int]):
        n = len(E) if max_frames is None else min(max_frames, len(E))
        for i in range(n):
            self.append({"node_number": z, "node_coordinates": R[i].astype(np.float32),
                         "energy": np.array([E[i]], dtype=np.float32),
                         "force": F[i].astype(np.float32)})
        return self

    def _npz(self, file_name: str):
        path = os.path.join(self.data_directory, file_name)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} missing (offline? SyntheticMDDataset needs no "
                                    "file)")
        return np.load(path)

    def read_in_memory(self, max_frames: Optional[int] = None, **kwargs):
        data = self._npz(f"md17_{self.trajectory_name}.npz")
        return self._append_frames(data["z"].astype(np.int64), data["R"],
                                   data["E"].reshape(-1), data["F"], max_frames)


class MD17RevisedDataset(MD17Dataset):
    """A revised MD17 trajectory (Materials Cloud record 466's
    ``rmd17_<name>.npz``: ``nuclear_charges``, ``coords``, ``energies``,
    ``forces``)."""

    _url_base = "https://archive.materialscloud.org/record/file?filename="

    def __init__(self, trajectory_name: str = "aspirin", reload: bool = False,
                 **kwargs):
        self.trajectory_name = trajectory_name
        dl = DownloadDataset(f"MD17Revised.{trajectory_name}",
                             download_url=self._url_base + f"rmd17_{trajectory_name}.npz"
                             + "&record_id=466",
                             download_file_name=f"rmd17_{trajectory_name}.npz", reload=reload)
        MemoryGraphDataset.__init__(self, data_directory=dl.data_directory,
                                    dataset_name=f"MD17Revised.{trajectory_name}", **kwargs)

    def read_in_memory(self, max_frames=None, **kwargs):
        data = self._npz(f"rmd17_{self.trajectory_name}.npz")
        return self._append_frames(data["nuclear_charges"].astype(np.int64),
                                   data["coords"], data["energies"].reshape(-1),
                                   data["forces"], max_frames)


class ISO17Dataset(MemoryGraphDataset):
    """The ISO17 C7O2H10 isomer trajectories (kgcnn's ``ISO17Dataset``):
    five ASE sqlite dbs of 129 molecules x 5000 MD frames with total
    energies (eV) and atomic forces (eV/A), split as in the SchNet paper."""

    _url = "http://quantum-machine.org/datasets/iso17.tar.gz"

    # (db file, train split index, test split index) in the reference's
    # order; the reference dbs are training material
    _DB_SPLITS = [("reference.db", 0, None), ("reference_eq.db", 1, None),
                  ("test_within.db", None, 0), ("test_other.db", None, 1),
                  ("test_eq.db", None, 2)]

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset("ISO17", download_url=self._url,
                             download_file_name="iso17.tar.gz", unpack_tar=True, reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name="ISO17", **kwargs)

    def _db_dir(self) -> str:
        # the published tarball holds a top-level iso17/ directory
        nested = os.path.join(self.data_directory, "iso17")
        return nested if os.path.isdir(nested) else self.data_directory

    def read_in_memory(self, max_frames_per_db: Optional[int] = None, **kwargs):
        """All five dbs in the reference's order. Each graph gets its
        ``train``/``test`` split index, and ``valid`` 0 where
        ``validation_ids.txt`` lists it (ids from 1 into reference.db)."""
        from ...mol.ase_db import read_ase_sqlite
        base = self._db_dir()
        first = os.path.join(base, self._DB_SPLITS[0][0])
        if not os.path.exists(first):
            raise FileNotFoundError(f"{first} missing (offline? SyntheticMDDataset needs no "
                                    "file)")
        n_reference = 0
        for db_name, train, test in self._DB_SPLITS:
            count = 0
            for row in read_ase_sqlite(os.path.join(base, db_name)):
                if max_frames_per_db is not None and count >= max_frames_per_db:
                    break
                energy = row["key_value_pairs"].get("total_energy", row["energy"])
                if energy is None:
                    raise ValueError(
                        f"{db_name} row id={row['id']} carries neither a 'total_energy' "
                        "key_value_pair nor a calculator energy column: not an ISO17-style "
                        "energy db")
                forces = row["data"].get("atomic_forces", row["forces"])
                g = {"node_number": row["numbers"],
                     "node_coordinates": row["positions"].astype(np.float32),
                     "energy": np.array([energy], dtype=np.float32)}
                if forces is not None:
                    g["force"] = np.asarray(forces, dtype=np.float32)
                if train is not None:
                    g["train"] = np.array(train)
                if test is not None:
                    g["test"] = np.array(test)
                self.append(g)
                count += 1
            if db_name == "reference.db":
                n_reference = count
        valid_file = os.path.join(base, "validation_ids.txt")
        if os.path.exists(valid_file):
            with open(valid_file) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    # from 1 into reference.db, which fills [0, n_reference):
                    # an id beyond the rows read (max_frames_per_db) must not
                    # mark a row of the next db
                    i = int(line) - 1
                    if 0 <= i < n_reference:
                        self[i]["valid"] = np.array(0)
        return self
