"""Geometry, energy, force, charge and ESP files, or one extended-xyz file,
to a pickled ``MemoryGraphDataset`` in atomic units; counterpart of the root
``prepare_data.py``.

    python -m gcnn_keras_tpu_torch.scripts.prepare_data --extxyz geoms.extxyz --out DIR
    python -m gcnn_keras_tpu_torch.scripts.prepare_data --geoms geoms.xyz
        [--energies energies.txt] [--forces forces.xyz] [--charges charges.txt]
        [--total-charges q.txt] [--esp esp.txt] [--esp-grad esp_grad.xyz] --out DIR
        [--cutoff 10] [--max-neighbours 25] [--units atomic|angstrom_ev] [--angles]

``--units angstrom_ev`` converts coordinates to Bohr, energies to Hartree
and forces to Hartree/Bohr. Every frame gets ``set_range`` edges within
``--cutoff`` Angstrom (in Bohr) as ``edge_indices``, with ``--angles`` its
angle triples too, and the dataset goes to ``DIR/dataset.pickle``, the
file that ``run_force_training`` reads through ``data_path``. The script
runs on the host only, so it takes no ``--device``.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
from gcnn_keras_tpu_torch.mol.io import read_extxyz_file, read_xyz_file
from gcnn_keras_tpu_torch.utils import constants

# the root script's defaults: a cutoff of 10 A (taken to Bohr), 25 neighbours
DEFAULT_CUTOFF_A = 10.0
DEFAULT_MAX_NEIGHBORS = 25


def read_column_file(path: Optional[str]):
    """The numbers of a text file as one column, or None without a path."""
    return np.loadtxt(path).reshape(-1) if path else None


def read_per_atom_file(path: Optional[str]):
    """An xyz-like file of per-atom vectors (forces.xyz, esp_grad.xyz): one
    float64 (n, 3) array a frame, or None without a path."""
    if not path:
        return None
    return [np.array(xyz, dtype=np.float64) for _, xyz in read_xyz_file(path)]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extxyz", default=None)
    ap.add_argument("--geoms", default=None)
    ap.add_argument("--energies", default=None)
    ap.add_argument("--forces", default=None)
    ap.add_argument("--charges", default=None, help="per-atom charges, one row per frame")
    ap.add_argument("--total-charges", default=None)
    ap.add_argument("--esp", default=None)
    ap.add_argument("--esp-grad", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cutoff", type=float, default=DEFAULT_CUTOFF_A)
    ap.add_argument("--max-neighbours", type=int, default=DEFAULT_MAX_NEIGHBORS)
    ap.add_argument("--units", choices=["angstrom_ev", "atomic"], default="atomic",
                    help="units of the INPUT files")
    ap.add_argument("--angles", action="store_true", help="add angle triples (HDNNP)")
    return ap


def extxyz_frames(args, to_bohr: float, to_hartree: float) -> List[dict]:
    """The frames of ``--extxyz``, converted to atomic units where the input
    is in Angstrom and eV."""
    frames = []
    for fr in read_extxyz_file(args.extxyz):
        g = dict(fr)
        if args.units == "angstrom_ev":
            g["node_coordinates"] = g["node_coordinates"] * to_bohr
            if "energy" in g:
                g["energy"] = g["energy"] * to_hartree
            if "force" in g:
                g["force"] = g["force"] * (to_hartree / to_bohr)
        frames.append(g)
    return frames


def column_frames(args, to_bohr: float, to_hartree: float) -> List[dict]:
    """The frames of ``--geoms`` with the columns of the other files; the
    total charge from ``--total-charges``, else the sum of the atoms'
    charges, else 0."""
    energies = read_column_file(args.energies)
    forces = read_per_atom_file(args.forces)
    esp_grad = read_per_atom_file(args.esp_grad)
    charges = np.loadtxt(args.charges) if args.charges else None
    esp = np.loadtxt(args.esp) if args.esp else None
    total_charges = read_column_file(args.total_charges)
    angstrom = args.units == "angstrom_ev"
    frames = []
    for i, (z, xyz) in enumerate(read_xyz_file(args.geoms)):
        xyz = np.array(xyz, dtype=np.float64)
        if angstrom:
            xyz = xyz * to_bohr
        g = {"node_number": np.array(z, dtype=np.int64),
             "node_coordinates": xyz.astype(np.float32)}
        if energies is not None:
            g["energy"] = np.array([energies[i] * (to_hartree if angstrom else 1.0)],
                                   dtype=np.float32)
        if forces is not None:
            g["force"] = (forces[i] * ((to_hartree / to_bohr) if angstrom else 1.0)
                          ).astype(np.float32)
        if charges is not None:
            g["charge"] = np.atleast_2d(charges)[i][:len(z)].astype(np.float32)
        if esp is not None:
            g["esp"] = np.atleast_2d(esp)[i][:len(z)].astype(np.float32)
        if esp_grad is not None:
            g["esp_grad"] = esp_grad[i].astype(np.float32)
        if total_charges is not None:
            g["total_charge"] = np.array([total_charges[i]], dtype=np.float32)
        else:
            g["total_charge"] = np.array(
                [float(g["charge"].sum())] if "charge" in g else [0.0], dtype=np.float32)
        frames.append(g)
    return frames


def main(argv: Optional[List[str]] = None) -> MemoryGraphDataset:
    args = parser().parse_args(argv)
    to_bohr, to_hartree = constants.angstrom_to_bohr, constants.ev_to_hartree
    ds = MemoryGraphDataset(data_directory=args.out, dataset_name="prepared",
                            file_name="dataset")
    read = extxyz_frames if args.extxyz else column_frames
    for g in read(args, to_bohr, to_hartree):
        ds.append(g)
    # the coordinates are in Bohr; the cutoff is given in Angstrom
    ds.map_list("set_range", max_distance=args.cutoff * to_bohr,
                max_neighbours=args.max_neighbours)
    if args.angles:
        ds.map_list("set_angle")
    for g in ds:
        g["edge_indices"] = g["range_indices"]
    os.makedirs(args.out, exist_ok=True)
    ds.save()
    print(f"prepared {len(ds)} frames -> {ds.file_path}.pickle")
    return ds


if __name__ == "__main__":
    main()
