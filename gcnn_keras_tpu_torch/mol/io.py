"""Molecular file IO; counterpart of ``gcnn_keras_tpu/mol/io.py``, copied so
that the port imports nothing of the JAX package: element symbols by atomic
number, the readers of multi-frame xyz and extended-xyz files and of the
coordinates of SDF/MOL V2000 records, and the xyz writer."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

PERIODIC_TABLE = [
    "n", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu",
]
SYMBOL_TO_Z = {s: i for i, s in enumerate(PERIODIC_TABLE)}


def _symbol_to_z(sym: str) -> int:
    """The atomic number of an element symbol in any case, or of a number
    written as digits."""
    s = sym.strip()
    if s.isdigit():
        return int(s)
    return SYMBOL_TO_Z[s.capitalize() if len(s) < 2 else s[0].upper() + s[1:].lower()]


def read_xyz_file(path: str) -> List[Tuple[List[int], List[List[float]]]]:
    """Multi-molecule .xyz -> list of (atomic_numbers, coordinates)."""
    out = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        n = int(line.split()[0])
        atoms, coords = [], []
        for j in range(i + 2, i + 2 + n):
            parts = lines[j].split()
            atoms.append(_symbol_to_z(parts[0]))
            coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
        out.append((atoms, coords))
        i += 2 + n
    return out


def read_extxyz_file(path: str) -> List[Dict[str, np.ndarray]]:
    """Extended-xyz with per-frame key=value comment line and per-atom extra
    columns (the fork's prepare_data.py input format). Returns GraphDict-like
    dicts with node_number, node_coordinates and any recognized per-frame
    (energy, charge) / per-atom (forces) fields."""
    frames = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].split()[0])
        comment = lines[i + 1]
        props = _parse_extxyz_comment(comment)
        atoms, coords, extras = [], [], []
        columns = props.get("Properties", "species:S:1:pos:R:3")
        col_spec = _parse_properties(columns)
        for j in range(i + 2, i + 2 + n):
            parts = lines[j].split()
            row = {}
            c = 0
            for name, kind, width in col_spec:
                vals = parts[c:c + width]
                c += width
                if kind == "S":
                    row[name] = vals[0]
                else:
                    row[name] = [float(v) for v in vals]
            atoms.append(_symbol_to_z(row.get("species", parts[0])))
            coords.append(row.get("pos", [float(parts[1]), float(parts[2]),
                                          float(parts[3])]))
            extras.append(row)
        frame = {
            "node_number": np.array(atoms, dtype=np.int64),
            "node_coordinates": np.array(coords, dtype=np.float32),
        }
        for key in ("energy", "Energy"):
            if key in props:
                frame["energy"] = np.array([float(props[key])], dtype=np.float32)
        for key in ("charge", "total_charge"):
            if key in props:
                frame["total_charge"] = np.array([float(props[key])], dtype=np.float32)
        if "Lattice" in props:
            lat = np.array([float(v) for v in props["Lattice"].split()],
                           dtype=np.float32).reshape(3, 3)
            frame["graph_lattice"] = lat
        for extra_key in ("forces", "force"):
            if extras and extra_key in extras[0]:
                frame["force"] = np.array([e[extra_key] for e in extras],
                                          dtype=np.float32)
        frames.append(frame)
        i += 2 + n
    return frames


def _parse_extxyz_comment(comment: str) -> Dict[str, str]:
    """``key=value`` pairs of an extended-xyz comment line (values in
    double quotes may hold spaces)."""
    out = {}
    token = ""
    key = None
    in_quote = False
    for ch in comment.strip() + " ":
        if ch == '"':
            in_quote = not in_quote
        elif ch == "=" and not in_quote and key is None:
            key = token
            token = ""
        elif ch == " " and not in_quote:
            if key is not None:
                out[key] = token
                key = None
            token = ""
        else:
            token += ch
    return out


def _parse_properties(spec: str) -> List[Tuple[str, str, int]]:
    """``Properties=name:kind:width:...`` -> ``[(name, kind, width), ...]``."""
    parts = spec.split(":")
    return [(parts[k], parts[k + 1], int(parts[k + 2])) for k in range(0, len(parts), 3)]


def write_xyz_file(path: str, molecules, comments: Optional[List[str]] = None):
    """Write ``(atomic_numbers, coordinates)`` pairs as a multi-frame .xyz
    file, coordinates to 8 decimals, ``comments[i]`` as frame i's comment
    line."""
    with open(path, "w") as f:
        for idx, (z, xyz) in enumerate(molecules):
            f.write(f"{len(z)}\n")
            f.write((comments[idx] if comments else "") + "\n")
            for zi, (x, y, w) in zip(z, xyz):
                sym = PERIODIC_TABLE[int(zi)]
                f.write(f"{sym} {x:.8f} {y:.8f} {w:.8f}\n")


def read_sdf_coordinates(path: str) -> List[Tuple[List[int], List[List[float]]]]:
    """Minimal SDF/MOL V2000 reader: atoms + coordinates per record."""
    out = []
    with open(path) as f:
        content = f.read()
    for record in content.split("$$$$"):
        lines = record.strip("\n").split("\n")
        if len(lines) < 4:
            continue
        counts = lines[3]
        try:
            n_atoms = int(counts[:3])
        except ValueError:
            continue
        atoms, coords = [], []
        for j in range(4, 4 + n_atoms):
            p = lines[j].split()
            coords.append([float(p[0]), float(p[1]), float(p[2])])
            atoms.append(_symbol_to_z(p[3]))
        out.append((atoms, coords))
    return out
