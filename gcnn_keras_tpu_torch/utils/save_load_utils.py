"""Extended-xyz output; counterpart of
``gcnn_keras_tpu/utils/save_load_utils.py`` (``save_extxyz``; its history
and split-index helpers are not ported)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..mol.io import PERIODIC_TABLE


def save_extxyz(filename: str, frames: Sequence[dict],
                array_keys: Sequence[str] = ("force",),
                info_keys: Sequence[str] = ("energy", "total_charge")):
    """Write graph dicts as extended xyz frames.

    ``array_keys``: per-atom (n,) or (n, k) keys written as extra
    ``Properties`` columns (``force`` as ``forces``); ``info_keys``: scalar
    keys written into the comment line (``total_charge`` as ``charge``);
    ``graph_lattice`` as ``Lattice``."""
    with open(filename, "w") as f:
        for g in frames:
            z = np.asarray(g["node_number"])
            xyz = np.asarray(g["node_coordinates"])
            n = len(z)
            props = "Properties=species:S:1:pos:R:3"
            cols = []
            for key in array_keys:
                if key not in g:
                    continue
                arr = np.asarray(g[key]).reshape(n, -1)
                name = "forces" if key == "force" else key
                props += f":{name}:R:{arr.shape[1]}"
                cols.append(arr)
            comment = [props]
            for key in info_keys:
                if key not in g:
                    continue
                name = "charge" if key == "total_charge" else key
                comment.append(f"{name}={float(np.asarray(g[key]).reshape(-1)[0])}")
            if "graph_lattice" in g:
                lat = " ".join(str(float(v)) for v in np.asarray(g["graph_lattice"]).reshape(-1))
                comment.append(f'Lattice="{lat}"')
            f.write(f"{n}\n{' '.join(comment)}\n")
            for i in range(n):
                row = f"{PERIODIC_TABLE[int(z[i])]} " + " ".join(f"{v:.8f}" for v in xyz[i])
                for arr in cols:
                    row += " " + " ".join(f"{v:.8f}" for v in arr[i])
                f.write(row + "\n")
