"""History, split-index and extended-xyz files; counterpart of
``gcnn_keras_tpu/utils/save_load_utils.py`` (``save_history``,
``load_history``, ``save_training_indices``, ``load_training_indices``,
``save_extxyz``). A history file ending in ``.json`` is JSON, any other a
pickle; split indices are a pickled list of arrays, as the JAX package
writes them."""
from __future__ import annotations

import json
import pickle
from typing import Dict, List, Sequence

import numpy as np

from ..mol.io import PERIODIC_TABLE


def save_history(history: Dict[str, List[float]], filename: str):
    with open(filename, "w" if filename.endswith(".json") else "wb") as f:
        if filename.endswith(".json"):
            json.dump({k: [float(x) for x in v] for k, v in history.items()}, f)
        else:
            pickle.dump(history, f)


def load_history(filename: str) -> Dict[str, List[float]]:
    if filename.endswith(".json"):
        with open(filename) as f:
            return json.load(f)
    with open(filename, "rb") as f:
        return pickle.load(f)


def save_training_indices(indices: Sequence[np.ndarray], filename: str):
    with open(filename, "wb") as f:
        pickle.dump([np.asarray(i) for i in indices], f)


def load_training_indices(filename: str) -> List[np.ndarray]:
    with open(filename, "rb") as f:
        return pickle.load(f)


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
