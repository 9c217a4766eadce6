"""A reader of the ASE sqlite database format that needs no ``ase``;
counterpart of ``gcnn_keras_tpu/mol/ase_db.py``.

ISO17 (kgcnn's ``ISO17Dataset`` reads it through ``ase.db.connect``) ships
five ``.db`` files in ASE's sqlite layout: one ``systems`` table whose
array columns are raw little-endian blobs (``numbers`` int32,
``positions``/``forces`` float64), scalar metadata in plain columns, the
user's key/value pairs as a JSON text column (``key_value_pairs``) and
further arrays as a JSON text column (``data``) in which a numpy array is
``{"__ndarray__": [shape, dtype, flat_values]}``. The standard library's
``sqlite3`` and ``json`` read it.
"""
from __future__ import annotations

import json
import os
import sqlite3
from typing import Any, Dict, Iterator, Optional

import numpy as np


def _decode_json_arrays(obj: Any) -> Any:
    """Undo ASE's JSON ndarray encoding recursively."""
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            shape, dtype, values = obj["__ndarray__"]
            return np.asarray(values, dtype=dtype).reshape(shape)
        return {k: _decode_json_arrays(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_json_arrays(v) for v in obj]
    return obj


def _deblob(buf: Optional[bytes], dtype, shape=None) -> Optional[np.ndarray]:
    """ASE stores array columns as raw little-endian bytes."""
    if buf is None:
        return None
    arr = np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder("<"))
    arr = arr.astype(np.dtype(dtype), copy=True)  # native order, writable
    if shape is not None:
        arr = arr.reshape(shape)
    return arr


def read_ase_sqlite(path: str) -> Iterator[Dict[str, Any]]:
    """Yield one dict per row of an ASE sqlite db's ``systems`` table.

    Keys: ``id``, ``numbers`` (int64, (N,)), ``positions`` (float64,
    (N, 3)), ``energy`` (float or None, the calculator energy column),
    ``forces`` ((N, 3) or None), ``key_value_pairs`` (dict), ``data``
    (dict with ndarrays decoded).  Rows come back ordered by ``id`` —
    the insertion order ASE wrote them in.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"ASE db file missing: {path}")
    conn = sqlite3.connect(path)
    conn.row_factory = sqlite3.Row
    try:
        cols = {r[1] for r in conn.execute("PRAGMA table_info(systems)")}
        required = {"id", "numbers", "positions"}
        if not required <= cols:
            raise ValueError(
                f"{path} has no ASE 'systems' table with {sorted(required)} "
                f"(found columns: {sorted(cols)})")
        for row in conn.execute("SELECT * FROM systems ORDER BY id"):
            numbers = _deblob(row["numbers"], np.int32)
            n = len(numbers) if numbers is not None else 0
            kvp_raw = row["key_value_pairs"] if "key_value_pairs" in cols else None
            data_raw = row["data"] if "data" in cols else None
            if isinstance(kvp_raw, bytes):
                kvp_raw = kvp_raw.decode("utf-8")
            if isinstance(data_raw, bytes):
                data_raw = data_raw.decode("utf-8")
            yield {
                "id": row["id"],
                "numbers": None if numbers is None else numbers.astype(np.int64),
                "positions": _deblob(row["positions"], np.float64, (n, 3)),
                "energy": row["energy"] if "energy" in cols else None,
                "forces": _deblob(row["forces"], np.float64, (n, 3))
                if "forces" in cols else None,
                "key_value_pairs": _decode_json_arrays(json.loads(kvp_raw))
                if kvp_raw else {},
                "data": _decode_json_arrays(json.loads(data_raw))
                if data_raw else {},
            }
    finally:
        conn.close()
