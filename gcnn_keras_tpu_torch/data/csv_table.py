"""CSV tables read with the standard library's ``csv`` module and numpy,
where the JAX package's dataset classes call ``pandas.read_csv``; the
card's machine has no pandas.

A column comes out as ``pandas.read_csv`` gives it with its defaults:
int64 where every cell is an integer, float64 where every cell is a number
or empty, else an object array of the strings; a cell that is empty or
one of pandas' default missing-value strings is NaN. Python's ``float``
rounds each number correctly, as pandas does with
``float_precision="round_trip"``; pandas' default parser can land some
ulps off on long decimals, which the classes' own ``float32`` cast of
their labels removes.
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence, Union

import numpy as np

# pandas' default ``na_values``
NA_STRINGS = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                        "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
                        "n/a", "nan", "null"])


def _typed(cells: List[str]) -> np.ndarray:
    """``cells`` as pandas types a column (module docstring)."""
    present = [c for c in cells if c.strip() not in NA_STRINGS]
    if len(present) == len(cells):
        try:
            return np.array([int(c) for c in cells], dtype=np.int64)
        except (ValueError, OverflowError):
            pass
    try:
        return np.array([float("nan") if c.strip() in NA_STRINGS else float(c) for c in cells],
                        dtype=np.float64)
    except ValueError:
        return np.array([float("nan") if c.strip() in NA_STRINGS else c for c in cells],
                        dtype=object)


class CsvTable:
    """The columns of a CSV file with a header row, typed on first use."""

    def __init__(self, header: Sequence[str], rows: Sequence[Sequence[str]]):
        self.columns = list(header)
        self._rows = [list(r) + [""] * (len(self.columns) - len(r)) for r in rows]
        self._typed: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def column(self, name: str) -> np.ndarray:
        """One column (``df[name].to_numpy()``); ``KeyError`` if absent."""
        if name not in self._typed:
            j = self.columns.index(name) if name in self.columns else None
            if j is None:
                raise KeyError(name)
            self._typed[name] = _typed([r[j] for r in self._rows])
        return self._typed[name]

    def values(self, names: Union[str, Sequence[str]]) -> np.ndarray:
        """``df[names].to_numpy()``: one column for a name, the ``(rows,
        len(names))`` stack of numeric columns for a list."""
        if isinstance(names, str):
            return self.column(names)
        return np.stack([self.column(n) for n in names], axis=1) if len(self) \
            else np.zeros((0, len(names)))


def read_csv(path: str) -> CsvTable:
    """The CSV file at ``path``; its first row is the header."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        rows = [r for r in reader if r]
    return CsvTable(header, rows)
