"""Label scalers; counterpart of ``gcnn_keras_tpu/data/scalers.py``
(``StandardLabelScaler``, ``StandardScaler``, ``QMGraphLabelScaler``,
``ExtensiveMolecularLabelScaler``, ``EnergyForceExtensiveLabelScaler`` and
``composition_matrix``), copied so that the port imports nothing of the
JAX package. The same data give the same numbers and the same
``scaler.json``.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

_MAX_Z = 96


class StandardLabelScaler:
    """``y <- (y - mean) / std`` per column; a column of zero spread keeps
    a scale of 1."""

    def __init__(self, with_mean: bool = True, with_std: bool = True, **kwargs):
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None

    def fit(self, y: np.ndarray, **kwargs):
        y = np.asarray(y, dtype=np.float64)
        self.mean_ = y.mean(axis=0) if self.with_mean else np.zeros(y.shape[1:])
        std = y.std(axis=0) if self.with_std else np.ones(y.shape[1:])
        self.scale_ = np.where(std > 0, std, 1.0)
        return self

    def transform(self, y: np.ndarray) -> np.ndarray:
        return (np.asarray(y) - self.mean_) / self.scale_

    def inverse_transform(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y) * self.scale_ + self.mean_

    def fit_transform(self, y, **kwargs):
        return self.fit(y, **kwargs).transform(y)

    def get_scaling(self) -> np.ndarray:
        return self.scale_

    def get_config(self) -> dict:
        return {"with_mean": self.with_mean, "with_std": self.with_std,
                "mean_": None if self.mean_ is None else np.asarray(self.mean_).tolist(),
                "scale_": None if self.scale_ is None else np.asarray(self.scale_).tolist()}

    def set_config(self, cfg: dict):
        self.with_mean = cfg.get("with_mean", True)
        self.with_std = cfg.get("with_std", True)
        self.mean_ = None if cfg.get("mean_") is None else np.array(cfg["mean_"])
        self.scale_ = None if cfg.get("scale_") is None else np.array(cfg["scale_"])
        return self


class StandardScaler(StandardLabelScaler):
    """The same standardization of a property of every graph of a dataset
    (per-node or per-graph feature matrices, stacked)."""

    def fit_dataset(self, dataset, key: str = "node_attributes"):
        return self.fit(np.concatenate([np.asarray(g[key]) for g in dataset], axis=0))

    def transform_dataset(self, dataset, key: str = "node_attributes"):
        for g in dataset:
            g[key] = self.transform(np.asarray(g[key])).astype(np.float32)
        return dataset


class QMGraphLabelScaler:
    """One scaler per target column of multi-target QM labels: a
    ``StandardLabelScaler`` or an ``ExtensiveMolecularLabelScaler``, given
    as an instance or as ``{"class_name": ..., "config": {...}}``."""

    def __init__(self, scaler: List):
        self.scalers = []
        for s in scaler:
            if isinstance(s, dict):
                cls = {"StandardLabelScaler": StandardLabelScaler,
                       "ExtensiveMolecularLabelScaler": ExtensiveMolecularLabelScaler}[
                    s["class_name"]]
                self.scalers.append(cls(**s.get("config", {})))
            else:
                self.scalers.append(s)

    def fit_transform(self, y: np.ndarray, atomic_number=None) -> np.ndarray:
        """Fit each column's scaler (the extensive ones on ``atomic_number``,
        one array a molecule) and return the scaled labels (M, T)."""
        y = np.asarray(y, dtype=np.float64)
        out = np.zeros_like(y)
        for i, s in enumerate(self.scalers):
            col = y[:, i]
            if isinstance(s, ExtensiveMolecularLabelScaler):
                out[:, i] = s.fit(col, atomic_number).transform(col, atomic_number)
            else:
                out[:, i] = s.fit(col[:, None]).transform(col[:, None])[:, 0]
        return out

    def inverse_transform(self, y: np.ndarray, atomic_number=None) -> np.ndarray:
        y = np.asarray(y, dtype=np.float64)
        out = np.zeros_like(y)
        for i, s in enumerate(self.scalers):
            col = y[:, i]
            if isinstance(s, ExtensiveMolecularLabelScaler):
                out[:, i] = s.inverse_transform(col, atomic_number)
            else:
                out[:, i] = s.inverse_transform(col[:, None])[:, 0]
        return out

    def get_scaling(self) -> np.ndarray:
        """Each column's scale."""
        return np.array([np.asarray(s.get_scaling()).reshape(-1)[0]
                         for s in self.scalers])


def composition_matrix(atomic_numbers: Sequence[np.ndarray],
                       max_z: int = _MAX_Z) -> np.ndarray:
    """Counts ``X[i, z]``: the atoms of element ``z`` in molecule ``i``."""
    x = np.zeros((len(atomic_numbers), max_z), dtype=np.float64)
    for i, z in enumerate(atomic_numbers):
        zi, cnt = np.unique(np.asarray(z, dtype=np.int64), return_counts=True)
        x[i, zi] = cnt
    return x


class ExtensiveMolecularLabelScaler:
    """Removes per-element offsets, linear in the composition, fitted by
    ridge regression, then divides by the residuals' standard deviation
    (``standardize_scale``)."""

    def __init__(self, alpha: float = 1e-9, fit_atomic_number: bool = True,
                 standardize_scale: bool = True, **kwargs):
        self.alpha = alpha
        self.standardize_scale = standardize_scale
        self.ridge_coef_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None

    def fit(self, y: np.ndarray, atomic_number: Sequence[np.ndarray], **kwargs):
        y = np.asarray(y, dtype=np.float64)
        y2 = y[:, None] if y.ndim == 1 else y
        x = composition_matrix(atomic_number)
        # closed-form ridge: (X^T X + a I)^-1 X^T y
        xtx = x.T @ x + self.alpha * np.eye(x.shape[1])
        self.ridge_coef_ = np.linalg.solve(xtx, x.T @ y2)
        resid = y2 - x @ self.ridge_coef_
        std = resid.std(axis=0) if self.standardize_scale else np.ones(y2.shape[1])
        self.scale_ = np.where(std > 0, std, 1.0)
        return self

    def _offset(self, atomic_number) -> np.ndarray:
        return composition_matrix(atomic_number) @ self.ridge_coef_

    def transform(self, y: np.ndarray, atomic_number) -> np.ndarray:
        y = np.asarray(y, dtype=np.float64)
        y2 = y[:, None] if y.ndim == 1 else y
        out = (y2 - self._offset(atomic_number)) / self.scale_
        return out[:, 0] if y.ndim == 1 else out

    def inverse_transform(self, y: np.ndarray, atomic_number) -> np.ndarray:
        y = np.asarray(y, dtype=np.float64)
        y2 = y[:, None] if y.ndim == 1 else y
        out = y2 * self.scale_ + self._offset(atomic_number)
        return out[:, 0] if y.ndim == 1 else out

    def fit_transform(self, y, atomic_number, **kwargs):
        return self.fit(y, atomic_number).transform(y, atomic_number)

    def get_scaling(self) -> np.ndarray:
        return self.scale_

    def get_config(self) -> dict:
        return {"alpha": self.alpha, "standardize_scale": self.standardize_scale,
                "ridge_coef_": None if self.ridge_coef_ is None else self.ridge_coef_.tolist(),
                "scale_": None if self.scale_ is None else np.asarray(self.scale_).tolist()}

    def set_config(self, cfg: dict):
        self.alpha = cfg.get("alpha", 1e-9)
        self.standardize_scale = cfg.get("standardize_scale", True)
        self.ridge_coef_ = None if cfg.get("ridge_coef_") is None else np.array(cfg["ridge_coef_"])
        self.scale_ = None if cfg.get("scale_") is None else np.array(cfg["scale_"])
        return self


class EnergyForceExtensiveLabelScaler(ExtensiveMolecularLabelScaler):
    """Energies lose their extensive offset and are scaled; forces are
    divided by the same factor (the offsets do not depend on positions).
    Works on datasets in place and saves to, and loads from, JSON."""

    def __init__(self, standardize_scale: bool = True,
                 energy: str = "energy", force: str = "force",
                 atomic_number: str = "node_number", **kwargs):
        super().__init__(standardize_scale=standardize_scale, **kwargs)
        self.energy_key = energy
        self.force_key = force
        self.atomic_number_key = atomic_number

    def transform_forces(self, forces: Sequence[np.ndarray]) -> List[np.ndarray]:
        return [np.asarray(f) / self.scale_[0] for f in forces]

    def inverse_transform_forces(self, forces: Sequence[np.ndarray]) -> List[np.ndarray]:
        return [np.asarray(f) * self.scale_[0] for f in forces]

    def _labels(self, dataset):
        y = np.array([np.asarray(g[self.energy_key]).reshape(-1)[0] for g in dataset])
        return y, [np.asarray(g[self.atomic_number_key]) for g in dataset]

    def fit_dataset(self, dataset):
        return self.fit(*self._labels(dataset))

    def _relabel(self, dataset, energies, forces):
        for g, e in zip(dataset, energies):
            g[self.energy_key] = np.array([e], dtype=np.float32)
            if self.force_key in g:
                g[self.force_key] = forces([g[self.force_key]])[0].astype(np.float32)
        return dataset

    def transform_dataset(self, dataset):
        """Scale every graph's energy and forces in place (new arrays: the
        dicts of another list that share them keep theirs)."""
        y, z = self._labels(dataset)
        return self._relabel(dataset, self.transform(y, z), self.transform_forces)

    def inverse_transform_dataset(self, dataset):
        y, z = self._labels(dataset)
        return self._relabel(dataset, self.inverse_transform(y, z),
                             self.inverse_transform_forces)

    def save(self, file_path: str):
        with open(file_path, "w") as f:
            json.dump(self.get_config(), f)

    def load(self, file_path: str):
        with open(file_path) as f:
            self.set_config(json.load(f))
        return self
