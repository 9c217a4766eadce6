"""Train/validation/test index splits; counterpart of
``gcnn_keras_tpu/utils/data_splitter.py`` (``idx_generator``,
``kfold_indices`` and the fork's ``kfold_swapped_val``), copied so that the
port imports nothing of the JAX package. The same seed gives the same
indices."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def idx_generator(n: int, val_ratio: float = 0.1, test_ratio: float = 0.1,
                  seed: int = 42) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One random (train, val, test) split of ``range(n)``."""
    rs = np.random.RandomState(seed)
    idx = rs.permutation(n)
    n_val = int(n * val_ratio)
    n_test = int(n * test_ratio)
    return idx[n_val + n_test:], idx[:n_val], idx[n_val:n_val + n_test]


def kfold_indices(n: int, k: int = 5, seed: int = 42
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``k`` (train, test) folds of one random permutation of ``range(n)``."""
    rs = np.random.RandomState(seed)
    folds = np.array_split(rs.permutation(n), k)
    for i in range(k):
        yield np.concatenate([folds[j] for j in range(k) if j != i]), folds[i]


def kfold_swapped_val(n: int, k: int = 3, seed: int = 42
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The fork's ensemble scheme: fold i trains on all folds but two,
    validates on fold i+1 and tests on fold i, so that every member sees a
    validation slice of its own. With k < 3 the validation fold is the test
    fold (the train set would be empty otherwise)."""
    rs = np.random.RandomState(seed)
    folds = np.array_split(rs.permutation(n), k)
    for i in range(k):
        vi = (i + 1) % k if k >= 3 else i
        train = np.concatenate([folds[j] for j in range(k) if j not in (i, vi)])
        yield train, folds[vi], folds[i]
