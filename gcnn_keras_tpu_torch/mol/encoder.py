"""``OneHotEncoder``; counterpart of ``gcnn_keras_tpu/mol/encoder.py``
(kgcnn's ``mol/encoder.py``): a categorical value as a one-hot vector,
with a last slot for values outside the categories."""
from __future__ import annotations

from typing import Any, List

import numpy as np


class OneHotEncoder:
    def __init__(self, categories: List[Any], add_unknown: bool = True,
                 dtype=np.float32):
        self.categories = list(categories)
        self.add_unknown = add_unknown
        self.dtype = dtype
        self.found_values: List[Any] = []

    def __call__(self, value) -> np.ndarray:
        dim = len(self.categories) + (1 if self.add_unknown else 0)
        out = np.zeros(dim, dtype=self.dtype)
        try:
            out[self.categories.index(value)] = 1
        except ValueError:
            if self.add_unknown:
                out[-1] = 1
            if value not in self.found_values:
                self.found_values.append(value)
        return out

    def get_config(self):
        return {"categories": self.categories, "add_unknown": self.add_unknown}
