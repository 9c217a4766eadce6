"""Visual-graph datasets on disk; counterpart of
``gcnn_keras_tpu/data/visual_graph.py`` (kgcnn's ``VisualGraphDataset``):
a folder of ``{index}.json`` elements of the ``visual_graph_datasets``
format. That package, which downloads them, is optional (``ensure``);
``data/datasets/vgd.py``'s datasets made from a seed need no file."""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .dataset import MemoryGraphDataset


class VisualGraphDataset(MemoryGraphDataset):
    def __init__(self, name: Optional[str] = None,
                 data_directory: Optional[str] = None, **kwargs):
        super().__init__(data_directory=data_directory,
                         dataset_name=name or "visual_graph", **kwargs)

    def ensure(self):
        """Raises ``ImportError`` where ``visual_graph_datasets`` is not
        installed."""
        try:
            from visual_graph_datasets.data import VisualGraphDatasetReader  # noqa: F401
        except ImportError:
            raise ImportError(
                "visual_graph_datasets is not installed; use "
                "gcnn_keras_tpu_torch.xai.testing.VgdMockDataset for development")
        return self

    def read_in_memory(self, **kwargs):
        """The folder's ``*.json`` elements in name order, one graph each."""
        if not self.data_directory or not os.path.isdir(self.data_directory):
            raise FileNotFoundError(f"no dataset folder {self.data_directory}")
        for fname in sorted(os.listdir(self.data_directory)):
            if not fname.endswith(".json"):
                continue
            with open(os.path.join(self.data_directory, fname)) as f:
                element = json.load(f)
            g = element.get("graph", element)
            self.append({
                "node_attributes": np.array(g["node_attributes"], dtype=np.float32),
                "edge_indices": np.array(g["edge_indices"], dtype=np.int64),
                "edge_attributes": np.array(g.get("edge_attributes", []), dtype=np.float32),
                "graph_labels": np.atleast_1d(np.array(
                    element.get("targets", g.get("graph_labels", 0.0)), dtype=np.float32)),
            })
        return self
