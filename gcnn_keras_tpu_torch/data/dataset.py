"""In-memory graph list and dataset; counterpart of
``gcnn_keras_tpu/data/dataset.py`` (``MemoryGraphList``,
``MemoryGraphDataset``).

Indexing by an int gives the stored ``GraphDict``; by a slice, a list or
an index array it gives a new ``MemoryGraphList`` of copies of the dicts
(the arrays are shared), so that a split can be relabelled in place, as a
scaler does, without touching the dataset. ``to_batch``/``to_batches``
build the port's ``GraphBatch`` on ``device`` (the CUDA card unless
``device="cpu"``). ``read_in_table_file`` imports pandas when it is
called, as the JAX method does.
"""
from __future__ import annotations

import logging
import os
import pickle
from collections.abc import MutableSequence
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..batch import GraphBatch, batch_graphs, bucket_size
from .graph_dict import GraphDict

logger = logging.getLogger(__name__)


class MemoryGraphList(MutableSequence):
    def __init__(self, graphs: Optional[Sequence[dict]] = None):
        self._list: List[GraphDict] = [GraphDict(g) for g in (graphs or [])]

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return MemoryGraphList(self._list[idx])
        if isinstance(idx, (list, np.ndarray)):
            return MemoryGraphList([self._list[int(i)] for i in np.asarray(idx).reshape(-1)])
        return self._list[idx]

    def __setitem__(self, idx, value):
        self._list[idx] = GraphDict(value)

    def __delitem__(self, idx):
        del self._list[idx]

    def __len__(self):
        return len(self._list)

    def insert(self, idx, value):
        self._list.insert(idx, GraphDict(value))

    def assign_property(self, key: str, values: Sequence) -> "MemoryGraphList":
        """Set ``key`` of each graph to the value of the same position (a
        None leaves that graph as it is)."""
        if len(values) != len(self._list):
            raise ValueError(f"assign_property({key!r}): {len(values)} values for "
                             f"{len(self._list)} graphs")
        for g, v in zip(self._list, values):
            g.assign_property(key, v)
        return self

    def obtain_property(self, key: str) -> List:
        """``key`` of each graph, None where a graph lacks it."""
        return [g.obtain_property(key) for g in self._list]

    def map_list(self, method, **kwargs) -> "MemoryGraphList":
        """Apply a preprocessor (by its registered name or as a callable)
        to every graph, in place."""
        for g in self._list:
            g.apply_preprocessor(method, **kwargs)
        return self

    def clean(self, inputs: Sequence[str]) -> np.ndarray:
        """Drop the graphs that lack any of ``inputs`` (absent, None or
        empty); returns the indices of the graphs kept."""
        keep, removed = [], []
        for i, g in enumerate(self._list):
            ok = all(k in g and g[k] is not None and np.asarray(g[k]).size > 0
                     for k in inputs)
            (keep if ok else removed).append(i)
        if removed:
            logger.warning("clean: removing %d graphs missing %s", len(removed), inputs)
        self._list = [self._list[i] for i in keep]
        return np.array(keep)

    def to_batch(self, **kwargs) -> GraphBatch:
        """All graphs in one ``GraphBatch`` (``batch_graphs``' keywords)."""
        return batch_graphs([dict(g) for g in self._list], **kwargs)

    def to_batches(self, batch_size: int, shuffle: bool = False,
                   seed: int = 0, drop_last: bool = False,
                   bucket: bool = True, **kwargs) -> List[GraphBatch]:
        """Batches of ``batch_size`` graphs (with ``bucket``, one padding
        graph slot each unless ``n_graph_pad`` is given)."""
        idx = np.arange(len(self._list))
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        out = []
        for start in range(0, len(idx), batch_size):
            chunk = idx[start:start + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            bkw = dict(kwargs)
            if bucket and "n_graph_pad" not in bkw:
                bkw["n_graph_pad"] = batch_size + 1
            out.append(batch_graphs([dict(self._list[i]) for i in chunk], **bkw))
        return out

    def batch_shape_hint(self, batch_size: int, edge_index_key: str = "edge_indices",
                         angle_index_key: str = "angle_indices_nodes",
                         headroom: float = 1.1) -> Dict[str, int]:
        """Pads that hold any ``batch_size`` graphs of the list: the largest
        total of nodes, edges and angles over ``batch_size`` graphs, with
        ``headroom``, rounded up to a bucket; one shape for every batch."""
        nn = np.array([int(np.asarray(g[edge_index_key]).shape[0]) for g in self._list])
        nv = np.array([g._num_nodes(edge_index_key) for g in self._list])
        na = np.array([int(np.asarray(g.get(angle_index_key, np.zeros((0, 3)))).shape[0])
                       for g in self._list])

        def worst(a):
            return int(np.sort(a)[::-1][:batch_size].sum() * headroom) + 1

        hint = {"n_node_pad": bucket_size(worst(nv) + 1),
                "n_edge_pad": bucket_size(worst(nn)),
                "n_graph_pad": batch_size + 1}
        if na.sum() > 0:
            hint["n_angle_pad"] = bucket_size(worst(na))
        return hint


class MemoryGraphDataset(MemoryGraphList):
    """A ``MemoryGraphList`` with a location on disk, pickle
    ``save``/``load`` and a table of labels."""

    def __init__(self, data_directory: Optional[str] = None,
                 dataset_name: Optional[str] = None,
                 file_name: Optional[str] = None,
                 file_directory: Optional[str] = None,
                 graphs: Optional[Sequence[dict]] = None, **kwargs):
        super().__init__(graphs)
        self.data_directory = data_directory
        self.dataset_name = dataset_name
        self.file_name = file_name
        self.file_directory = file_directory

    @property
    def file_path(self) -> Optional[str]:
        if self.data_directory and self.file_name:
            return os.path.join(self.data_directory, self.file_name)
        return None

    def _pickle_path(self, filepath: Optional[str]) -> str:
        return filepath or (self.file_path and self.file_path + ".pickle") or \
            f"{self.dataset_name or 'dataset'}.pickle"

    def save(self, filepath: Optional[str] = None) -> "MemoryGraphDataset":
        """Pickle the graphs as plain dicts (the JAX package's file)."""
        path = self._pickle_path(filepath)
        with open(path, "wb") as f:
            pickle.dump([dict(g) for g in self._list], f)
        logger.info("saved %d graphs to %s", len(self), path)
        return self

    def load(self, filepath: Optional[str] = None) -> "MemoryGraphDataset":
        """Read a pickle that ``save`` (here or in the JAX package) wrote;
        unpickling runs code, so load only files of this program."""
        path = self._pickle_path(filepath)
        with open(path, "rb") as f:
            self._list = [GraphDict(g) for g in pickle.load(f)]
        logger.info("loaded %d graphs from %s", len(self), path)
        return self

    def read_in_table_file(self, file_path: Optional[str] = None, **kwargs):
        """Read a CSV table (``file_path``, else ``file_path`` of the
        dataset) into ``data_frame`` with ``pandas.read_csv(**kwargs)``."""
        import pandas as pd
        self.data_frame = pd.read_csv(file_path or self.file_path, **kwargs)
        return self

    def assert_valid_model_input(self, inputs: Sequence[str]):
        """Raise ``ValueError`` naming the ``inputs`` that some graph
        lacks."""
        missing = {k for g in self._list for k in inputs if k not in g}
        if missing:
            raise ValueError(f"dataset missing model inputs: {sorted(missing)}")
