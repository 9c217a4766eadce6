"""TUDataset graph collections; counterpart of
``gcnn_keras_tpu/data/datasets/tudataset.py`` (kgcnn's ``GraphTUDataset``
and its MUTAG, Mutagenicity and PROTEINS)."""
from __future__ import annotations

import os

import numpy as np

from ..dataset import MemoryGraphDataset
from ..download import DownloadDataset


class GraphTUDataset2020(MemoryGraphDataset):
    """A reader of the TUDataset 2020 text format: ``{name}_A.txt``,
    ``{name}_graph_indicator.txt``, ``{name}_graph_labels.txt`` and, where
    present, the node and edge labels and attributes. Each graph's edges
    are ``[receiver, sender]`` rows of its own node numbers; its node labels
    are ``node_number`` (zeros without them); the graph labels are kept as
    they are (MUTAG's are 1 and -1)."""

    _url_base = "https://www.chrsmrrs.com/graphkerneldatasets/"

    def __init__(self, dataset_name: str = "MUTAG", reload: bool = False, **kwargs):
        dl = DownloadDataset(dataset_name,
                             download_url=self._url_base + f"{dataset_name}.zip",
                             download_file_name=f"{dataset_name}.zip",
                             unpack_zip=True, reload=reload)
        super().__init__(data_directory=dl.data_directory,
                         dataset_name=dataset_name, **kwargs)

    def read_in_memory(self, **kwargs):
        name = self.dataset_name
        base = os.path.join(self.data_directory, name)
        if not os.path.isdir(base):
            base = self.data_directory

        def load(stem, dtype=np.int64, required=False):
            path = os.path.join(base, f"{name}_{stem}.txt")
            if not os.path.exists(path):
                if required:
                    raise FileNotFoundError(f"{path} missing (offline?)")
                return None
            return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=1)

        A = load("A", required=True)
        if A.ndim == 1:
            A = A.reshape(-1, 2)
        indicator = load("graph_indicator", required=True)
        graph_labels = load("graph_labels")
        node_labels = load("node_labels")
        node_attrs = load("node_attributes", dtype=np.float64)
        edge_labels = load("edge_labels")
        edge_attrs = load("edge_attributes", dtype=np.float64)

        n_graphs = int(indicator.max())
        # nodes are numbered from 1, each graph's contiguously
        node_offsets = np.zeros(n_graphs + 1, dtype=np.int64)
        for g in range(1, n_graphs + 1):
            node_offsets[g] = np.searchsorted(indicator, g + 1)
        for g in range(n_graphs):
            lo, hi = node_offsets[g], node_offsets[g + 1]
            mask = (A[:, 0] > lo) & (A[:, 0] <= hi)
            ei = A[mask] - 1 - lo  # the graph's own node numbers from 0
            gd = {"edge_indices": ei[:, ::-1].copy()}  # (receiver, sender)
            gd["node_number"] = (node_labels[lo:hi] if node_labels is not None
                                 else np.zeros(hi - lo, dtype=np.int64))
            if node_attrs is not None:
                na = node_attrs[lo:hi]
                gd["node_attributes"] = np.atleast_2d(na).reshape(hi - lo, -1).astype(np.float32)
            if edge_labels is not None:
                gd["edge_labels"] = edge_labels[mask]
            if edge_attrs is not None:
                ea = edge_attrs[mask]
                gd["edge_attributes"] = np.atleast_2d(ea).reshape(int(mask.sum()), -1).astype(
                    np.float32)
            if graph_labels is not None:
                gd["graph_labels"] = np.array([graph_labels[g]], dtype=np.float32)
            self.append(gd)
        return self


class MUTAGDataset(GraphTUDataset2020):
    def __init__(self, reload: bool = False, **kwargs):
        super().__init__(dataset_name="MUTAG", reload=reload, **kwargs)


class MutagenicityDataset(GraphTUDataset2020):
    def __init__(self, reload: bool = False, **kwargs):
        super().__init__(dataset_name="Mutagenicity", reload=reload, **kwargs)


class PROTEINSDataset(GraphTUDataset2020):
    def __init__(self, reload: bool = False, **kwargs):
        super().__init__(dataset_name="PROTEINS", reload=reload, **kwargs)
