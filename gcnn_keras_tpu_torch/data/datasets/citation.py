"""The Cora citation graphs; counterpart of
``gcnn_keras_tpu/data/datasets/citation.py`` (kgcnn's ``CoraDataset`` and
``CoraLuDataset``): one graph, its nodes to classify."""
from __future__ import annotations

import os

import numpy as np

from ..dataset import MemoryGraphDataset
from ..download import DownloadDataset
from ...graph.preprocess import (make_undirected_edges, normalize_edge_weights_symmetric,
                                 set_edge_weights_uniform)


def _citation_graph(g: dict) -> dict:
    """Both directions of every link, uniform weights normalized
    symmetrically."""
    return normalize_edge_weights_symmetric(set_edge_weights_uniform(make_undirected_edges(g)))


class CoraDataset(MemoryGraphDataset):
    """The full Cora of graph2gauss (19793 nodes, 8710 binary features, 70
    classes), read from its ``cora.npz`` of scipy CSR triplets."""

    _url = "https://github.com/abojchevski/graph2gauss/raw/master/data/cora.npz"

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset("Cora", download_url=self._url,
                             download_file_name="cora.npz", reload=reload)
        super().__init__(data_directory=dl.data_directory, dataset_name="Cora", **kwargs)

    def read_in_memory(self, **kwargs):
        path = os.path.join(self.data_directory, "cora.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} missing (offline? SyntheticCitationDataset "
                                    "needs no file)")
        import scipy.sparse as sp
        loader = np.load(path, allow_pickle=True)
        adj = sp.csr_matrix((loader["adj_data"], loader["adj_indices"],
                             loader["adj_indptr"]), shape=loader["adj_shape"])
        attr = sp.csr_matrix((loader["attr_data"], loader["attr_indices"],
                              loader["attr_indptr"]), shape=loader["attr_shape"])
        labels = loader["labels"]
        coo = adj.tocoo()
        self.append(_citation_graph({
            "node_attributes": np.asarray(attr.todense(), dtype=np.float32),
            "node_labels": labels.astype(np.int64),
            "edge_indices": np.stack([coo.row, coo.col], axis=1).astype(np.int64),
        }))
        return self


class CoraLuDataset(CoraDataset):
    """The Cora of Lu & Getoor (2708 nodes, 1433 features, 7 classes), read
    from ``cora/cora.content`` and ``cora/cora.cites``."""

    _url = "https://linqs-data.soe.ucsc.edu/public/lbc/cora.tgz"

    def __init__(self, reload: bool = False, **kwargs):
        dl = DownloadDataset("CoraLu", download_url=self._url,
                             download_file_name="cora.tgz", unpack_tar=True, reload=reload)
        MemoryGraphDataset.__init__(self, data_directory=dl.data_directory,
                                    dataset_name="CoraLu", **kwargs)

    def read_in_memory(self, **kwargs):
        content = os.path.join(self.data_directory, "cora", "cora.content")
        cites = os.path.join(self.data_directory, "cora", "cora.cites")
        if not os.path.exists(content):
            raise FileNotFoundError(f"{content} missing (offline? SyntheticCitationDataset "
                                    "needs no file)")
        with open(content) as f:
            rows = [line.split() for line in f]
        ids = {r[0]: i for i, r in enumerate(rows)}
        feats = np.array([[float(v) for v in r[1:-1]] for r in rows], dtype=np.float32)
        cls = {c: i for i, c in enumerate(sorted({r[-1] for r in rows}))}
        labels = np.array([cls[r[-1]] for r in rows], dtype=np.int64)
        edges = []
        with open(cites) as f:
            for line in f:
                a, b = line.split()
                if a in ids and b in ids:
                    edges.append([ids[a], ids[b]])
        self.append(_citation_graph({"node_attributes": feats, "node_labels": labels,
                                     "edge_indices": np.array(edges, dtype=np.int64)}))
        return self
