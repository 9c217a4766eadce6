"""Synthetic datasets for work without downloads; counterpart of
``gcnn_keras_tpu/data/datasets/synthetic.py`` (``SyntheticCitationDataset``
so far).

The JAX package's datasets are ``MemoryGraphDataset``s, which are not
ported yet; a dataset here is a list of graph dicts, with the same arrays
as the JAX package's from the same seed.
"""
from __future__ import annotations

import numpy as np

from ...graph.preprocess import normalize_edge_weights_symmetric, set_edge_weights_uniform


class SyntheticCitationDataset(list):
    """One Cora-like graph: ``num_nodes`` nodes with class-correlated
    features (``node_attributes``, float32), their classes (``node_labels``)
    and homophilous undirected edges (``edge_indices``, unique, sorted) with
    uniform, symmetrically normalized ``edge_weights``; a node
    classification task."""

    def __init__(self, num_nodes: int = 500, num_classes: int = 7,
                 feature_dim: int = 64, avg_degree: int = 4, seed: int = 1):
        super().__init__()
        rs = np.random.RandomState(seed)
        labels = rs.randint(0, num_classes, size=num_nodes)
        centers = rs.randn(num_classes, feature_dim) * 2.0
        feats = centers[labels] + rs.randn(num_nodes, feature_dim)
        edges = []
        for i in range(num_nodes):
            same = np.nonzero(labels == labels[i])[0]
            other = np.nonzero(labels != labels[i])[0]
            for _ in range(avg_degree):
                # a neighbour of the same class 4 times in 5
                j = rs.choice(same) if rs.rand() < 0.8 else rs.choice(other)
                if j != i:
                    edges.append([i, j])
                    edges.append([j, i])
        g = {"node_attributes": feats.astype(np.float32),
             "node_labels": labels.astype(np.int64),
             "edge_indices": np.unique(np.array(edges, dtype=np.int64), axis=0)}
        self.append(normalize_edge_weights_symmetric(set_edge_weights_uniform(g)))
