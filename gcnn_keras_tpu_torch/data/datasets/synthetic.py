"""Synthetic datasets for work without downloads; counterpart of
``gcnn_keras_tpu/data/datasets/synthetic.py``.

Each is a ``MemoryGraphDataset`` with the JAX package's property names and,
from the same seed, the same arrays: QM9-like molecules, an MD17-like
trajectory with exact pair-potential forces, and a Cora-like citation
graph.
"""
from __future__ import annotations

import numpy as np

from ...graph.preprocess import normalize_edge_weights_symmetric, set_edge_weights_uniform
from ..dataset import MemoryGraphDataset


class SyntheticQM9Dataset(MemoryGraphDataset):
    """QM9-like molecules: 4 to ``max_atoms`` atoms of H, C, N, O, F on a
    jittered grid, with an extensive energy (per-element offsets plus pair
    terms) as ``energy`` and ``graph_labels``."""

    def __init__(self, num_molecules: int = 128, seed: int = 42,
                 max_atoms: int = 16, **kwargs):
        super().__init__(dataset_name="SyntheticQM9", **kwargs)
        rs = np.random.RandomState(seed)
        offsets = {1: -0.5, 6: -38.0, 7: -54.5, 8: -75.0, 9: -99.7}
        for _ in range(num_molecules):
            n = rs.randint(4, max_atoms + 1)
            z = rs.choice([1, 6, 7, 8, 9], size=n, p=[0.45, 0.35, 0.08, 0.1, 0.02])
            pos = _packed_positions(rs, n)
            d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            pair_e = np.sum(0.5 * np.exp(-d) * np.sqrt(z[:, None] * z[None, :]))
            energy = sum(offsets[int(a)] for a in z) + float(pair_e)
            self.append({"node_number": z.astype(np.int64),
                         "node_coordinates": pos.astype(np.float32),
                         "graph_labels": np.array([energy], dtype=np.float32),
                         "energy": np.array([energy], dtype=np.float32)})

    def prepare_data(self, **kwargs):
        """Nothing to download or convert: the molecules are made in
        ``__init__``."""
        return self

    def read_in_memory(self, **kwargs):
        """Nothing to read: the molecules are in memory already."""
        return self

    def set_ranges(self, max_distance: float = 4.0, max_neighbours: int = 15):
        return self.map_list("set_range", max_distance=max_distance,
                             max_neighbours=max_neighbours)


class SyntheticMDDataset(MemoryGraphDataset):
    """An MD17-like trajectory of one molecule: ``num_frames`` perturbed
    geometries with the energy and the exact forces of a Morse-like pair
    potential, so an energy+force model can fit them."""

    def __init__(self, num_frames: int = 128, num_atoms: int = 9,
                 seed: int = 7, **kwargs):
        super().__init__(dataset_name="SyntheticMD", **kwargs)
        rs = np.random.RandomState(seed)
        z = rs.choice([1, 6, 8], size=num_atoms)
        base = _packed_positions(rs, num_atoms)
        for _ in range(num_frames):
            pos = base + rs.randn(num_atoms, 3) * 0.1
            e, f = _pair_potential(pos, z)
            self.append({"node_number": z.astype(np.int64),
                         "node_coordinates": pos.astype(np.float32),
                         "energy": np.array([e], dtype=np.float32),
                         "force": f.astype(np.float32)})


class SyntheticCitationDataset(MemoryGraphDataset):
    """One Cora-like graph: ``num_nodes`` nodes with class-correlated
    features (``node_attributes``, float32), their classes (``node_labels``)
    and homophilous undirected edges (``edge_indices``, unique, sorted) with
    uniform, symmetrically normalized ``edge_weights``; a node
    classification task."""

    def __init__(self, num_nodes: int = 500, num_classes: int = 7,
                 feature_dim: int = 64, avg_degree: int = 4, seed: int = 1,
                 **kwargs):
        super().__init__(dataset_name="SyntheticCora", **kwargs)
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


def _packed_positions(rs, n: int) -> np.ndarray:
    """Positions at least about 1 apart: a jittered cubic grid of spacing
    1.6."""
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n]
    return grid * 1.6 + rs.rand(n, 3) * 0.5


def _pair_potential(pos: np.ndarray, z: np.ndarray):
    """The energy of a Morse-like pair potential, weighted by
    ``sqrt(z_i z_j)``, and its exact forces."""
    diff = pos[:, None] - pos[None, :]
    d = np.linalg.norm(diff, axis=-1)
    np.fill_diagonal(d, 1.0)
    w = np.sqrt(np.outer(z, z))
    r0 = 1.5
    a = 1.2
    ex = np.exp(-a * (d - r0))
    e_mat = w * (ex**2 - 2 * ex)
    np.fill_diagonal(e_mat, 0.0)
    energy = 0.5 * float(e_mat.sum())
    de = w * (-2 * a * ex**2 + 2 * a * ex)  # dE/dr_ij
    np.fill_diagonal(de, 0.0)
    unit = diff / d[..., None]
    forces = -(de[..., None] * unit).sum(axis=1)
    return energy, forces
