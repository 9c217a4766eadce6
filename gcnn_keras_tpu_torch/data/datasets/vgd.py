"""Visual-graph XAI datasets; counterpart of
``gcnn_keras_tpu/data/datasets/vgd.py`` (kgcnn's ``VgdMockDataset`` and
``VgdRbMotifsDataset``): graphs with ground-truth node importance masks
for testing explanation methods. kgcnn reads the real datasets through the
``visual_graph_datasets`` package; these are made from a seed, the same
draws as the JAX package's."""
from __future__ import annotations

import numpy as np

from ..dataset import MemoryGraphDataset
from ...xai.testing import VgdMockDataset  # noqa: F401  (re-export)


class VgdRbMotifsDataset(MemoryGraphDataset):
    """Red-blue motif graphs: random base graphs with planted "red" star
    motifs contributing +1 and "blue" motifs contributing -1 to the graph
    label; the motif membership masks are the ground-truth explanations."""

    def __init__(self, num_graphs: int = 64, seed: int = 0, **kwargs):
        super().__init__(dataset_name="VgdRbMotifs", **kwargs)
        rs = np.random.RandomState(seed)
        for _ in range(num_graphs):
            n_base = rs.randint(6, 12)
            colors = rs.rand(n_base, 3).astype(np.float32) * 0.2 + 0.4
            edges = set()
            for i in range(1, n_base):
                j = rs.randint(i)
                edges.add((i, j)); edges.add((j, i))
            for _ in range(n_base // 2):
                i, j = rs.randint(n_base), rs.randint(n_base)
                if i != j:
                    edges.add((i, j)); edges.add((j, i))
            nodes = [colors]
            importances = [np.zeros(n_base, dtype=np.float32)]
            label = 0.0
            n = n_base
            for _ in range(rs.randint(0, 3)):
                red = rs.rand() > 0.5
                size = 4  # star motif: hub + 3 leaves
                c = np.zeros((size, 3), dtype=np.float32)
                c[:, 0 if red else 2] = 1.0
                nodes.append(c)
                importances.append(np.ones(size, dtype=np.float32))
                hub = n
                for leaf in range(n + 1, n + size):
                    edges.add((hub, leaf)); edges.add((leaf, hub))
                attach = rs.randint(n_base)
                edges.add((hub, attach)); edges.add((attach, hub))
                label += 1.0 if red else -1.0
                n += size
            ei = np.array(sorted(edges), dtype=np.int64)
            self.append({
                "node_attributes": np.concatenate(nodes, axis=0),
                "edge_indices": ei,
                "node_importances_true": np.concatenate(importances),
                "graph_labels": np.array([label], dtype=np.float32),
            })
