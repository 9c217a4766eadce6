"""One graph as a dict of named numpy arrays; counterpart of
``gcnn_keras_tpu/data/graph_dict.py`` (``GraphDict``).

A dict subclass: keys are property names (``node_number``,
``node_coordinates``, ``edge_indices``, ``range_indices``,
``angle_indices_nodes``, ``energy``, ``force``, ``esp``, ...), values
numpy arrays. ``to_networkx`` imports networkx when it is called, as the
JAX method does.
"""
from __future__ import annotations

import re
from typing import List, Union

import numpy as np


class GraphDict(dict):
    def assign_property(self, key: str, value) -> "GraphDict":
        if value is not None:
            self[key] = np.asarray(value)
        return self

    def obtain_property(self, key: str):
        return self.get(key, None)

    def search_properties(self, keys: Union[str, List[str]]) -> List[str]:
        """The names that start with ``keys`` or match it as a regex."""
        if isinstance(keys, str):
            pattern = re.compile(keys)
            return sorted(k for k in self.keys()
                          if k.startswith(keys) or pattern.fullmatch(k))
        out = []
        for k in keys:
            out.extend(self.search_properties(k))
        return sorted(set(out))

    def apply_preprocessor(self, name_or_fn, **kwargs) -> "GraphDict":
        """Apply a preprocessor, by its registered name or as a callable on
        a graph dict, in place."""
        from ..graph.preprocess import get_preprocessor
        fn = get_preprocessor(name_or_fn, **kwargs) if isinstance(name_or_fn, str) \
            else name_or_fn
        self.update(fn(dict(self)))
        return self

    def to_networkx(self, edge_indices: str = "edge_indices"):
        """A networkx ``DiGraph``: a node per graph node with its ``node_*``
        values as attributes, an edge ``sender -> receiver`` per row
        ``[receiver, sender]`` of ``edge_indices``."""
        import networkx as nx
        g = nx.DiGraph()
        n = self._num_nodes(edge_indices)
        for i in range(n):
            attrs = {k: np.asarray(v)[i] for k, v in self.items()
                     if k.startswith("node_") and np.asarray(v).shape[:1] == (n,)}
            g.add_node(i, **attrs)
        for r, s in np.asarray(self.get(edge_indices, np.zeros((0, 2)))):
            g.add_edge(int(s), int(r))
        return g

    def _num_nodes(self, edge_indices: str = "edge_indices") -> int:
        for key in ("node_number", "node_coordinates", "node_attributes"):
            if key in self:
                return int(np.asarray(self[key]).shape[0])
        ei = np.asarray(self.get(edge_indices, np.zeros((0, 2))))
        return int(ei.max()) + 1 if ei.size else 0
