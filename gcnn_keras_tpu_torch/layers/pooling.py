"""The kgcnn pooling names over the flat-batch functions of
``layers/aggr.py``; counterpart of ``gcnn_keras_tpu/layers/pooling.py``.
Each name builds a function of ``(batch, values[, ...])``. A sum onto the
nodes or the graphs is the sorted segment-sum kernel; onto the graphs from
the edges it is unsorted (``index_add_``), as in the JAX package."""
from __future__ import annotations

from .aggr import (pool_edges_to_graph, pool_edges_to_nodes, pool_edges_to_nodes_attention,
                   pool_nodes_to_graph, pool_nodes_to_graph_attention,
                   pool_weighted_edges_to_nodes, relational_pool_edges_to_nodes)


def PoolingLocalEdges(pooling_method: str = "sum"):
    def call(batch, edge_values):
        return pool_edges_to_nodes(batch, edge_values, mode=_norm(pooling_method))
    return call


PoolingLocalMessages = PoolingLocalEdges


def PoolingWeightedLocalEdges(pooling_method: str = "sum",
                              normalize_by_weights: bool = False):
    def call(batch, edge_values, weights):
        return pool_weighted_edges_to_nodes(batch, edge_values, weights,
                                            mode=_norm(pooling_method),
                                            normalize=normalize_by_weights)
    return call


def PoolingLocalEdgesAttention():
    def call(batch, edge_values, attention_logits):
        return pool_edges_to_nodes_attention(batch, edge_values, attention_logits)
    return call


def RelationalPoolingLocalEdges(num_relations: int, pooling_method: str = "sum"):
    def call(batch, edge_values, edge_relations):
        return relational_pool_edges_to_nodes(batch, edge_values, edge_relations,
                                              num_relations, mode=_norm(pooling_method))
    return call


def PoolingNodes(pooling_method: str = "sum"):
    def call(batch, node_values):
        return pool_nodes_to_graph(batch, node_values, mode=_norm(pooling_method))
    return call


PoolingEmbedding = PoolingNodes


def PoolingEmbeddingAttention():
    def call(batch, node_values, attention_logits):
        return pool_nodes_to_graph_attention(batch, node_values, attention_logits)
    return call


PoolingNodesAttention = PoolingEmbeddingAttention


def PoolingGlobalEdges(pooling_method: str = "sum"):
    def call(batch, edge_values):
        return pool_edges_to_graph(batch, edge_values, mode=_norm(pooling_method))
    return call


def _norm(name: str) -> str:
    """kgcnn's ``segment_sum`` etc. as the reduction's name."""
    return name.replace("segment_", "")
