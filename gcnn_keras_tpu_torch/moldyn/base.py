"""MD inference pipeline; counterpart of ``gcnn_keras_tpu/moldyn/base.py``
(``MolDynamicsModelPredictor``, ``ExtensiveEnergyForceScalerPostprocessor``):
graph preprocessors -> bucketed batch -> energy+force forward -> per-graph
outputs -> postprocessors.

Pads are bucketed as in the JAX package, so the batch shapes of successive
MD steps repeat.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import GraphBatch, batch_graphs, bucket_size
from ..utils.devices import DeviceLike, resolve_device


class MolDynamicsModelPredictor:
    """Serves per-graph ``energy`` and ``force`` for a list of graph dicts.

    ``model`` is called on a GraphBatch (an ``EnergyForceModel``); its
    weights live in the model. The batch is built on ``device`` (the CUDA
    card unless ``device="cpu"``).
    """

    def __init__(self, model,
                 graph_preprocessors: Sequence[Callable] = (),
                 graph_postprocessors: Sequence[Callable] = (),
                 batch_kwargs: Optional[Dict] = None,
                 output_translation: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.graph_preprocessors = list(graph_preprocessors)
        self.graph_postprocessors = list(graph_postprocessors)
        self.batch_kwargs = batch_kwargs or {}
        self.output_translation = output_translation or {
            "energy": "energy", "force": "force", "charge": "charge"}

    def make_batch(self, graph_list: List[dict]) -> Tuple[List[dict], GraphBatch]:
        """Preprocess the graphs and bucket them into one batch on the
        predictor's device. Returns ``(graphs, batch)``."""
        graphs = [dict(g) for g in graph_list]
        for pre in self.graph_preprocessors:
            graphs = [dict(g, **pre(g)) for g in graphs]

        kw = dict(self.batch_kwargs)
        tot_n = sum(len(g["node_number"]) for g in graphs)
        tot_e = sum(len(g.get("range_indices", g.get("edge_indices"))) for g in graphs)
        kw.setdefault("n_node_pad", bucket_size(tot_n + 1))
        kw.setdefault("n_edge_pad", bucket_size(max(tot_e, 1)))
        for g in graphs:
            if "edge_indices" not in g and "range_indices" in g:
                g["edge_indices"] = g["range_indices"]
        batch = batch_graphs(graphs, global_keys=("total_charge",),
                             device=self.device, **kw)
        return graphs, batch

    def __call__(self, graph_list: List[dict]) -> List[dict]:
        graphs, batch = self.make_batch(graph_list)
        out = self.model(batch)
        return self.split(graphs, batch, out)

    def split(self, graphs: List[dict], batch: GraphBatch,
              out: Dict[str, torch.Tensor]) -> List[dict]:
        """Per-graph numpy results from the batched outputs."""
        node_mask = batch.node_mask.cpu().numpy()
        gid = batch.graph_id.cpu().numpy()
        host = {}
        for out_name, key in self.output_translation.items():
            val = out.get(out_name, out.get(key))
            if val is not None:
                host[out_name] = val.detach().cpu().numpy()
        # real nodes of graph i are contiguous and in graph order
        starts = np.searchsorted(gid, np.arange(len(graphs) + 1))
        results = []
        for i, g in enumerate(graphs):
            res = {}
            lo, hi = starts[i], starts[i + 1]
            for out_name, val in host.items():
                if val.shape[0] == batch.n_graphs:
                    res[out_name] = val[i]
                elif val.shape[0] == batch.n_node:
                    res[out_name] = val[lo:hi][node_mask[lo:hi]]
            for post in self.graph_postprocessors:
                res = dict(res, **post(res, g))
            results.append(res)
        return results


class ExtensiveEnergyForceScalerPostprocessor:
    """A graph postprocessor that undoes the label scaling of a model
    trained on scaled labels: the energy through the scaler's
    ``inverse_transform`` on the graph's atomic numbers, the forces times
    its scale (``scaler`` an ``EnergyForceExtensiveLabelScaler``, fitted)."""

    def __init__(self, scaler, energy: str = "energy", force: str = "force",
                 atomic_number: str = "node_number"):
        self.scaler = scaler
        self.energy = energy
        self.force = force
        self.atomic_number = atomic_number

    def __call__(self, result: dict, graph: dict) -> dict:
        out = dict(result)
        z = [np.asarray(graph[self.atomic_number])]
        if self.energy in result:
            e = np.atleast_1d(np.asarray(result[self.energy]).reshape(-1)[0])
            out[self.energy] = self.scaler.inverse_transform(e, z)
        if self.force in result:
            out[self.force] = np.asarray(result[self.force]) * self.scaler.scale_[0]
        return out
