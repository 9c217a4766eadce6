"""GNNExplainer; counterpart of ``gcnn_keras_tpu/xai/gnn_explainer.py``
(kgcnn's ``GNNExplainerOptimizer``).

A post-hoc explanation that optimises soft masks so that the model keeps
its prediction while the masks' norms are penalised:
- three masks, as the reference's: an edge mask (E,), one feature mask
  (F,) shared by every node, and a node mask (N,), each with its own loss
  weight and p-norm order (the node mask's weight 0 by default, so it is
  not optimised);
- the masks' logits start at 5.0 (sigmoid 0.993: keep everything);
- ``output_to_explain`` explains a chosen target (one class's logit, say)
  in place of the model's own output.

``model`` is a callable from a ``GraphBatch`` to the model's output dict.
The masks live on the batch's device and are trained by optax's Adam rule
(``training/optimizers.py``) for ``epochs`` steps; the losses stay on the
device and are stacked at the end (the JAX package ``lax.scan``s the
steps).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..training.optimizers import adam
from ..utils.devices import DeviceLike
from .base import ImportanceExplanationMethod

Tensor = torch.Tensor


def _pnorm(x: Tensor, ord_: float) -> Tensor:
    return torch.sum(torch.abs(x) ** ord_) ** (1.0 / ord_)


def _bcast(v: Tensor, ndim: int) -> Tensor:
    """``v`` (n,) shaped to broadcast over a tensor of ``ndim`` dimensions."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


class GNNExplainer(ImportanceExplanationMethod):
    """``device``, where given, is where the explanation runs: the batch is
    moved there; by default the masks live on the batch's device."""

    def __init__(self, learning_rate: float = 0.01, epochs: int = 100,
                 edge_mask_loss_weight: float = 1e-4,
                 edge_mask_norm_ord: float = 1.0,
                 feature_mask_loss_weight: float = 1e-4,
                 feature_mask_norm_ord: float = 1.0,
                 node_mask_loss_weight: float = 0.0,
                 node_mask_norm_ord: float = 1.0,
                 node_feature_key: str = "node_attributes",
                 output_key: str = "output",
                 device: DeviceLike = None):
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.edge_mask_loss_weight = edge_mask_loss_weight
        self.edge_mask_norm_ord = edge_mask_norm_ord
        self.feature_mask_loss_weight = feature_mask_loss_weight
        self.feature_mask_norm_ord = feature_mask_norm_ord
        self.node_mask_loss_weight = node_mask_loss_weight
        self.node_mask_norm_ord = node_mask_norm_ord
        self.node_feature_key = node_feature_key
        self.output_key = output_key
        self.device = None if device is None else torch.device(device)

    def _feature_key(self, batch) -> Optional[str]:
        if self.node_feature_key in batch.nodes:
            return self.node_feature_key
        return "node_number" if "node_number" in batch.nodes else None

    def loss(self, model: Callable, batch, masks: Dict[str, Tensor], target: Tensor) -> Tensor:
        """The squared distance from ``target`` of the model's output on the
        masked batch, plus the masks' p-norm penalties (the edge and node
        masks restricted to real edges and nodes). The masked batch has its
        floating edge arrays scaled by the edge mask (SchNet's distances
        among them, as in the JAX package), its floating node features by the
        feature mask and, where the node mask is optimised, by the node
        mask."""
        em, fm, nm = (torch.sigmoid(masks[k]) for k in ("edge", "feature", "node"))
        key = self._feature_key(batch)
        feats = batch.nodes[key]
        nodes = dict(batch.nodes)
        if feats.is_floating_point():
            scaled = feats * (fm[None, :] if feats.ndim > 1 else fm).to(feats.dtype)
            if self.node_mask_loss_weight > 0:
                scaled = scaled * _bcast(nm, scaled.ndim).to(scaled.dtype)
            nodes[key] = scaled
        edges = {k: v * _bcast(em, v.ndim).to(v.dtype) if v.is_floating_point() else v
                 for k, v in batch.edges.items()}
        out = model(batch.replace(nodes=nodes, edges=edges))[self.output_key]
        loss = torch.sum((out - target) ** 2)
        if self.edge_mask_loss_weight > 0:
            em_v = em * batch.edge_mask.to(em.dtype)
            loss = loss + self.edge_mask_loss_weight * _pnorm(em_v, self.edge_mask_norm_ord)
        if self.feature_mask_loss_weight > 0:
            loss = loss + self.feature_mask_loss_weight * _pnorm(fm, self.feature_mask_norm_ord)
        if self.node_mask_loss_weight > 0:
            nm_v = nm * batch.node_mask.to(nm.dtype)
            loss = loss + self.node_mask_loss_weight * _pnorm(nm_v, self.node_mask_norm_ord)
        return loss

    def initial_masks(self, batch) -> Dict[str, Tensor]:
        """The mask logits at 5.0, on the batch's device in the default float
        dtype (the JAX masks take JAX's): ``edge`` (E,), ``feature`` (F,),
        ``node`` (N,)."""
        feats = batch.nodes[self._feature_key(batch)]
        feat_dim = feats.shape[-1] if feats.ndim > 1 else 1
        return {k: torch.full((n,), 5.0, dtype=torch.get_default_dtype(),
                              device=batch.node_mask.device, requires_grad=True)
                for k, n in (("edge", batch.n_edge), ("feature", feat_dim),
                             ("node", batch.n_node))}

    def explain(self, model: Callable, batch, output_to_explain: Optional[Tensor] = None,
                **kwargs) -> Dict[str, Tensor]:
        """The explanation: ``edge_mask`` (E,), ``feature_mask`` (F,),
        ``node_mask`` (N,) and the loss of each epoch, ``losses``
        (epochs,)."""
        if self.device is not None:
            batch = batch.to(self.device)
        dev = batch.node_mask.device
        if output_to_explain is None:
            with torch.no_grad():
                target = model(batch)[self.output_key]
        else:
            target = torch.as_tensor(output_to_explain, device=dev)
        masks = self.initial_masks(batch)
        dtype = masks["edge"].dtype
        params = list(masks.values())
        opt = adam(self.learning_rate)(params)
        losses = []
        for _ in range(self.epochs):
            loss = self.loss(model, batch, masks, target)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            for p, g in zip(params, grads):
                p.grad = g  # None (an unused mask) steps as a zero gradient
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            return {
                "edge_mask": torch.sigmoid(masks["edge"]) * batch.edge_mask.to(dtype),
                "feature_mask": torch.sigmoid(masks["feature"]),
                "node_mask": torch.sigmoid(masks["node"]) * batch.node_mask.to(dtype),
                "losses": torch.stack(losses) if losses else torch.zeros(0, device=dev),
            }

    def __call__(self, model: Callable, batch, output_to_explain: Optional[Tensor] = None,
                 **kwargs) -> Tuple[Tensor, Tensor]:
        """``(node_importances (N,), edge_importances (E,))``: the node mask
        where it is optimised, else the feature-mask-weighted feature
        magnitudes (the reference's default presentation), else the feature
        mask's mean on every real node."""
        if self.device is not None:
            batch = batch.to(self.device)
        ex = self.explain(model, batch, output_to_explain=output_to_explain, **kwargs)
        feats = batch.nodes[self._feature_key(batch)]
        node_mask = batch.node_mask.to(ex["feature_mask"].dtype)
        if self.node_mask_loss_weight > 0:
            node_imp = ex["node_mask"]
        elif feats.ndim > 1 and feats.is_floating_point():
            weighted = torch.abs(feats) * ex["feature_mask"][None, :].to(feats.dtype)
            node_imp = weighted.mean(dim=-1) * node_mask
        else:
            node_imp = ex["feature_mask"].mean().expand(batch.n_node) * node_mask
        return node_imp, ex["edge_mask"]
