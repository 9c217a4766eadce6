"""Explanation interfaces; counterpart of ``gcnn_keras_tpu/xai/base.py``
(kgcnn's ``xai/base.py``)."""
from __future__ import annotations

from typing import Any, Tuple


class ExplanationMixin:
    """For models that give their own node and edge importances (MEGAN):
    ``explain(batch)`` returns ``(node_importances, edge_importances)`` of
    the model's output."""

    def explain(self, batch, **kwargs) -> Tuple[Any, Any]:
        out = self(batch, **kwargs)
        return out.get("node_importances"), out.get("edge_importances")


class ImportanceExplanationMethod:
    """A post-hoc explanation method: ``__call__(model, batch)`` returns
    ``(node_importances, edge_importances)``, ``model`` a callable from a
    batch to the model's output dict."""

    def __call__(self, model, batch, **kwargs):
        raise NotImplementedError
