"""Explanation tooling; counterpart of ``gcnn_keras_tpu/xai``: the
interfaces (``base.py``), ``GNNExplainer`` and the test doubles of
``testing.py`` (``MockImportanceModel``, ``VgdMockDataset``)."""
from .base import ExplanationMixin, ImportanceExplanationMethod
from .gnn_explainer import GNNExplainer
from .testing import MockImportanceModel, VgdMockDataset
