"""Explanation tooling; counterpart of ``gcnn_keras_tpu/xai``. Ported so far:
the test doubles of ``testing.py`` (``MockImportanceModel``,
``VgdMockDataset``). ``ExplanationMixin``, ``ImportanceExplanationMethod``
and ``GNNExplainer`` (``xai/base.py``, ``xai/gnn_explainer.py``) wait for
the rest of the zoo (ROADMAP.md)."""
from .testing import MockImportanceModel, VgdMockDataset
