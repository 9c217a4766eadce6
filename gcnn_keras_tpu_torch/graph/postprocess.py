"""Graph postprocessors; counterpart of ``gcnn_keras_tpu/graph/postprocess.py``.
The scaler-inverse postprocessor lives with the MD pipeline."""
from ..moldyn.base import ExtensiveEnergyForceScalerPostprocessor  # noqa: F401
