"""GATv2 under its own module name; counterpart of
``gcnn_keras_tpu/models/gatv2.py``, so that the registry's ``"GATv2"``
(``make_model``) builds the v2 heads of ``models/gat.py``."""
from .gat import GATModel, make_model_v2 as make_model, model_default  # noqa: F401
