"""IO module; counterpart of ``gcnn_keras_tpu/io`` (kgcnn's ``io``)."""
from .loader import GraphBatchLoader
