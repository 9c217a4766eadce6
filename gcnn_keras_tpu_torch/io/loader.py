"""The batch loader where kgcnn keeps it (``kgcnn/io/loader.py``);
counterpart of ``gcnn_keras_tpu/io/loader.py``. It lives in
``gcnn_keras_tpu_torch.data.loader``."""
from ..data.loader import GraphBatchLoader  # noqa: F401
