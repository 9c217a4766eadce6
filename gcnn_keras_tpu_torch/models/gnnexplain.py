"""The GNNExplainer entry point; counterpart of
``gcnn_keras_tpu/models/gnnexplain.py`` (kgcnn's ``literature/GNNExplain``).
The implementation is ``xai/gnn_explainer.py``."""
from ..utils.devices import DeviceLike
from ..xai.gnn_explainer import GNNExplainer


def make_model(device: DeviceLike = None, **kwargs) -> GNNExplainer:
    """A ``GNNExplainer``; ``device`` (None: the batch's) is where its
    explanations run."""
    return GNNExplainer(device=device, **kwargs)
