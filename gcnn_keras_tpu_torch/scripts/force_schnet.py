"""SchNet energy+force training; counterpart of the root ``force_schnet.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_schnet [--device cpu] [--epochs N]
"""
from gcnn_keras_tpu_torch.training.force_script import (
    DEFAULTS, parse_config_cli, run_force_training)

CONFIG = dict(DEFAULTS, model_prefix="model_schnet_force",
              schnet={"depth": 4, "units": 128, "gauss_bins": 25,
                      "gauss_distance": 5.0})


def build_model(cfg, device=None, generator=None):
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.schnet import make_model
    s = cfg["schnet"]
    model = make_model(
        device=device, generator=generator,
        depth=s["depth"], interaction_args={"units": s["units"]},
        gauss_args={"bins": s["gauss_bins"], "distance_max": s["gauss_distance"]},
        last_mlp={"units": [s["units"], s["units"] // 2],
                  "activation": ["shifted_softplus", "shifted_softplus"]},
        output_mlp={"units": [s["units"] // 2, 1],
                    "activation": ["shifted_softplus", "linear"]})
    return EnergyForceModel(model, device=device)


if __name__ == "__main__":
    run_force_training(build_model, parse_config_cli(CONFIG))
