"""PAiNN energy+force training; counterpart of the root ``force_painn.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_painn [--device cpu] [--epochs N]
"""
from gcnn_keras_tpu_torch.training.force_script import (
    DEFAULTS, parse_config_cli, run_force_training)

CONFIG = dict(DEFAULTS, model_prefix="model_painn_force",
              painn={"depth": 3, "units": 128, "num_radial": 20, "cutoff": 5.0})


def build_model(cfg, device=None, generator=None):
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.painn import make_model
    p = cfg["painn"]
    model = make_model(
        device=device, generator=generator,
        depth=p["depth"], conv_args={"units": p["units"], "cutoff": p["cutoff"]},
        update_args={"units": p["units"]},
        input_embedding={"node": {"output_dim": p["units"]}},
        bessel_basis={"num_radial": p["num_radial"], "cutoff": p["cutoff"]},
        output_mlp={"units": [p["units"], 1], "activation": ["swish", "linear"]})
    return EnergyForceModel(model, device=device)


if __name__ == "__main__":
    run_force_training(build_model, parse_config_cli(CONFIG))
