"""HDNNP2nd (Behler ACSF) energy+force training; counterpart of the root
``force_hdnnp2nd.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_hdnnp2nd [--device cpu] [--epochs N]
"""
from gcnn_keras_tpu_torch.training.force_script import (
    DEFAULTS, parse_config_cli, run_force_training)

CONFIG = dict(DEFAULTS, model_prefix="model_hdnnp2nd_force",
              need_angles=True,
              elements=[1, 6, 8],
              g2={"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 10.0},
              g4={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0],
                  "zeta": [1.0, 8.0], "rc": 6.0},
              mlp_units=[64, 64, 1])


def build_model(cfg, device=None, generator=None):
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_behler
    elements = cfg["elements"]
    acts = ["swish"] * (len(cfg["mlp_units"]) - 1) + ["linear"]
    model = make_model_behler(
        device=device, generator=generator,
        g2_kwargs={**cfg["g2"], "elements": elements},
        g4_kwargs={**cfg["g4"], "elements": elements, "multiplicity": 2.0},
        mlp_kwargs={"units": cfg["mlp_units"], "num_relations": max(elements) + 1,
                    "activation": acts})
    return EnergyForceModel(model, device=device)


if __name__ == "__main__":
    run_force_training(build_model, parse_config_cli(CONFIG))
