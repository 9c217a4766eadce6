"""HDNNP2nd energy-only training; counterpart of the root
``energy_hdnnp2nd.py``.

    python -m gcnn_keras_tpu_torch.scripts.energy_hdnnp2nd [--device cpu] [--epochs N]
"""
from gcnn_keras_tpu_torch.scripts.force_hdnnp2nd import CONFIG as _BASE, build_model
from gcnn_keras_tpu_torch.training.force_script import parse_config_cli, run_force_training

CONFIG = dict(_BASE, model_prefix="model_hdnnp2nd_energy",
              force_loss_weight=0.0, energy_loss_weight=1.0)

if __name__ == "__main__":
    run_force_training(build_model, parse_config_cli(CONFIG))
