"""HDNNP4th charge+energy training (no force term); counterpart of the root
``energy_hdnnp4th.py``.

    python -m gcnn_keras_tpu_torch.scripts.energy_hdnnp4th [--device cpu] [--epochs N]
"""
from gcnn_keras_tpu_torch.scripts.force_hdnnp4th import CONFIG as _BASE, build_model
from gcnn_keras_tpu_torch.training.force_script import parse_config_cli, run_force_training

CONFIG = dict(_BASE, model_prefix="model_hdnnp4th_energy",
              force_loss_weight=0.0, charge_loss_weight=1.0,
              energy_loss_weight=1.0, need_esp=True, need_angles=True)

if __name__ == "__main__":
    run_force_training(build_model, parse_config_cli(CONFIG))
