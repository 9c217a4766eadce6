"""Hyperband search for SchNet force training (objective ``val_force_mae``);
counterpart of the root ``force_schnet_hyp_param_search.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_schnet_hyp_param_search [--device cpu]
        [--trials N] [--max-epochs N] [--min-epochs N] [--directory DIR]
        [--conf C.json]
"""
from __future__ import annotations

from gcnn_keras_tpu_torch.scripts.force_schnet import CONFIG
from gcnn_keras_tpu_torch.training.force_search import parse_search_cli, run_force_search


def build_model(hp, cfg, device=None, generator=None):
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.schnet import make_model
    units = hp["units"]
    model = make_model(
        device=device, generator=generator,
        depth=hp["depth"], interaction_args={"units": units},
        gauss_args={"bins": hp["gauss_bins"], "distance_max": cfg["schnet"]["gauss_distance"]},
        last_mlp={"units": [units, units // 2],
                  "activation": ["shifted_softplus", "shifted_softplus"]},
        output_mlp={"units": [units // 2, 1], "activation": ["shifted_softplus", "linear"]})
    return EnergyForceModel(model, device=device)


SPACE = {
    "depth": {"int": [3, 6]},
    "units": {"choice": [64, 128, 256]},
    "gauss_bins": {"choice": [20, 25, 32]},
    "learning_rate": {"log_float": [1e-4, 5e-3]},
    "force_loss_weight": {"choice": [50.0, 200.0, 400.0]},
}


def main(argv=None):
    args = parse_search_cli(CONFIG, "hyp_search_schnet", argv)
    return run_force_search(CONFIG, SPACE, build_model, args=args)


if __name__ == "__main__":
    main()
