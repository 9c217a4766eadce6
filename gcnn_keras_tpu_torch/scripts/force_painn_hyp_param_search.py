"""Hyperband search for PAiNN force training (objective ``val_force_mae``);
counterpart of the root ``force_painn_hyp_param_search.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_painn_hyp_param_search [--device cpu]
        [--trials N] [--max-epochs N] [--min-epochs N] [--directory DIR]
        [--conf C.json]
"""
from __future__ import annotations

from gcnn_keras_tpu_torch.scripts.force_painn import CONFIG
from gcnn_keras_tpu_torch.training.force_search import parse_search_cli, run_force_search


def build_model(hp, cfg, device=None, generator=None):
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.painn import make_model
    units = hp["units"]
    model = make_model(
        device=device, generator=generator,
        depth=hp["depth"],
        conv_args={"units": units, "cutoff": None},
        update_args={"units": units},
        input_embedding={"node": {"output_dim": units}},
        bessel_basis={"num_radial": hp["num_radial"], "cutoff": cfg.get("cutoff", 5.0)},
        output_mlp={"units": [units, 1], "activation": ["swish", "linear"]})
    return EnergyForceModel(model, device=device)


SPACE = {
    "depth": {"int": [2, 4]},
    "units": {"choice": [64, 128, 256]},
    "num_radial": {"choice": [16, 20, 32]},
    "learning_rate": {"log_float": [1e-4, 5e-3]},
    "force_loss_weight": {"choice": [50.0, 200.0, 400.0]},
}


def main(argv=None):
    args = parse_search_cli(CONFIG, "hyp_search_painn", argv)
    return run_force_search(CONFIG, SPACE, build_model, args=args)


if __name__ == "__main__":
    main()
