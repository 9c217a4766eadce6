"""Hyperband search for HDNNP2nd force training (objective
``val_force_mae``); counterpart of the root
``force_hdnnp2nd_hyp_param_search.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_hdnnp2nd_hyp_param_search [--device cpu]
        [--trials N] [--max-epochs N] [--min-epochs N] [--directory DIR]
        [--conf C.json]
"""
from __future__ import annotations

from gcnn_keras_tpu_torch.scripts.force_hdnnp2nd import CONFIG
from gcnn_keras_tpu_torch.training.force_search import parse_search_cli, run_force_search


def build_model(hp, cfg, device=None, generator=None):
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_behler
    elements = cfg["elements"]
    units = [hp["mlp_width"]] * hp["mlp_depth"] + [1]
    acts = ["swish"] * hp["mlp_depth"] + ["linear"]
    model = make_model_behler(
        device=device, generator=generator,
        g2_kwargs={**cfg["g2"], "elements": elements, "rc": hp["radial_cutoff"]},
        g4_kwargs={**cfg["g4"], "elements": elements, "multiplicity": 2.0},
        mlp_kwargs={"units": units, "num_relations": max(elements) + 1, "activation": acts})
    return EnergyForceModel(model, device=device)


SPACE = {
    "mlp_width": {"choice": [32, 64, 128]},
    "mlp_depth": {"int": [2, 3]},
    "radial_cutoff": {"choice": [6.0, 8.0, 10.0]},
    "learning_rate": {"log_float": [1e-4, 5e-3]},
    "force_loss_weight": {"choice": [100.0, 200.0, 400.0]},
}


def main(argv=None):
    args = parse_search_cli(CONFIG, "hyp_search_hdnnp2nd", argv)
    return run_force_search(CONFIG, SPACE, build_model, args=args)


if __name__ == "__main__":
    main()
