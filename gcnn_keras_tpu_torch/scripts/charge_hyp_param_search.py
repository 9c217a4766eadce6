"""Hyperband search for the HDNNP4th charge (electronegativity) network
(objective ``val_charge_mae``); counterpart of the root
``charge_hyp_param_search.py``.

    python -m gcnn_keras_tpu_torch.scripts.charge_hyp_param_search [--device cpu]
        [--trials N] [--max-epochs N] [--min-epochs N] [--directory DIR]
        [--conf C.json]
"""
from __future__ import annotations

from gcnn_keras_tpu_torch.scripts.charge_hdnnp4th import CONFIG
from gcnn_keras_tpu_torch.scripts.force_hdnnp4th import build_model as _build_hdnnp4th
from gcnn_keras_tpu_torch.scripts.force_hdnnp4th import load_dataset
from gcnn_keras_tpu_torch.training.force_search import parse_search_cli, run_force_search


def build_model(hp, cfg, device=None, generator=None):
    cfg = dict(cfg, mlp_units=[hp["mlp_width"]] * hp["mlp_depth"] + [1])
    return _build_hdnnp4th(cfg, device=device, generator=generator)


SPACE = {
    "mlp_width": {"choice": [32, 64, 128]},
    "mlp_depth": {"int": [2, 3]},
    "learning_rate": {"log_float": [1e-4, 5e-3]},
}


def main(argv=None):
    args = parse_search_cli(CONFIG, "hyp_search_charge", argv)
    return run_force_search(CONFIG, SPACE, build_model, objective="val_charge_mae",
                            args=args, load_dataset=load_dataset)


if __name__ == "__main__":
    main()
