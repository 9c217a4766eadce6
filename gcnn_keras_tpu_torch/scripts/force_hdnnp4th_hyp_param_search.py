"""Hyperband search for HDNNP4th force training (objective
``val_force_mae``); counterpart of the root
``force_hdnnp4th_hyp_param_search.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_hdnnp4th_hyp_param_search [--device cpu]
        [--trials N] [--max-epochs N] [--min-epochs N] [--directory DIR]
        [--conf C.json]

Its own trial loop: ``force_hdnnp4th``'s dataset split by
``RandomState(0)``, the loss ``(E + w F + 50 q) / (w + 51)`` with ``w``
the trial's force weight, and ``val_force_mae`` alone as the trial's
metrics.
"""
from __future__ import annotations

from gcnn_keras_tpu_torch.scripts.force_hdnnp4th import CONFIG
from gcnn_keras_tpu_torch.scripts.force_hdnnp4th import build_model as _build_hdnnp4th
from gcnn_keras_tpu_torch.scripts.force_hdnnp4th import load_dataset
from gcnn_keras_tpu_torch.training.force_search import (
    make_trial_fn, parse_search_cli, run_search, search_config, split_search_data)
from gcnn_keras_tpu_torch.utils.devices import resolve_device

GLOBAL_KEYS = ("energy", "total_charge")

SPACE = {
    "mlp_width": {"choice": [32, 64, 128]},
    "mlp_depth": {"int": [2, 3]},
    "learning_rate": {"log_float": [1e-4, 5e-3]},
    "force_loss_weight": {"choice": [100.0, 200.0, 400.0]},
}


def build_model(hp, cfg, device=None, generator=None):
    cfg = dict(cfg, mlp_units=[hp["mlp_width"]] * hp["mlp_depth"] + [1])
    return _build_hdnnp4th(cfg, device=device, generator=generator)


def loss_weights(cfg, hp):
    w = hp["force_loss_weight"]
    return {"energy": 1.0 / (w + 51.0), "force": w / (w + 51.0), "charge": 50.0 / (w + 51.0)}


def search_trial_fn(cfg0, device, **kwargs):
    """The trial function over ``cfg0``'s dataset on ``device``;
    ``kwargs`` go to ``make_trial_fn``."""
    train, val = split_search_data(load_dataset(cfg0), 0)
    return make_trial_fn(build_model, cfg0, train, val, GLOBAL_KEYS, device,
                         loss_weights=loss_weights, metric_keys=("val_force_mae",), **kwargs)


def main(argv=None):
    args = parse_search_cli(CONFIG, "hyp_search_hdnnp4th", argv)
    cfg0 = search_config(CONFIG, args)
    trial_fn = search_trial_fn(cfg0, resolve_device(args.device))
    return run_search(SPACE, "val_force_mae", trial_fn, args)


if __name__ == "__main__":
    main()
