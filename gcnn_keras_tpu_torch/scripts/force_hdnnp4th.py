"""The flagship: HDNNP4th charge+energy+force training with ESP coupling;
counterpart of the root ``force_hdnnp4th.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_hdnnp4th [--device cpu] [--epochs N]
        [--conf CONFIG.json]

Its own dataset (``load_dataset``: the synthetic trajectory's elements
mapped onto ``elements``, random charges, ESPs and their gradients) and
loss weights (50 q + E + 200 F, normalized), the engine's fold loop, and
the evaluator on every split; the score goes to
``results/hdnnp4th_score.yaml``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

CONFIG = {
    "data_path": None,                 # pickled dataset
    "model_prefix": "model_energy_force",
    "charge_loss_weight": 50.0,
    "energy_loss_weight": 1.0,
    "force_loss_weight": 200.0,
    "epochs": 100,
    "batch_size": 16,
    "learning_rate_start": 1e-3,
    "learning_rate_stop": 1e-5,
    "ensemble_size": 3,
    "seed": 42,
    "steps_per_dispatch": 1,
    # EarlyStopping patience (0 = off; the best weights come back when it
    # stops), an optional wandb run, the PNGs
    "early_stopping": 0,
    "use_wandb": False,
    "wandb_project": "gcnn_keras_tpu",
    "make_plots": True,
    "elements": [1, 6, 16],
    "g2": {"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 10.0},
    "g4": {"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "zeta": [1.0, 8.0], "rc": 6.0},
    "mlp_units": [64, 64, 1],
    "synthetic_frames": 64,            # the synthetic dataset's size
}


def build_model(cfg, device=None, generator=None):
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.hdnnp4th import make_model_behler
    elements = cfg["elements"]
    mlp = {"units": cfg["mlp_units"], "num_relations": max(elements) + 1,
           "activation": ["swish"] * (len(cfg["mlp_units"]) - 1) + ["linear"]}
    model = make_model_behler(
        device=device, generator=generator,
        g2_kwargs={**cfg["g2"], "elements": elements},
        g4_kwargs={**cfg["g4"], "elements": elements, "multiplicity": 2.0},
        mlp_charge_kwargs=mlp, mlp_local_kwargs=dict(mlp))
    return EnergyForceModel(model, use_esp_coupling=True, device=device)


def load_dataset(cfg):
    """``data_path``'s pickle, or ``SyntheticMDDataset`` with its elements
    outside ``elements`` replaced by the first, random charges, ESPs and
    ESP gradients, neighbours within 6.0 (at most 15) and angles."""
    from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
    if cfg["data_path"]:
        return MemoryGraphDataset().load(cfg["data_path"])
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticMDDataset
    ds = SyntheticMDDataset(num_frames=cfg["synthetic_frames"], seed=cfg["seed"])
    rs = np.random.RandomState(cfg["seed"])
    for g in ds:
        n = len(g["node_number"])
        g["node_number"] = np.asarray(
            [z if z in cfg["elements"] else cfg["elements"][0] for z in g["node_number"]],
            dtype=np.int64)
        g["charge"] = (rs.randn(n) * 0.1).astype(np.float32)
        g["esp"] = (rs.randn(n) * 0.01).astype(np.float32)
        g["esp_grad"] = (rs.randn(n, 3) * 0.01).astype(np.float32)
        g["total_charge"] = np.array([g["charge"].sum()], dtype=np.float32)
    ds.map_list("set_range", max_distance=6.0, max_neighbours=15)
    ds.map_list("set_angle")
    for g in ds:
        g["edge_indices"] = g["range_indices"]
    return ds


def train(cfg):
    """What ``main`` runs after reading the command line: the fold loop on
    ``cfg["device"]`` (the CUDA card unless ``"cpu"``); returns the
    score."""
    from gcnn_keras_tpu_torch.training.force_script import train_folds
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    device = resolve_device(cfg.get("device"))
    return train_folds(build_model, cfg, load_dataset(cfg), device, ("energy", "total_charge"),
                       evaluate_all_splits=True, model_name="HDNNP4th", dataset_name="force",
                       loss_file="hdnnp4th_loss.png", score_file="results/hdnnp4th_score.yaml")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--conf", default=None, help="JSON config override")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="the device to train on: the CUDA card unless 'cpu'")
    args = ap.parse_args()
    cfg = dict(CONFIG)
    if args.conf:
        with open(args.conf) as f:
            cfg.update(json.load(f))
    if args.epochs is not None:
        cfg["epochs"] = args.epochs
    if args.device:
        cfg["device"] = args.device
    score = train(cfg)
    print(json.dumps({"val_force_mae_mean": score.get("val_force_mae_mean")}))


if __name__ == "__main__":
    main()
