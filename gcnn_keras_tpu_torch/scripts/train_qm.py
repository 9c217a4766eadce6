"""Molecular property regression; counterpart of the root
``training/train_qm.py``.

    python -m gcnn_keras_tpu_torch.scripts.train_qm [--device cpu]
        [--model Schnet] [--hyper CONFIG] [--epochs 60] [--batch-size 32]
        [--folds 3] [--molecules 128] [--seed 42] [--early-stopping N]
        [--use-wandb] [--no-plots]

The data are the JAX driver's: ``SyntheticQM9Dataset(num_molecules=
--molecules, seed=--seed)`` with ``set_range(4.0, 15)`` as the edges. Of
``--folds`` folds, each fits an ``ExtensiveMolecularLabelScaler`` on its
training labels, builds the model (``--model``, a registry name: SchNet and
PAiNN at the driver's widths, any other at its defaults; weights drawn
from the fold) and trains it with Adam 1e-3 on the scaled labels' masked
MAE through ``Trainer`` and ``fit_model``, validating on the fold's test
molecules (``val_loss``, and ``val_scaled_mae`` in the labels' units). The
score goes to ``results/qm/<model>_score.yaml``; with ``--plots``
(matplotlib) the loss curves and each fold's predicted-against-true
scatter beside it. With ``--hyper`` the config's entry for ``--model``
gives the dataset (``data/serial.py``; e.g. ``hyper_qm7.py``'s
``QM7Dataset`` reads ``<DATASET_ROOT>/QM7/qm7.mat``, fetched there where it
is missing), the model and the optimizer. ``--steps-per-dispatch``
changes nothing (``Trainer.fit_epoch``).
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from gcnn_keras_tpu_torch.training import graph_driver

GLOBAL_KEYS = ("graph_labels",)
# the driver's SchNet and PAiNN (every other model at its defaults)
DRIVER_KW = {
    "Schnet": dict(depth=3, interaction_args={"units": 64},
                   gauss_args={"bins": 20, "distance_max": 4.0},
                   last_mlp={"units": [64, 32], "activation": ["shifted_softplus"] * 2},
                   output_mlp={"units": [16, 1], "activation": ["shifted_softplus", "linear"]}),
    "PAiNN": dict(depth=2, conv_args={"units": 64}, update_args={"units": 64},
                  input_embedding={"node": {"output_dim": 64}},
                  output_mlp={"units": [64, 1], "activation": ["swish", "linear"]}),
}


def synthetic_dataset(molecules: int, seed: int):
    """The JAX driver's molecules with their ``set_range(4.0, 15)`` edges."""
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticQM9Dataset
    ds = SyntheticQM9Dataset(num_molecules=molecules, seed=seed)
    return ds.map_list("set_range", max_distance=4.0, max_neighbours=15)


def build_model(name: str, widths, device=None, generator=None, hyper=None):
    """``name`` at ``DRIVER_KW``'s widths (any other at its defaults), or
    ``hyper``'s model; each with the data's ``widths``."""
    if hyper is not None:
        return graph_driver.build_hyper_model(hyper, widths, device, generator)
    from gcnn_keras_tpu_torch.models.registry import get_model_class
    builder = get_model_class(name)
    return builder(device=device, generator=generator, **DRIVER_KW.get(name, {}),
                   **graph_driver.widths_for(builder, widths))


# the masked MAE of the graph output against the scaled labels
loss_fn = graph_driver.graph_mae_loss


def relabel(part, labels) -> None:
    """Each graph of ``part`` (copies of the dataset's dicts) gets its
    scaled label."""
    for g, y in zip(part, labels):
        g["graph_labels"] = np.array([y], dtype=np.float32)


def main(argv: Optional[List[str]] = None) -> dict:
    from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
    from gcnn_keras_tpu_torch.data.scalers import ExtensiveMolecularLabelScaler
    from gcnn_keras_tpu_torch.training.history import save_history_score
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae
    from gcnn_keras_tpu_torch.utils.data_splitter import kfold_indices
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    ap = graph_driver.driver_parser(__doc__.splitlines()[0])
    ap.set_defaults(model="Schnet")
    ap.add_argument("--hyper", default=None, help="path to a hyper config")
    ap.add_argument("--molecules", type=int, default=128)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    hyper = None
    if args.hyper:
        hyper, ds = graph_driver.load_hyper(args.hyper, args.model)
        optimizer = hyper.make_optimizer()
    else:
        ds = synthetic_dataset(args.molecules, args.seed)
        optimizer = None  # train_fold's Adam 1e-3
    for g in ds:
        g["edge_indices"] = g.get("range_indices", g.get("edge_indices"))
    widths = graph_driver.input_widths(ds)
    y = np.array([float(np.asarray(g["graph_labels"]).reshape(-1)[0]) for g in ds])
    z = [np.asarray(g["node_number"]) for g in ds]
    histories, times = [], []
    for fold, (tr, te) in enumerate(kfold_indices(len(ds), k=args.folds, seed=args.seed)):
        scaler = ExtensiveMolecularLabelScaler()
        y_tr = scaler.fit(y[tr], [z[i] for i in tr]).transform(y[tr], [z[i] for i in tr])
        y_te = scaler.transform(y[te], [z[i] for i in te])
        train, test = ds[tr], ds[te]
        relabel(train, y_tr)
        relabel(test, y_te)
        model = build_model(args.model, widths, dev, torch.Generator().manual_seed(fold),
                            hyper)
        # the JAX driver's first batch initialises its model, so its epochs
        # train on the loader's shuffles from epoch 1 on: seed + 1 here
        loader = GraphBatchLoader(list(train), args.batch_size, shuffle=True,
                                  seed=args.seed + 1, global_keys=GLOBAL_KEYS, device=dev,
                                  **train.batch_shape_hint(args.batch_size))
        test_batch = test.to_batch(global_keys=GLOBAL_KEYS, device=dev)
        scale = float(scaler.get_scaling()[0])

        def val():
            vm = float(masked_graph_mae(model(test_batch)["output"],
                                        test_batch.globals["graph_labels"],
                                        test_batch.globals["graph_mask"]))
            return {"val_loss": vm, "val_scaled_mae": vm * scale}
        hist, seconds = graph_driver.train_fold(model, loss_fn(model), loader,
                                                graph_driver.evaluation(val), args, fold,
                                                f"qm_{args.model}", optimizer)
        histories.append(hist)
        times.append(seconds)
        print(f"fold {fold}: val_scaled_mae={hist['val_scaled_mae'][-1]:.4f}", flush=True)
        if args.plots:
            graph_driver.plot_fold(model, test_batch, args.model, "SyntheticQM9",
                                   f"results/qm/{args.model}_fold{fold}")
    if args.plots:
        from gcnn_keras_tpu_torch.utils.plots import plot_train_test_loss
        plot_train_test_loss(histories, loss_name="loss", val_loss_name="val_loss",
                             model_name=args.model, dataset_name="SyntheticQM9",
                             filepath="results/qm", file_name=f"{args.model}_loss.png")
    score = save_history_score(histories, f"results/qm/{args.model}_score.yaml",
                               model_name=args.model, dataset_name="SyntheticQM9",
                               seed=args.seed, time_list=times)
    print(json.dumps({"val_scaled_mae_mean": score.get("val_scaled_mae_mean")}))
    return score


if __name__ == "__main__":
    main()
