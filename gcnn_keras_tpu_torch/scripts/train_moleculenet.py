"""Molecular property regression on MoleculeNet-style graphs; counterpart
of the root ``training/train_moleculenet.py``.

    python -m gcnn_keras_tpu_torch.scripts.train_moleculenet [--device cpu]
        [--model GIN] [--dataset NAME] [--epochs 60] [--batch-size 32] [--folds 3]
        [--seed 42] [--early-stopping N] [--use-wandb] [--no-plots]

With ``--dataset NAME`` (ESOL, FreeSolv, Lipop, ClinTox, ...) the data are
``<NAME>Dataset`` of ``data/datasets/moleculenet.py``, read in memory: its
CSV from ``<DATASET_ROOT>/<NAME>/`` (fetched there where it is missing),
each SMILES made a graph by RDKit, which raises ``ImportError`` where it is
not installed. Without it the data are the JAX driver's synthetic ones: 96
random molecular graphs from ``--seed`` (5-14 nodes, a random tree and
extra bonds both ways) with 16 float node features, 8 float edge features
and a label that depends on both. Each of ``--folds`` folds standardizes the labels on its training
split (``StandardLabelScaler``), trains the model (``--model``, a registry
name; GIN at the driver's width) with Adam 1e-3 on the masked graph MAE
and validates its MAE, scaled and in label units; the score goes to
``results/moleculenet/<model>_score.yaml``, with ``--plots`` (matplotlib)
the loss curves and each fold's predicted-against-true scatter beside it.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from gcnn_keras_tpu_torch.training import graph_driver

GLOBAL_KEYS = ("graph_labels",)


def synthetic_dataset(seed: int):
    """The JAX driver's data, draw for draw."""
    from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
    rs = np.random.RandomState(seed)
    ds = MemoryGraphDataset(dataset_name="SyntheticMolNet")
    for _ in range(96):
        n = rs.randint(5, 15)
        ei = []
        for i in range(1, n):
            j = rs.randint(i)  # a random tree, then extra edges
            ei += [[i, j], [j, i]]
        for _ in range(n // 3):
            a, b = rs.randint(n, size=2)
            if a != b:
                ei += [[a, b], [b, a]]
        ei = np.unique(np.array(ei, dtype=np.int64), axis=0)
        feats = rs.randn(n, 16).astype(np.float32)
        m = ei.shape[0]
        eattr = rs.randn(m, 8).astype(np.float32)
        label = float(feats[:, 0].sum() * 0.3 + m * 0.05)
        ds.append({"node_attributes": feats, "edge_indices": ei, "edge_attributes": eattr,
                   "graph_labels": np.array([label], dtype=np.float32)})
    return ds


def load_dataset(name: Optional[str], seed: int):
    """``<name>Dataset`` of the MoleculeNet module read in memory, or the
    synthetic data of ``seed`` where ``name`` is None."""
    if not name:
        return synthetic_dataset(seed)
    from gcnn_keras_tpu_torch.data.datasets import moleculenet
    return getattr(moleculenet, f"{name}Dataset")().read_in_memory()


# the masked graph MAE against the scaled ``graph_labels``
loss_fn = graph_driver.graph_mae_loss


def scaled_split(ds, y, tr, te):
    """The fold's train and test graphs with labels standardized by the
    train split's scaler, and the scaler."""
    from gcnn_keras_tpu_torch.data.scalers import StandardLabelScaler
    scaler = StandardLabelScaler()
    y_tr = scaler.fit(y[tr][:, None]).transform(y[tr][:, None])[:, 0]
    y_te = scaler.transform(y[te][:, None])[:, 0]
    train, test = ds[tr], ds[te]
    for split, labels in ((train, y_tr), (test, y_te)):
        for g, yy in zip(split, labels):
            g["graph_labels"] = np.array([yy], dtype=np.float32)
    return train, test, scaler


def main(argv: Optional[List[str]] = None) -> dict:
    from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
    from gcnn_keras_tpu_torch.training.history import save_history_score
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae
    from gcnn_keras_tpu_torch.utils.data_splitter import kfold_indices
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    args = graph_driver.driver_parser(__doc__.splitlines()[0],
                                      "ESOL/FreeSolv/Lipop; default synthetic").parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.seed)
    y = np.array([float(np.asarray(g["graph_labels"]).reshape(-1)[0]) for g in ds])
    widths = graph_driver.input_widths(ds)
    histories, times = [], []
    for fold, (tr, te) in enumerate(kfold_indices(len(ds), k=args.folds, seed=args.seed)):
        train, test, scaler = scaled_split(ds, y, tr, te)
        model = graph_driver.build_model(args.model, 1, widths, device=dev,
                                         generator=torch.Generator().manual_seed(fold))
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
                                                f"molnet_{args.model}")
        histories.append(hist)
        times.append(seconds)
        print(f"fold {fold}: val_scaled_mae={hist['val_scaled_mae'][-1]:.4f}", flush=True)
        if args.plots:
            graph_driver.plot_fold(model, test_batch, args.model,
                                   args.dataset or "SyntheticMolNet",
                                   f"results/moleculenet/{args.model}_fold{fold}")
    if args.plots:
        from gcnn_keras_tpu_torch.utils.plots import plot_train_test_loss
        plot_train_test_loss(histories, loss_name="loss", val_loss_name="val_loss",
                             model_name=args.model,
                             dataset_name=args.dataset or "SyntheticMolNet",
                             filepath="results/moleculenet", file_name=f"{args.model}_loss.png")
    score = save_history_score(histories, f"results/moleculenet/{args.model}_score.yaml",
                               model_name=args.model, dataset_name=args.dataset or "synthetic",
                               seed=args.seed, time_list=times)
    print(json.dumps({"val_scaled_mae_mean": score.get("val_scaled_mae_mean")}))
    return score


if __name__ == "__main__":
    main()
