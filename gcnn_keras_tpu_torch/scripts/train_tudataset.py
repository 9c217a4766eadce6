"""Graph classification on TUDataset-style graphs; counterpart of the root
``training/train_tudataset.py``.

    python -m gcnn_keras_tpu_torch.scripts.train_tudataset [--device cpu]
        [--model GIN] [--dataset NAME] [--epochs 60] [--batch-size 32] [--folds 3]
        [--seed 42] [--early-stopping N] [--use-wandb] [--no-plots]

With ``--dataset`` (e.g. MUTAG) the data are that TUDataset collection
(``GraphTUDataset2020``, read from ``<DATASET_ROOT>/<name>/<name>.zip``,
fetched there where it is missing); its graph labels are the classes (the
largest + 1 of them; MUTAG's -1 gives a one-hot row of zeros, as
``jax.nn.one_hot`` does). Without it the data are the JAX driver's
synthetic ones: 96 QM9-like molecules from ``--seed``, their neighbours
within 4 A (at most 10) as the edges, labelled 1 where a molecule has more
than 9 atoms. Each of ``--folds`` folds trains the model (``--model``, a
registry name; GIN at the driver's width) with Adam 1e-3 on the masked
categorical cross-entropy and validates its accuracy; the score goes to ``results/tudataset/<model>_score.yaml``, the
loss curves (with ``--plots``, which needs matplotlib) beside it.
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
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticQM9Dataset
    ds = SyntheticQM9Dataset(num_molecules=96, seed=seed)
    ds.map_list("set_range", max_distance=4.0, max_neighbours=10)
    for g in ds:
        g["edge_indices"] = g["range_indices"]
        g["graph_labels"] = np.array([float(len(g["node_number"]) > 9)], dtype=np.float32)
    return ds


def load_dataset(name: Optional[str], seed: int):
    """The TUDataset collection ``name`` read in memory, or the synthetic
    data of ``seed`` where ``name`` is None."""
    if not name:
        return synthetic_dataset(seed)
    from gcnn_keras_tpu_torch.data.datasets.tudataset import GraphTUDataset2020
    return GraphTUDataset2020(dataset_name=name).read_in_memory()


def n_classes(ds) -> int:
    """The classes of the dataset's integer ``graph_labels``: the largest
    label + 1."""
    return 1 + max(int(np.asarray(g["graph_labels"]).reshape(-1)[0]) for g in ds)


def loss_fn(model):
    """The masked categorical cross-entropy of the graph logits against the
    integer ``graph_labels``."""
    from gcnn_keras_tpu_torch.training.losses import masked_categorical_crossentropy

    def fn(b):
        y = b.globals["graph_labels"].reshape(-1).long()
        return masked_categorical_crossentropy(model(b)["output"], y,
                                               b.globals["graph_mask"]), {}
    return fn


def main(argv: Optional[List[str]] = None) -> dict:
    from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
    from gcnn_keras_tpu_torch.training.history import save_history_score
    from gcnn_keras_tpu_torch.training.losses import masked_accuracy
    from gcnn_keras_tpu_torch.utils.data_splitter import kfold_indices
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    args = graph_driver.driver_parser(__doc__.splitlines()[0],
                                      "TUDataset name (e.g. MUTAG); default synthetic"
                                      ).parse_args(argv)
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset, args.seed)
    labels = np.array([int(np.asarray(g["graph_labels"]).reshape(-1)[0]) for g in ds])
    widths = graph_driver.input_widths(ds)
    histories, times = [], []
    for fold, (tr, te) in enumerate(kfold_indices(len(ds), k=args.folds, seed=args.seed)):
        model = graph_driver.build_model(args.model, n_classes(ds), widths, device=dev,
                                         generator=torch.Generator().manual_seed(fold))
        train, test = ds[tr], ds[te]
        # the JAX driver's first batch initialises its model, so its epochs
        # train on the loader's shuffles from epoch 1 on: seed + 1 here
        loader = GraphBatchLoader(list(train), args.batch_size, shuffle=True,
                                  seed=args.seed + 1, global_keys=GLOBAL_KEYS, device=dev,
                                  **train.batch_shape_hint(args.batch_size))
        test_batch = test.to_batch(global_keys=GLOBAL_KEYS, device=dev)
        y_te = torch.as_tensor(labels[te], device=dev)

        def val():
            out = model(test_batch)["output"]
            acc = float(masked_accuracy(out[:len(te)], y_te,
                                        test_batch.globals["graph_mask"][:len(te)]))
            # the monitor minimizes: the negated accuracy
            return {"val_accuracy": acc, "val_loss": -acc}
        hist, seconds = graph_driver.train_fold(model, loss_fn(model), loader,
                                                graph_driver.evaluation(val), args, fold,
                                                f"tu_{args.model}")
        histories.append(hist)
        times.append(seconds)
        print(f"fold {fold}: val_acc={hist['val_accuracy'][-1]:.4f}", flush=True)
    if args.plots:
        from gcnn_keras_tpu_torch.utils.plots import plot_train_test_loss
        plot_train_test_loss(histories, loss_name="loss", val_loss_name="val_accuracy",
                             model_name=args.model, dataset_name=args.dataset or "synthetic",
                             filepath="results/tudataset", file_name=f"{args.model}_loss.png")
    score = save_history_score(histories, f"results/tudataset/{args.model}_score.yaml",
                               model_name=args.model, dataset_name=args.dataset or "synthetic",
                               seed=args.seed, time_list=times)
    print(json.dumps({"val_accuracy_mean": score.get("val_accuracy_mean")}))
    return score


if __name__ == "__main__":
    main()
