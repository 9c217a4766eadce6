"""Node classification on a citation graph; counterpart of the root
``training/train_citation.py``.

    python -m gcnn_keras_tpu_torch.scripts.train_citation [--device cpu]
        [--model GCN] [--hyper CONFIG] [--epochs 100] [--folds 5] [--nodes 500]
        [--seed 42] [--early-stopping N] [--no-plots]

The data are the JAX driver's: ``SyntheticCitationDataset(num_nodes=--nodes,
seed=--seed)``, one graph. Its nodes are cut into ``--folds`` folds of a
seeded permutation; each fold's nodes are the test nodes of one run and
the rest its training nodes. Each run builds the model (``--model``, a
registry name, at the driver's widths: depth 3, 64 units, a node output
through ``[64, classes]``; ``in_features`` from the data; weights drawn
from the fold) and takes full-batch Adam 1e-2 steps on the masked
categorical cross-entropy of the training nodes through ``Trainer``. The
test accuracy is read from the forward of the same step, so from the
weights before its update, as the JAX step returns it; it is recorded
every tenth epoch and at the last, and every epoch under
``--early-stopping`` (patience on that accuracy; the best weights are
restored). The score goes to ``results/citation/<model>_score.yaml``, the
curves (with ``--plots``, which needs matplotlib) beside it. With
``--hyper`` the config's entry for ``--model`` gives the dataset
(``data/serial.py``; ``hyper_cora.py``'s ``CoraDataset`` reads
``<DATASET_ROOT>/Cora/cora.npz``, fetched there where it is missing), the
model and the optimizer.
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from typing import List, Optional

import numpy as np
import torch

from gcnn_keras_tpu_torch.training import graph_driver
from gcnn_keras_tpu_torch.training.trainer import Trainer

LEARNING_RATE = 1e-2  # optax.adam(1e-2) in the JAX driver
MONITOR = "val_categorical_accuracy"


def parser() -> argparse.ArgumentParser:
    """The JAX driver's arguments, and ``--device`` (the CUDA card unless
    ``cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hyper", default=None, help="path to a hyper config")
    ap.add_argument("--model", default="GCN")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--nodes", type=int, default=500)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--early-stopping", type=int, default=0,
                    help="EarlyStopping patience on the test accuracy (0 = off); "
                         "restores the best weights")
    ap.add_argument("--plots", dest="plots", action="store_true", default=True)
    ap.add_argument("--no-plots", dest="plots", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return ap


def build_model(name: str, n_classes: int, widths, device=None, generator=None):
    """The driver's model: ``name`` from the registry at depth 3, 64 units,
    a node output through ``[64, n_classes]`` (relu, linear), with the
    data's ``widths``."""
    from gcnn_keras_tpu_torch.models.registry import get_model_class
    builder = get_model_class(name)
    return builder(device=device, generator=generator, depth=3, gcn_args={"units": 64},
                   output_embedding="node",
                   output_mlp={"units": [64, n_classes], "activation": ["relu", "linear"]},
                   **graph_driver.widths_for(builder, widths))


def loss_fn(model, batch_y: torch.Tensor, train_mask: torch.Tensor,
            test_mask: torch.Tensor):
    """The masked cross-entropy on the training nodes, and the accuracy on
    the test nodes of the same forward as the metric ``MONITOR``."""
    from gcnn_keras_tpu_torch.training.losses import (masked_accuracy,
                                                      masked_categorical_crossentropy)

    def fn(b):
        out = model(b)["output"]
        return masked_categorical_crossentropy(out, batch_y, train_mask), \
            {MONITOR: masked_accuracy(out.detach(), batch_y, test_mask)}
    return fn


def graph_inputs(ds, device):
    """The dataset's one graph as a batch on ``device`` without its labels,
    the labels padded to the batch's nodes, and the number of classes."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    g = dict(ds[0])
    labels = np.asarray(g.pop("node_labels"))
    batch = batch_graphs([g], device=device)
    y = np.zeros(batch.n_node, dtype=np.int64)
    y[:labels.shape[0]] = labels
    return batch, torch.as_tensor(y, device=device), int(labels.max()) + 1


def fold_masks(n: int, n_node: int, folds: int, seed: int, device=None):
    """``(train_mask, test_mask)`` of each fold over a batch of ``n_node``
    rows whose first ``n`` are the graph's nodes: the fold's part of a
    seeded permutation is its test set, the other real nodes its training
    set."""
    out = []
    for test_idx in np.array_split(np.random.RandomState(seed).permutation(n), folds):
        train_mask = np.zeros(n_node, dtype=bool)
        train_mask[:n] = True
        train_mask[test_idx] = False
        test_mask = np.zeros(n_node, dtype=bool)
        test_mask[test_idx] = True
        out.append((torch.as_tensor(train_mask, device=device),
                    torch.as_tensor(test_mask, device=device)))
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    from gcnn_keras_tpu_torch.training.callbacks import EarlyStopping
    from gcnn_keras_tpu_torch.training.history import save_history_score
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    hyper = None
    if args.hyper:
        hyper, ds = graph_driver.load_hyper(args.hyper, args.model)
    else:
        from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticCitationDataset
        ds = SyntheticCitationDataset(num_nodes=args.nodes, seed=args.seed)
    widths = graph_driver.input_widths(ds)
    batch, y, n_classes = graph_inputs(ds, device)
    histories, times = [], []
    for fold, (train_mask, test_mask) in enumerate(
            fold_masks(int(batch.node_mask.sum()), batch.n_node, args.folds, args.seed, device)):
        generator = torch.Generator().manual_seed(fold)
        if hyper is not None:
            model = graph_driver.build_hyper_model(hyper, widths, device, generator)
            optimizer = hyper.make_optimizer()
        else:
            model = build_model(args.model, n_classes, widths, device, generator)
            optimizer = functools.partial(torch.optim.Adam, lr=LEARNING_RATE)
        trainer = Trainer(loss_fn(model, y, train_mask, test_mask), optimizer)
        state = trainer.init_state(model.parameters())
        stopper = EarlyStopping(monitor=MONITOR, patience=args.early_stopping, mode="max") \
            if args.early_stopping > 0 else None
        t0 = time.perf_counter()
        hist = {"loss": [], MONITOR: []}
        for epoch in range(args.epochs):
            state, metrics = trainer.step(state, batch)
            if stopper is not None or epoch % 10 == 9 or epoch == args.epochs - 1:
                acc = float(metrics[MONITOR])
                hist["loss"].append(float(metrics["loss"]))
                hist[MONITOR].append(acc)
                if stopper is not None and stopper.update(epoch, {MONITOR: acc}, state.params):
                    stopper.restore(state.params)
                    print(f"fold {fold}: early stopping at epoch {epoch}")
                    break
        times.append(time.perf_counter() - t0)
        histories.append(hist)
        print(f"fold {fold}: loss={hist['loss'][-1]:.4f} val_acc={hist[MONITOR][-1]:.4f}",
              flush=True)
    if args.plots:
        from gcnn_keras_tpu_torch.utils.plots import plot_train_test_loss
        plot_train_test_loss(histories, loss_name="loss", val_loss_name=MONITOR,
                             model_name=args.model, dataset_name="SyntheticCitation",
                             filepath="results/citation", file_name=f"{args.model}_loss.png")
    score = save_history_score(histories, f"results/citation/{args.model}_score.yaml",
                               model_name=args.model, dataset_name="SyntheticCitation",
                               seed=args.seed, time_list=times)
    print(json.dumps({f"{MONITOR}_mean": score.get(f"{MONITOR}_mean")}))
    return score


if __name__ == "__main__":
    main()
