"""An explainable model on a visual-graph dataset; counterpart of the root
``training/train_visual_graph_dataset.py``.

    python -m gcnn_keras_tpu_torch.scripts.train_visual_graph_dataset
        [--device cpu] [--model MEGAN] [--hyper CONFIG]
        [--dataset VgdMockDataset|VgdRbMotifsDataset] [--epochs 100]
        [--graphs 64] [--seed 42] [--folds 1] [--no-plots]

The data are ``--graphs`` graphs of the chosen dataset of
``data/datasets/vgd.py``, made from ``--seed``, with their ground-truth
node importances. Of ``--folds`` folds of a seeded permutation (a fifth of
the graphs as the test set with one fold, a k-th with more), each builds
MEGAN (``make_model(units=[32, 32], importance_channels=2,
final_units=[16, 1], final_activation="linear")``, ``in_features`` from
the data; weights drawn from the seed plus the fold) and takes one
full-batch Adam 1e-3 step an epoch through ``Trainer`` on the labels'
masked MAE, recording the loss every tenth epoch. It then scores the test
graphs: their MAE (``val_mae``) and the mean ROC-AUC of the node
importances (the channels' largest) against the ground truth
(``val_node_auc``). The score goes to ``results/vgd/<model>_score.yaml``,
the loss curves (with ``--plots``, which needs matplotlib; the JAX driver
always draws them) beside it. With ``--hyper`` the config's entry for
``--model`` gives the dataset (``data/serial.py``), the model, the
optimizer and the epochs (``training.fit.epochs``).
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

GLOBAL_KEYS = ("graph_labels",)
LEARNING_RATE = 1e-3  # optax.adam(1e-3) in the JAX driver
# the driver's MEGAN
MEGAN_KW = dict(units=[32, 32], importance_channels=2, final_units=[16, 1],
                final_activation="linear")
DATASETS = ("VgdMockDataset", "VgdRbMotifsDataset")


def importance_auc(scores: np.ndarray, truth: np.ndarray) -> float:
    """ROC-AUC of continuous importance scores against a binary ground
    truth (the chance that a random positive outranks a random negative);
    NaN without both classes."""
    pos, neg = scores[truth > 0.5], scores[truth <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([neg, pos]))
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    r_pos = ranks[len(neg):].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg)))


def parser() -> argparse.ArgumentParser:
    """The JAX driver's arguments, ``--plots``/``--no-plots`` and
    ``--device`` (the CUDA card unless ``cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hyper", default=None)
    ap.add_argument("--model", default="MEGAN")
    ap.add_argument("--dataset", default="VgdMockDataset", choices=DATASETS)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--graphs", type=int, default=64)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--folds", type=int, default=1,
                    help="k-fold cross-validation (1 = a single 80/20 split)")
    ap.add_argument("--plots", dest="plots", action="store_true", default=True)
    ap.add_argument("--no-plots", dest="plots", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return ap


def load_dataset(name: str, graphs: int, seed: int):
    """``graphs`` graphs of the dataset class ``name`` of
    ``data/datasets/vgd.py``, made from ``seed``."""
    from gcnn_keras_tpu_torch.data.datasets import vgd
    return getattr(vgd, name)(num_graphs=graphs, seed=seed)


def build_model(widths, device=None, generator=None):
    """The driver's MEGAN (``MEGAN_KW``) at the data's ``widths``."""
    from gcnn_keras_tpu_torch.models.megan import make_model
    return make_model(device=device, generator=generator, **MEGAN_KW,
                      **graph_driver.widths_for(make_model, widths))


def to_batch(part, device):
    """The graphs of ``part`` without their ground truth, in one batch."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    graphs = [{k: v for k, v in g.items() if k != "node_importances_true"} for g in part]
    return batch_graphs(graphs, global_keys=GLOBAL_KEYS, device=device)


# the masked MAE of the graph output against the labels
loss_fn = graph_driver.graph_mae_loss


def node_auc(out, test_batch, test) -> float:
    """The mean over the test graphs (with both classes) of the node
    importances' ROC-AUC against ``node_importances_true``; NaN for none."""
    if "node_importances" not in out or "node_importances_true" not in test[0]:
        return float("nan")
    imp = out["node_importances"].detach().cpu().numpy().max(axis=-1)
    nm = test_batch.node_mask.cpu().numpy()
    gid = test_batch.graph_id.cpu().numpy()
    aucs = [importance_auc(imp[nm & (gid == i)], np.asarray(g["node_importances_true"]))
            for i, g in enumerate(test)]
    aucs = [a for a in aucs if np.isfinite(a)]
    return float(np.mean(aucs)) if aucs else float("nan")


def main(argv: Optional[List[str]] = None) -> dict:
    from gcnn_keras_tpu_torch.training.history import save_history_score
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    hyper = None
    if args.hyper:
        hyper, ds = graph_driver.load_hyper(args.hyper, args.model)
        epochs = hyper["training"]["fit"].get("epochs", args.epochs)
    else:
        ds = load_dataset(args.dataset, args.graphs, args.seed)
        epochs = args.epochs
    widths = graph_driver.input_widths(ds)
    histories, times = [], []
    for fold, (test_idx, train_idx) in enumerate(
            graph_driver.holdout_folds(len(ds), args.folds, args.seed)):
        test, train = ds[test_idx], ds[train_idx]
        train_batch, test_batch = to_batch(train, device), to_batch(test, device)
        generator = torch.Generator().manual_seed(args.seed + fold)
        if hyper is not None:
            model = graph_driver.build_hyper_model(hyper, widths, device, generator)
            optimizer = hyper.make_optimizer()
        else:
            model = build_model(widths, device, generator)
            optimizer = functools.partial(torch.optim.Adam, lr=LEARNING_RATE)
        trainer = Trainer(loss_fn(model), optimizer)
        state = trainer.init_state(model.parameters())
        t0 = time.perf_counter()
        hist = {"loss": []}
        for epoch in range(epochs):
            state, metrics = trainer.step(state, train_batch)
            if epoch % 10 == 9:
                hist["loss"].append(float(metrics["loss"]))
        with torch.no_grad():
            out = model(test_batch)
            val_mae = float(masked_graph_mae(out["output"], test_batch.globals["graph_labels"],
                                             test_batch.globals["graph_mask"]))
        hist["val_mae"] = [val_mae]
        hist["val_node_auc"] = [node_auc(out, test_batch, test)]
        times.append(time.perf_counter() - t0)
        histories.append(hist)
    if args.plots:
        from gcnn_keras_tpu_torch.utils.plots import plot_train_test_loss
        plot_train_test_loss(histories, loss_name="loss", val_loss_name="val_mae",
                             model_name=args.model, dataset_name=args.dataset,
                             filepath="results/vgd", file_name=f"{args.model}_loss.png")
    score = save_history_score(histories, f"results/vgd/{args.model}_score.yaml",
                               model_name=args.model, dataset_name=args.dataset,
                               seed=args.seed, time_list=times)
    print(json.dumps({"val_mae": val_mae, "val_node_auc": hist["val_node_auc"][0]}))
    return score


if __name__ == "__main__":
    main()
