"""Crystal property regression; counterpart of the root
``training/train_crystal.py``.

    python -m gcnn_keras_tpu_torch.scripts.train_crystal [--device cpu]
        [--model Schnet] [--epochs 40] [--batch-size 16] [--structures 64]
        [--seed 42] [--folds 1] [--early-stopping N] [--use-wandb] [--no-plots]

The data are the JAX driver's ``synthetic_crystals``: random periodic
cells of 2-6 atoms, their radius graphs (4 A, at most 12 neighbours, with
lattice images) from ``crystal/graph_builder.py``, and a synthetic
cohesive-energy label. Of ``--folds`` folds of a seeded permutation (a
fifth of the structures as the test set with one fold, a k-th with more),
each builds the model's ``make_crystal_model`` (``--model``, a registry
name: SchNet and CGCNN at the driver's widths, any other at its defaults;
weights drawn from the seed plus the fold) and trains it with Adam 1e-3 on
the labels' masked MAE through ``Trainer`` and ``fit_model``, validating
on the test structures (``val_loss``, ``val_mae``). The score goes to
``results/crystal/<model>_score.yaml``; with ``--plots`` (matplotlib) the
loss curves and each fold's predicted-against-true scatter beside it.
``--steps-per-dispatch`` changes nothing (``Trainer.fit_epoch``).
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from gcnn_keras_tpu_torch.training import graph_driver

GLOBAL_KEYS = ("graph_labels",)
# the driver's crystal SchNet and CGCNN (every other model at its defaults)
DRIVER_KW = {
    "Schnet": dict(depth=3, interaction_args={"units": 64},
                   gauss_args={"bins": 20, "distance_max": 4.0},
                   last_mlp={"units": [64, 32], "activation": ["shifted_softplus"] * 2},
                   output_mlp={"units": [16, 1], "activation": ["shifted_softplus", "linear"]}),
    "CGCNN": dict(depth=3, conv_layer_args={"units": 64}),
}


def synthetic_crystals(n: int = 64, seed: int = 0) -> List[dict]:
    """Random periodic structures with a synthetic cohesive-energy label,
    draw for draw the JAX driver's."""
    from gcnn_keras_tpu_torch.crystal.graph_builder import add_radius_bonds, structure_to_graph
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        na = rs.randint(2, 7)
        a = 3.5 + rs.rand() * 2
        lattice = np.diag([a, a, a]) + rs.randn(3, 3) * 0.1
        frac = rs.rand(na, 3)
        z = rs.choice([3, 8, 13, 14, 26], size=na)
        g = structure_to_graph({"frac_coords": frac, "lattice": lattice, "atomic_numbers": z})
        g = add_radius_bonds(g, radius=4.0, max_neighbours=12)
        d = np.asarray(g["range_attributes"]).reshape(-1)
        g["graph_labels"] = np.array([float(np.exp(-d).sum() / na + 0.05 * z.mean())],
                                     dtype=np.float32)
        g["edge_indices"] = g["range_indices"]
        out.append(g)
    return out


def build_model(name: str, widths, device=None, generator=None):
    """``make_crystal_model`` of ``name`` at ``DRIVER_KW``'s widths (any other
    at its defaults), with the data's ``widths``."""
    from gcnn_keras_tpu_torch.models.registry import get_model_class
    builder = get_model_class(name, "make_crystal_model")
    return builder(device=device, generator=generator, **DRIVER_KW.get(name, {}),
                   **graph_driver.widths_for(builder, widths))


def loss_fn(model):
    """The masked MAE of the graph output against the labels, the model
    called with ``train=False`` as the JAX driver calls it."""
    return graph_driver.graph_mae_loss(model, train=False)


def main(argv: Optional[List[str]] = None) -> dict:
    from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
    from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
    from gcnn_keras_tpu_torch.training.history import save_history_score
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    ap = graph_driver.driver_parser(__doc__.splitlines()[0])
    ap.set_defaults(model="Schnet", epochs=40, batch_size=16, folds=1)
    ap.add_argument("--structures", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ds = MemoryGraphDataset(graphs=synthetic_crystals(args.structures, args.seed))
    widths = graph_driver.input_widths(ds)
    histories, times = [], []
    for fold, (test_idx, train_idx) in enumerate(
            graph_driver.holdout_folds(len(ds), args.folds, args.seed)):
        train, test = ds[train_idx], ds[test_idx]
        model = build_model(args.model, widths, dev,
                            torch.Generator().manual_seed(args.seed + fold))
        # the JAX driver's first batch initialises its model, so its epochs
        # train on the loader's shuffles from epoch 1 on: seed + fold + 1 here
        loader = GraphBatchLoader(list(train), args.batch_size, shuffle=True,
                                  seed=args.seed + fold + 1, global_keys=GLOBAL_KEYS,
                                  device=dev, **train.batch_shape_hint(args.batch_size))
        test_batch = test.to_batch(global_keys=GLOBAL_KEYS, device=dev)

        def val():
            vm = float(masked_graph_mae(model(test_batch, train=False)["output"],
                                        test_batch.globals["graph_labels"],
                                        test_batch.globals["graph_mask"]))
            return {"val_loss": vm, "val_mae": vm}
        hist, seconds = graph_driver.train_fold(model, loss_fn(model), loader,
                                                graph_driver.evaluation(val), args, fold,
                                                f"crystal_{args.model}")
        histories.append(hist)
        times.append(seconds)
        print(f"fold {fold}: val_mae={hist['val_mae'][-1]:.4f}", flush=True)
        if args.plots:
            graph_driver.plot_fold(model, test_batch, args.model, "SyntheticCrystal",
                                   f"results/crystal/{args.model}_fold{fold}", train=False)
    if args.plots:
        from gcnn_keras_tpu_torch.utils.plots import plot_train_test_loss
        plot_train_test_loss(histories, loss_name="loss", val_loss_name="val_loss",
                             model_name=args.model, dataset_name="SyntheticCrystal",
                             filepath="results/crystal", file_name=f"{args.model}_loss.png")
    score = save_history_score(histories, f"results/crystal/{args.model}_score.yaml",
                               model_name=args.model, dataset_name="SyntheticCrystal",
                               seed=args.seed, time_list=times)
    print(json.dumps({"val_mae_mean": score.get("val_mae_mean")}))
    return score


if __name__ == "__main__":
    main()
