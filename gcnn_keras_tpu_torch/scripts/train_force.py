"""Energy and force training of any registry model; counterpart of the
root ``training/train_force.py``.

    python -m gcnn_keras_tpu_torch.scripts.train_force [--device cpu]
        [--model Schnet] [--hyper CONFIG] [--epochs 50] [--batch-size 16]
        [--frames 128] [--energy-weight 1] [--force-weight 50] [--seed 42]
        [--folds 1] [--checkpoint-dir DIR] [--early-stopping N] [--use-wandb]
        [--no-plots]

The data are ``SyntheticMDDataset(num_frames=--frames, seed=--seed)``. Each
molecule's edges come from ``set_range(4.0, 15)``; MXMNet takes its
multiplex graphs instead: a local bond graph (``set_range(2.0, 12)``) as
its edges, a range graph (``set_range(4.0, 25)``) as the second edge set,
and the pairings ``jk`` and ``ik`` (with self pairs) of
``set_angle_pairs_kgcnn``. No other model gets angle pairs, so DimeNet++
stops at its first batch (``ValueError``), as the JAX driver stops at its
assert. Of ``--folds`` folds of the seeded permutation (each a fifth of
the frames, or a k-th for more than 5), each fits an
``EnergyForceExtensiveLabelScaler`` on its training frames, builds the
model (``--model``, a registry name: SchNet and PAiNN at the driver's
widths, any other at its defaults; weights from the seed plus the fold)
and trains ``EnergyForceModel`` on ``energy_weight`` x energy MAE +
``force_weight`` x force MAE with Adam under a warm-up cosine schedule
(peak 1e-3, warm-up a tenth of the steps, at most 50), validating on its
test frames. The score goes to ``results/force/<model>_score.yaml``, with
``--plots`` (matplotlib) the loss curves and each fold's predicted-against-
true scatters beside it; ``--checkpoint-dir`` keeps the last fold's weights,
optimizer state and scaler.

With ``--hyper`` (a config of ``training/hyper``, e.g.
``training/hyper/hyper_synthetic_md.py``) the entry ``--model`` of the
config (``HyperParameter``) gives the dataset (``data/serial.py``
``deserialize``, its methods run), the model at the config's widths and
the optimizer (``make_optimizer``, no schedule), as the JAX driver reads
them; the driver's own edges, folds, epochs, batch size and loss weights
still apply (the config's ``loss_weights`` are not read, in JAX either). Of
the library's datasets only the synthetic ones are ported: any other
raises ``ValueError`` ("the rest of the host side"), where the JAX driver
would download it.
``--n-devices`` above 1 and ``--distributed`` raise: the data-parallel step
is not ported. ``--steps-per-dispatch`` changes nothing (``Trainer.fit_epoch``).
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from typing import List, Optional

import numpy as np
import torch

from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.training.trainer import Trainer

GLOBAL_KEYS = ("energy",)
# the driver's SchNet and PAiNN (every other model at its defaults)
DRIVER_KW = {
    "Schnet": dict(depth=3, interaction_args={"units": 64},
                   gauss_args={"bins": 20, "distance_max": 5.0},
                   last_mlp={"units": [64, 32], "activation": ["shifted_softplus"] * 2},
                   output_mlp={"units": [16, 1], "activation": ["shifted_softplus", "linear"]}),
    "PAiNN": dict(depth=2, conv_args={"units": 64}, update_args={"units": 64},
                  input_embedding={"node": {"output_dim": 64}},
                  output_mlp={"units": [64, 1], "activation": ["swish", "linear"]}),
}
MXMNET_BATCH_KW = dict(angle_edge_index_key="angle_indices_1",
                       angle_edge_index_key_2="angle_indices_2",
                       second_edge_index_key="range_indices")


def parser() -> argparse.ArgumentParser:
    """The JAX driver's arguments, and ``--device`` (the CUDA card unless
    ``cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hyper", default=None)
    ap.add_argument("--model", default="Schnet")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--energy-weight", type=float, default=1.0)
    ap.add_argument("--force-weight", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--folds", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="kept for the JAX driver's command line; eager PyTorch runs "
                         "the steps one by one")
    ap.add_argument("--n-devices", type=int, default=None)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--early-stopping", type=int, default=0,
                    help="EarlyStopping patience (0 = off); restores the best weights")
    ap.add_argument("--use-wandb", action="store_true")
    ap.add_argument("--plots", dest="plots", action="store_true", default=True)
    ap.add_argument("--no-plots", dest="plots", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return ap


def refuse_unported(args) -> None:
    if (args.n_devices and args.n_devices > 1) or args.distributed:
        raise ValueError("--n-devices > 1 and --distributed need the data-parallel step, "
                         "which is not ported yet (ROADMAP.md, 'Parallel'); train on one "
                         "device")


def multiplex_graph(graph: dict) -> dict:
    """MXMNet's inputs of one graph: the local bond graph
    (``set_range(2.0, 12)``) as its edges, the range graph
    (``set_range(4.0, 25)``) as ``range_indices``, and the pairings ``jk``
    (``angle_indices_1``) and ``ik`` with self pairs (``angle_indices_2``)."""
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle_pairs_kgcnn, set_range
    g = set_range(graph, max_distance=2.0, max_neighbours=12)
    g["edge_indices"] = g.pop("range_indices")
    g = set_range(g, max_distance=4.0, max_neighbours=25)
    g = set_angle_pairs_kgcnn(g, range_indices="edge_indices", edge_pairing="jk",
                              out_key="angle_indices_1")
    return set_angle_pairs_kgcnn(g, range_indices="edge_indices", edge_pairing="ik",
                                 allow_self_edges=True, out_key="angle_indices_2")


def load_hyper(args):
    """The ``--hyper`` config's entry for ``--model``, or None."""
    if not args.hyper:
        return None
    from gcnn_keras_tpu_torch.training.hyper import HyperParameter
    return HyperParameter(args.hyper, model_name=args.model)


def load_dataset(args, hyper=None):
    """The frames with their edges (module docstring), and the batch
    keywords that read MXMNet's second edge set and pair lists; the frames
    of ``hyper``'s dataset where given."""
    if hyper is not None:
        from gcnn_keras_tpu_torch.data.serial import deserialize
        ds = deserialize(hyper["data"]["dataset"])
    else:
        from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticMDDataset
        ds = SyntheticMDDataset(num_frames=args.frames, seed=args.seed)
    if args.model == "MXMNet":
        return ds.map_list(multiplex_graph), dict(MXMNET_BATCH_KW)
    ds.map_list("set_range", max_distance=4.0, max_neighbours=15)
    for g in ds:
        g["edge_indices"] = g["range_indices"]
    return ds, {}


def fold_indices(n: int, folds: int, seed: int):
    """``(test, train)`` index arrays of each fold, as the JAX driver cuts
    its seeded permutation."""
    idx = np.random.RandomState(seed).permutation(n)
    k = max(folds, 1)
    size = max(n // max(k, 5), 1)
    return [(idx[f * size:(f + 1) * size], np.concatenate([idx[:f * size], idx[(f + 1) * size:]]))
            for f in range(k)]


def build_model(name: str, device, generator: torch.Generator,
                hyper=None) -> EnergyForceModel:
    """``EnergyForceModel`` of the registry's ``name`` at the driver's
    widths, or of ``hyper``'s model."""
    if hyper is not None:
        model = hyper.make_model(device=device, generator=generator)
    else:
        from gcnn_keras_tpu_torch.models.registry import get_model_class
        model = get_model_class(name)(device=device, generator=generator,
                                      **DRIVER_KW.get(name, {}))
    return EnergyForceModel(model, device=device)


def schedule_for(args):
    """The JAX driver's ``optax.warmup_cosine_decay_schedule(0, 1e-3, ...)``."""
    from gcnn_keras_tpu_torch.training.schedules import warmup_cosine_decay_schedule
    total = args.epochs * max(args.frames // args.batch_size, 1)
    warmup = min(50, max(total // 10, 1))
    return warmup_cosine_decay_schedule(0.0, 1e-3, warmup, max(total, warmup + 1))


def loss_fn(fmodel: EnergyForceModel, energy_weight: float, force_weight: float):
    """``energy_weight`` x the energies' MAE + ``force_weight`` x the forces'
    MAE, with both as metrics; the forces keep their graph."""
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae, masked_node_mae

    def fn(b):
        out = fmodel.apply(b, create_graph=True)
        e = masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
        f = masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
        return energy_weight * e + force_weight * f, {"energy_mae": e.detach(),
                                                      "force_mae": f.detach()}
    return fn


def optimizer_for(args, hyper=None):
    """``(optimizer factory, schedule)``: ``hyper``'s optimizer at its
    rate, else Adam under ``schedule_for(args)``."""
    if hyper is not None:
        return hyper.make_optimizer(), None
    return functools.partial(torch.optim.Adam, lr=1e-3), schedule_for(args)


def run_fold(args, ds, train_idx, test_idx, batch_kw, fold, device, hyper=None):
    """One fold: ``(history, seconds, EnergyForceModel, TrainState, scaler,
    test batch)``; ``hyper`` builds the model and optimizer."""
    from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
    from gcnn_keras_tpu_torch.data.scalers import EnergyForceExtensiveLabelScaler
    from gcnn_keras_tpu_torch.training.fit import fit_model
    from gcnn_keras_tpu_torch.training.losses import masked_graph_mae, masked_node_mae
    from gcnn_keras_tpu_torch.utils.wandb_wizard import finish_wandb, init_wandb
    train, test = ds[train_idx], ds[test_idx]
    scaler = EnergyForceExtensiveLabelScaler()
    scaler.fit_dataset(train)
    scaler.transform_dataset(train)
    scaler.transform_dataset(test)
    # the JAX driver's first batch initialises its model, so its epochs
    # train on the loader's shuffles from epoch 1 on: seed + fold + 1 here
    loader = GraphBatchLoader(list(train), args.batch_size, shuffle=True,
                              seed=args.seed + fold + 1, global_keys=GLOBAL_KEYS, device=device,
                              **train.batch_shape_hint(args.batch_size), **batch_kw)
    fmodel = build_model(args.model, device, torch.Generator().manual_seed(args.seed + fold),
                         hyper)
    optimizer, schedule = optimizer_for(args, hyper)
    trainer = Trainer(loss_fn(fmodel, args.energy_weight, args.force_weight), optimizer,
                      schedule=schedule)
    state = trainer.init_state(fmodel.energy_model.parameters())
    test_batch = test.to_batch(global_keys=GLOBAL_KEYS, device=device, **batch_kw)

    def eval_fn(params):
        out = fmodel.apply(test_batch)
        ve = float(masked_graph_mae(out["energy"].detach(), test_batch.globals["energy"],
                                    test_batch.globals["graph_mask"]))
        vf = float(masked_node_mae(out["force"], test_batch.nodes["force"],
                                   test_batch.node_mask))
        return {"val_loss": args.energy_weight * ve + args.force_weight * vf,
                "val_energy_mae": ve, "val_force_mae": vf}

    if args.use_wandb:
        init_wandb("gcnn_keras_tpu", name=f"{args.model}_fold{fold}", config=vars(args))
    t0 = time.perf_counter()
    state, hist = fit_model(trainer, state, loader, eval_fn, args.epochs,
                            steps_per_dispatch=args.steps_per_dispatch,
                            early_stopping=args.early_stopping, fold=fold)
    seconds = time.perf_counter() - t0
    if args.use_wandb:
        finish_wandb()
    if "loss" not in hist:
        raise RuntimeError("the epochs took no training step: the loader needs at least one "
                           "full batch (raise --frames or lower --batch-size)")
    return hist, seconds, fmodel, state, scaler, test_batch


def plot_fold(args, fmodel, test_batch, fold):
    """The fold's predicted-against-true energies and forces."""
    from gcnn_keras_tpu_torch.utils.plots import plot_predict_true
    out = fmodel.apply(test_batch)
    gm = test_batch.globals["graph_mask"].cpu().numpy().astype(bool).reshape(-1)
    nm = test_batch.node_mask.cpu().numpy().astype(bool)
    pdir = f"results/force/{args.model}_fold{fold}"
    for key, pred, true in (
            ("energy", out["energy"].detach().cpu().numpy().reshape(-1)[gm],
             test_batch.globals["energy"].cpu().numpy().reshape(-1)[gm]),
            ("force", out["force"].detach().cpu().numpy()[nm],
             test_batch.nodes["force"].cpu().numpy()[nm])):
        plot_predict_true(pred, true, model_name=args.model, dataset_name="SyntheticMD",
                          target_names=key, filepath=pdir, file_name=f"predict_{key}.png")


def main(argv: Optional[List[str]] = None) -> dict:
    from gcnn_keras_tpu_torch.training.history import save_history_score
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    args = parser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    hyper = load_hyper(args)
    ds, batch_kw = load_dataset(args, hyper)
    histories, times = [], []
    for fold, (test_idx, train_idx) in enumerate(fold_indices(len(ds), args.folds, args.seed)):
        hist, seconds, fmodel, state, scaler, test_batch = run_fold(
            args, ds, train_idx, test_idx, batch_kw, fold, device, hyper)
        histories.append(hist)
        times.append(seconds)
        if args.plots:
            plot_fold(args, fmodel, test_batch, fold)
    if args.checkpoint_dir:
        from gcnn_keras_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint_dir, fmodel.energy_model, state.optimizer,
                        step=args.epochs)
        scaler.save(f"{args.checkpoint_dir}/scaler.json")
    if args.plots:
        from gcnn_keras_tpu_torch.utils.plots import plot_train_test_loss
        plot_train_test_loss(histories, loss_name="loss", val_loss_name="val_loss",
                             model_name=args.model, dataset_name="SyntheticMD",
                             filepath="results/force", file_name=f"{args.model}_loss.png")
    scale = float(scaler.scale_[0])
    score = save_history_score(histories, f"results/force/{args.model}_score.yaml",
                               model_name=args.model, dataset_name="SyntheticMD",
                               seed=args.seed, time_list=times)
    vf = [h["val_force_mae"][-1] * scale for h in histories]
    ve = [h["val_energy_mae"][-1] * scale for h in histories]
    print(json.dumps({"val_force_mae_scaled": float(np.mean(vf)),
                      "val_force_mae_scaled_std": float(np.std(vf)),
                      "val_energy_mae_scaled": float(np.mean(ve)),
                      "val_energy_mae_scaled_std": float(np.std(ve)),
                      "folds": len(histories), "time_s": float(np.sum(times))}))
    return score


if __name__ == "__main__":
    main()
