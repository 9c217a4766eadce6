"""The training engine of the fork's scripts; counterpart of
``gcnn_keras_tpu/training/force_script.py``.

``run_force_training(build_model, cfg)`` loads the dataset (a pickle, or
``SyntheticMDDataset`` from the seed), splits it into ``ensemble_size``
folds (``kfold_swapped_val``) and, for each fold: fits an
``EnergyForceExtensiveLabelScaler`` on the training split and scales the
splits; builds the model from ``torch.Generator().manual_seed(seed +
fold)``; trains it with Adam under a linear learning-rate decay through
``Trainer`` and ``fit_model``, on batches of ``GraphBatchLoader`` and
validating on the whole validation split in one batch; writes a
checkpoint, ``scaler.json`` and the evaluator's artifacts into
``<model_prefix>_<fold>``. Then it writes the score file,
``results/<model_prefix>_score.yaml``, whose ``execute_time`` is each
fold's CPU time (``time.process_time``, as in the JAX package).

Everything runs on ``cfg["device"]``: the CUDA card unless it is
``"cpu"``. ``n_devices > 1`` trains data-parallel on that many ranks, which
the engine starts itself (one a card, or gloo ranks on the CPU under
``"cpu"``; more ranks than cards raise ``ValueError``): each rank takes
its batch of each group of ``n_devices`` consecutive batches of the shared
loader, as the JAX package's devices do, and the gradients are averaged.
``distributed`` joins the process group a launcher set up
(``parallel/distributed.py``), each rank training on its host's shard of
the dataset (``host_shard_indices``) with the gradients averaged over the
group. Only rank 0 writes checkpoints, scalers, artifacts and scores, and
prints; the other ranks return None.
"""
from __future__ import annotations

import functools
import importlib
import json
import os
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..data.dataset import MemoryGraphDataset
from ..data.loader import GraphBatchLoader
from ..data.scalers import EnergyForceExtensiveLabelScaler
from ..utils.checkpoint import save_checkpoint
from ..utils.data_splitter import kfold_swapped_val
from ..utils.devices import resolve_device
from ..utils.wandb_wizard import finish_wandb, init_wandb
from .evaluation import evaluate_model
from .fit import fit_model
from .history import save_history_score
from .losses import masked_graph_mae, masked_node_mae
from .schedules import linear_schedule
from .trainer import Trainer

DEFAULTS = {
    "data_path": None,
    "model_prefix": "model_energy_force",
    "charge_loss_weight": 0.0,
    "energy_loss_weight": 1.0,
    "force_loss_weight": 200.0,
    "epochs": 100,
    "batch_size": 16,
    "learning_rate_start": 1e-3,
    "learning_rate_stop": 1e-5,
    "ensemble_size": 3,
    "seed": 42,
    "cutoff": 6.0,
    "max_neighbours": 15,
    "need_angles": False,
    "need_esp": False,
    "synthetic_frames": 64,
    "use_esp_coupling": False,
    "outputs": ("energy", "force"),
    # data parallelism: ranks started by the engine, or a launcher's group
    "n_devices": 0,
    "distributed": False,
    # the JAX package's K steps a compiled dispatch; eager PyTorch runs
    # them one by one (Trainer.fit_epoch)
    "steps_per_dispatch": 1,
    # EarlyStopping patience (0 = off; the best weights come back when it
    # stops), an optional wandb run, the loss-curve and predicted-against-
    # true PNGs
    "early_stopping": 0,
    "use_wandb": False,
    "wandb_project": "gcnn_keras_tpu",
    "make_plots": True,
}


def script_config(mod, **overrides) -> Dict:
    """The engine's ``DEFAULTS`` under a script module's ``CONFIG``, then
    the ``overrides`` that are not None."""
    cfg = dict(DEFAULTS)
    cfg.update(mod.CONFIG)
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    return cfg


def merge_config(cfg: Dict, conf=None, data_path=None) -> Dict:
    """A copy of ``cfg`` updated with ``conf`` (a dict, or the path of a
    JSON file), then with ``data_path`` if given."""
    cfg = dict(cfg)
    if isinstance(conf, str):
        with open(conf) as f:
            conf = json.load(f)
    cfg.update(conf or {})
    if data_path:
        cfg["data_path"] = data_path
    return cfg


def script_module(name: str):
    """The module ``gcnn_keras_tpu_torch.scripts.<name>``."""
    return importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")


def load_config(mod, data_path=None, conf=None) -> Dict:
    """``script_config(mod)`` under ``conf`` and ``data_path``, as
    ``merge_config`` applies them."""
    return merge_config(script_config(mod), conf, data_path)


def load_script_dataset(mod, cfg: Dict) -> MemoryGraphDataset:
    """A script's dataset: its own ``load_dataset``, else
    ``load_force_dataset`` under the engine's ``DEFAULTS``."""
    if hasattr(mod, "load_dataset"):
        return mod.load_dataset(cfg)
    return load_force_dataset({**DEFAULTS, **cfg})


def normalized_loss_weights(cfg: Dict) -> Dict[str, float]:
    """The charge, energy and force loss weights, each divided by the sum
    of all three."""
    w = {"charge": cfg["charge_loss_weight"],
         "energy": cfg["energy_loss_weight"],
         "force": cfg["force_loss_weight"]}
    wsum = sum(w.values())
    return {k: v / max(wsum, 1e-9) for k, v in w.items()}


def load_force_dataset(cfg: Dict) -> MemoryGraphDataset:
    """``cfg["data_path"]``'s pickle, neighbour lists added where missing;
    else ``SyntheticMDDataset(synthetic_frames, seed)`` with, under
    ``need_esp``, random charges, ESPs and their gradients from the seed.
    ``edge_indices`` are the ``set_range`` lists (``cutoff``,
    ``max_neighbours``), with angles under ``need_angles``."""
    if cfg.get("data_path"):
        ds = MemoryGraphDataset().load(cfg["data_path"])
        if "range_indices" not in ds[0]:
            ds.map_list("set_range", max_distance=cfg["cutoff"],
                        max_neighbours=cfg["max_neighbours"])
            if cfg["need_angles"]:
                ds.map_list("set_angle")
        for g in ds:
            g.setdefault("edge_indices", g.get("range_indices"))
        return ds
    from ..data.datasets.synthetic import SyntheticMDDataset
    ds = SyntheticMDDataset(num_frames=cfg["synthetic_frames"], seed=cfg["seed"])
    rs = np.random.RandomState(cfg["seed"])
    for g in ds:
        n = len(g["node_number"])
        if cfg["need_esp"]:
            g["charge"] = (rs.randn(n) * 0.1).astype(np.float32)
            g["esp"] = (rs.randn(n) * 0.01).astype(np.float32)
            g["esp_grad"] = (rs.randn(n, 3) * 0.01).astype(np.float32)
            g["total_charge"] = np.array([g["charge"].sum()], dtype=np.float32)
    ds.map_list("set_range", max_distance=cfg["cutoff"], max_neighbours=cfg["max_neighbours"])
    if cfg["need_angles"]:
        ds.map_list("set_angle")
    for g in ds:
        g["edge_indices"] = g["range_indices"]
    return ds


def force_loss_fn(fmodel, w: Dict[str, float]) -> Callable:
    """The engine's loss on a batch: the sum of ``w[k]`` times the MAE of
    each output k with a weight above 0 (energy per graph; forces and
    charges per atom, charges only where model and batch have them), the
    forces taken with ``create_graph=True``. Returns ``(loss, metrics)``."""
    def loss_fn(b):
        out = fmodel.apply(b, create_graph=True)
        metrics = {}
        loss = 0.0
        if w["energy"] > 0:
            le = masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
            loss += w["energy"] * le
            metrics["energy_mae"] = le
        if w["force"] > 0 and "force" in out:
            lf = masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
            loss += w["force"] * lf
            metrics["force_mae"] = lf
        if w["charge"] > 0 and "charge" in out and "charge" in b.nodes:
            lq = masked_node_mae(out["charge"], b.nodes["charge"], b.node_mask)
            loss += w["charge"] * lq
            metrics["charge_mae"] = lq
        return loss, {k: v.detach() for k, v in metrics.items()}
    return loss_fn


def validation_fn(fmodel, w: Dict[str, float], val_batch) -> Callable:
    """The engine's validation on one batch of the whole split:
    ``val_energy_mae`` always, ``val_force_mae`` and ``val_charge_mae`` as
    the loss has them, and ``val_loss``, their weighted sum."""
    def eval_fn(params):
        vout = fmodel.apply(val_batch)
        out = {"val_energy_mae": masked_graph_mae(
            vout["energy"], val_batch.globals["energy"], val_batch.globals["graph_mask"]).item()}
        vloss = w["energy"] * out["val_energy_mae"]
        if "force" in vout and w["force"] > 0:
            out["val_force_mae"] = masked_node_mae(
                vout["force"], val_batch.nodes["force"], val_batch.node_mask).item()
            vloss += w["force"] * out["val_force_mae"]
        if w["charge"] > 0 and "charge" in vout and "charge" in val_batch.nodes:
            out["val_charge_mae"] = masked_node_mae(
                vout["charge"], val_batch.nodes["charge"], val_batch.node_mask).item()
            vloss += w["charge"] * out["val_charge_mae"]
        out["val_loss"] = vloss
        return out
    return eval_fn


def train_folds(build_model: Callable, cfg: Dict, ds, device: torch.device,
                global_keys: Sequence[str], *, evaluate_all_splits: bool,
                model_name: str, dataset_name: str, loss_file: str,
                score_file: str, mesh=None) -> Dict:
    """The fold loop of ``run_force_training`` on a loaded ``ds``; the
    evaluator takes the test split, or with ``evaluate_all_splits`` every
    split (``force_hdnnp4th``'s own loop). ``mesh``: train data-parallel
    over its ranks, rank 0 alone writing. Returns the score (None on the
    other ranks)."""
    from ..parallel.data_parallel import dp_batch_iterator
    writer = mesh is None or mesh.rank == 0
    w = normalized_loss_weights(cfg)
    global_keys = tuple(global_keys)
    histories, times = [], []
    for fold, (tr, va, te) in enumerate(
            kfold_swapped_val(len(ds), k=cfg["ensemble_size"], seed=cfg["seed"])):
        train, val, test = ds[tr], ds[va], ds[te]
        scaler = EnergyForceExtensiveLabelScaler()
        scaler.fit_dataset(train)
        for split in (train, val, test):
            scaler.transform_dataset(split)

        fmodel = build_model(cfg, device=device,
                             generator=torch.Generator().manual_seed(cfg["seed"] + fold))
        # seed + fold + 1: the JAX engine draws one batch to initialise its
        # params, which takes its loader's epoch 0, so its training epoch e
        # shuffles with RandomState(seed + fold + 1 + e)
        loader = GraphBatchLoader(list(train), cfg["batch_size"], shuffle=True,
                                  seed=cfg["seed"] + fold + 1, global_keys=global_keys,
                                  device=device, **train.batch_shape_hint(cfg["batch_size"]))
        steps = cfg["epochs"] * max(len(loader), 1)
        trainer = Trainer(force_loss_fn(fmodel, w),
                          functools.partial(torch.optim.Adam, lr=cfg["learning_rate_start"]),
                          mesh=mesh, schedule=linear_schedule(cfg["learning_rate_start"],
                                                              cfg["learning_rate_stop"], steps))
        state = trainer.init_state(fmodel.energy_model.parameters())
        eval_fn = validation_fn(fmodel, w, val.to_batch(global_keys=global_keys,
                                                        device=device))

        if cfg["use_wandb"] and writer:
            init_wandb(cfg["wandb_project"], name=f"{cfg['model_prefix']}_fold{fold}",
                       config=cfg)
        t0 = time.process_time()
        print(f"fold {fold}: training {cfg['epochs']} epochs of {len(loader)} steps "
              f"on {device}...", flush=True)
        batches = loader if mesh is None or mesh.size == 1 \
            else (lambda: dp_batch_iterator(loader, mesh))
        state, hist = fit_model(
            trainer, state, batches, eval_fn, cfg["epochs"],
            steps_per_dispatch=cfg.get("steps_per_dispatch", 1),
            early_stopping=cfg.get("early_stopping", 0), fold=fold)
        times.append(time.process_time() - t0)
        if cfg["use_wandb"] and writer:
            finish_wandb()
        if "loss" not in hist:
            raise RuntimeError("epoch produced no training steps: the loader must yield "
                               "at least one batch per epoch, with n_devices > 1 at least "
                               "n_devices (raise synthetic_frames or lower batch_size)")
        histories.append(hist)
        if not writer:
            continue
        outdir = f"{cfg['model_prefix']}_{fold}"
        save_checkpoint(outdir, fmodel.energy_model, state.optimizer, step=cfg["epochs"])
        scaler.save(os.path.join(outdir, "scaler.json"))
        print(f"fold {fold}: loss={hist['loss'][-1]:.4f} -> {outdir}", flush=True)

        # the splits' errors and the test split's artifacts, in raw units
        if evaluate_all_splits:
            eval_ds = MemoryGraphDataset(graphs=list(train) + list(val) + list(test))
            indices = (np.arange(len(train)), len(train) + np.arange(len(val)),
                       len(train) + len(val) + np.arange(len(test)))
        else:
            eval_ds = MemoryGraphDataset(graphs=list(test))
            empty = np.array([], np.int64)
            indices = (empty, empty, np.arange(len(test)))
        evaluate_model(eval_ds, fmodel, indices, scaler=scaler, output_dir=outdir,
                       dataset_name="force", model_name=model_name,
                       global_keys=global_keys, make_plots=cfg["make_plots"])

    if not writer:
        return None
    if cfg["make_plots"]:
        from ..utils.plots import plot_train_test_loss
        plot_train_test_loss(histories, loss_name="loss", val_loss_name="val_loss",
                             model_name=model_name, dataset_name="force",
                             filepath="results", file_name=loss_file)
    return save_history_score(histories, score_file, model_name=model_name,
                              dataset_name=dataset_name, seed=cfg["seed"], time_list=times)


def run_force_training(build_model: Callable, cfg: Dict) -> Dict:
    """Train ``build_model(cfg, device=..., generator=...)`` (an
    ``EnergyForceModel``) as the module docstring says; ``cfg`` goes over
    ``DEFAULTS``. Returns the score."""
    from ..parallel.launch import run_on_ranks
    cfg = {**DEFAULTS, **cfg}
    return run_on_ranks(_run_force_training, build_model, cfg, n_devices=cfg["n_devices"],
                        distributed=cfg["distributed"], device=cfg.get("device"))


def _run_force_training(mesh, build_model: Callable, cfg: Dict) -> Dict:
    device = mesh.device if mesh is not None else resolve_device(cfg.get("device"))
    ds = load_force_dataset(cfg)
    if cfg["distributed"]:
        from ..parallel.distributed import host_shard_indices
        ds = ds[host_shard_indices(len(ds), seed=cfg["seed"])]
    global_keys = ("energy", "total_charge") if cfg["need_esp"] else ("energy",)
    prefix = cfg["model_prefix"]
    return train_folds(build_model, cfg, ds, device, global_keys, evaluate_all_splits=False,
                       model_name=prefix, dataset_name=cfg.get("data_path") or "synthetic",
                       loss_file=f"{prefix}_loss.png", score_file=f"results/{prefix}_score.yaml",
                       mesh=mesh)


def parse_config_cli(defaults: Dict) -> Dict:
    """``defaults`` with the command line's overrides: ``--conf`` (a JSON
    file), ``--epochs``, ``--data-path``, ``--n-devices``,
    ``--distributed`` and ``--device`` (``cpu`` to run without the card,
    the counterpart of ``JAX_PLATFORMS=cpu``)."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--conf", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--n-devices", type=int, default=None,
                    help="data-parallel over N ranks the script starts (one a card, or "
                         "gloo ranks under --device cpu)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group a launcher set up (torchrun's or the "
                         "JAX variables) and train data-parallel on per-host shards")
    ap.add_argument("--device", default=None,
                    help="the device to train on: the CUDA card unless 'cpu'")
    args = ap.parse_args()
    cfg = merge_config(defaults, args.conf, args.data_path)
    if args.epochs is not None:
        cfg["epochs"] = args.epochs
    if args.n_devices is not None:
        cfg["n_devices"] = args.n_devices
    if args.distributed:
        cfg["distributed"] = True
    if args.device:
        cfg["device"] = args.device
    return cfg
