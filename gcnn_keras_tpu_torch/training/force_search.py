"""The Hyperband-search scaffold of the fork's ``*_hyp_param_search.py``
scripts; counterpart of ``gcnn_keras_tpu/training/force_search.py``
(``parse_search_cli``, ``run_force_search``).

Each script supplies ``build_model(hp, cfg, device=None, generator=None)``
(an ``EnergyForceModel``) and a search space; this module owns the data
split (``RandomState(seed)``, a fifth of the frames for validation), the
extensive scaler fitted on the training part, the trial loop and the
Hyperband search.

A trial (``make_trial_fn``) builds the model from ``torch.Generator().
manual_seed(0)`` (the JAX package initialises from ``PRNGKey(0)``: the
same seed, not the same weights), trains it with Adam at
``hp["learning_rate"]`` on the port's ``GraphBatchLoader`` under the
normalized loss weights, and scores the whole validation split in one
batch. Everything runs on the CUDA card unless the device is ``"cpu"``.
"""
from __future__ import annotations

import argparse
import functools
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..data.loader import GraphBatchLoader
from ..data.scalers import EnergyForceExtensiveLabelScaler
from ..utils.devices import resolve_device
from .force_script import force_loss_fn, load_force_dataset, merge_config
from .hyper_search import HyperbandSearch, SearchSpace
from .losses import masked_graph_mae, masked_node_mae
from .trainer import Trainer


def parse_search_cli(defaults: Dict, directory: str, argv=None) -> argparse.Namespace:
    """``--trials`` (9), ``--max-epochs`` (30), ``--data-path``,
    ``--directory``; and the port's ``--min-epochs`` (the JAX package's
    fixed 5 by default), ``--conf`` (a JSON file
    merged onto the script's config, as the training scripts take it) and
    ``--device`` (``cpu`` to run without the card)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=9)
    ap.add_argument("--max-epochs", type=int, default=30)
    ap.add_argument("--min-epochs", type=int, default=5)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--directory", default=directory)
    ap.add_argument("--conf", default=None, help="JSON config override")
    ap.add_argument("--device", default=None,
                    help="the device to train on: the CUDA card unless 'cpu'")
    return ap.parse_args(argv)


def split_search_data(ds, seed: int):
    """``(train, val)``: a ``RandomState(seed)`` permutation, its first
    fifth (at least one frame) for validation; both scaled in place by a
    scaler fitted on ``train``."""
    rs = np.random.RandomState(seed)
    idx = rs.permutation(len(ds))
    n_val = max(len(ds) // 5, 1)
    val, train = ds[idx[:n_val]], ds[idx[n_val:]]
    scaler = EnergyForceExtensiveLabelScaler()
    scaler.fit_dataset(train)
    scaler.transform_dataset(train)
    scaler.transform_dataset(val)
    return train, val


def search_loss_weights(cfg0: Dict, hp: Dict) -> Dict[str, float]:
    """The trial's loss weights: the config's energy and charge weights and
    ``hp``'s force weight (else the config's), divided by their sum."""
    we = cfg0.get("energy_loss_weight", 1.0)
    wf = hp.get("force_loss_weight", cfg0.get("force_loss_weight", 0.0))
    wq = cfg0.get("charge_loss_weight", 0.0)
    norm = max(we + wf + wq, 1e-8)
    return {"energy": we / norm, "force": wf / norm, "charge": wq / norm}


def validation_metrics(fmodel, vb, keys: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """``val_force_mae`` and ``val_charge_mae`` where the model and the
    batch have them, and ``val_energy_mae``; only ``keys`` if given."""
    vout = fmodel.apply(vb)
    metrics = {}
    if "force" in vout and "force" in vb.nodes:
        metrics["val_force_mae"] = masked_node_mae(vout["force"], vb.nodes["force"],
                                                   vb.node_mask).item()
    if "charge" in vout and "charge" in vb.nodes:
        metrics["val_charge_mae"] = masked_node_mae(vout["charge"], vb.nodes["charge"],
                                                    vb.node_mask).item()
    metrics["val_energy_mae"] = masked_graph_mae(vout["energy"], vb.globals["energy"],
                                                 vb.globals["graph_mask"]).item()
    return metrics if keys is None else {k: metrics[k] for k in keys}


def make_trial_fn(build_model: Callable, cfg0: Dict, train, val,
                  global_keys: Sequence[str], device, *,
                  loss_weights: Callable[[Dict, Dict], Dict[str, float]] = search_loss_weights,
                  metric_keys: Optional[Sequence[str]] = None,
                  init: Optional[Callable] = None,
                  optimizer: Optional[Callable] = None) -> Callable:
    """``trial_fn(hp, epochs) -> metrics``: one model trained ``epochs``
    epochs on ``train`` in batches of ``cfg0["batch_size"]``, then scored
    on ``val``. ``init(fmodel)`` may set the initial weights in place and
    ``optimizer(hp)`` give the optimizer factory (Adam at
    ``hp["learning_rate"]``, 1e-3 if absent, by default)."""
    device = resolve_device(device)
    global_keys = tuple(global_keys)
    batch_size = cfg0["batch_size"]
    hint = train.batch_shape_hint(batch_size)

    def trial_fn(hp, epochs):
        fmodel = build_model(hp, cfg0, device=device,
                             generator=torch.Generator().manual_seed(0))
        if init is not None:
            init(fmodel)
        # seed 1: the JAX trial draws one batch to initialise its params,
        # which takes its loader's epoch 0 (RandomState(0))
        loader = GraphBatchLoader(list(train), batch_size, shuffle=True, seed=1,
                                  global_keys=global_keys, device=device, **hint)
        make_opt = optimizer(hp) if optimizer is not None else functools.partial(
            torch.optim.Adam, lr=hp.get("learning_rate", 1e-3))
        trainer = Trainer(force_loss_fn(fmodel, loss_weights(cfg0, hp)), make_opt)
        state = trainer.init_state(fmodel.energy_model.parameters())
        for _ in range(epochs):
            for b in loader:
                state, _ = trainer.step(state, b)
        vb = val.to_batch(global_keys=global_keys, device=device)
        return validation_metrics(fmodel, vb, metric_keys)

    return trial_fn


def search_config(cfg0: Dict, args: Optional[argparse.Namespace]) -> Dict:
    """``cfg0`` with the command line's ``--conf`` and ``--data-path``."""
    if args is None:
        return dict(cfg0)
    return merge_config(cfg0, args.conf, args.data_path)


def run_force_search(cfg0: Dict, space_spec: Dict, build_model: Callable,
                     objective: str = "val_force_mae",
                     args: Optional[argparse.Namespace] = None,
                     load_dataset: Optional[Callable] = None) -> Dict:
    """Run a Hyperband search over ``space_spec`` on the device of
    ``args.device`` (else ``cfg0["device"]``); returns the best trial."""
    cfg0 = search_config(cfg0, args)
    device = resolve_device(args.device if args is not None else cfg0.get("device"))
    ds = (load_dataset or load_force_dataset)(cfg0)
    train, val = split_search_data(ds, cfg0.get("seed", 0))
    global_keys = ("energy", "total_charge") if "total_charge" in train[0] else ("energy",)
    trial_fn = make_trial_fn(build_model, cfg0, train, val, global_keys, device)
    return run_search(space_spec, objective, trial_fn, args)


def run_search(space_spec: Dict, objective: str, trial_fn: Callable,
               args: Optional[argparse.Namespace]) -> Dict:
    """``HyperbandSearch`` over ``space_spec`` with the command line's
    trials, epochs and directory; prints and returns the best trial."""
    search = HyperbandSearch(
        SearchSpace(space_spec), objective=objective,
        num_trials=args.trials if args else 9,
        max_epochs=args.max_epochs if args else 30,
        min_epochs=args.min_epochs if args else 5,
        directory=args.directory if args else "hyp_search")
    best = search.run(trial_fn)
    print("best:", best["hparams"], best["score"])
    return best
