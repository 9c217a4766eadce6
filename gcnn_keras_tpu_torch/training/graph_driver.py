"""What the graph-learning drivers share (``scripts/train_tudataset.py``,
``train_moleculenet.py``, ``train_qm.py``, ``train_crystal.py``, and the
widths and ``--hyper`` helpers of ``train_citation.py`` and
``train_visual_graph_dataset.py``; the root ``training/`` drivers of the
same names in the JAX package keep these steps inline): their command
line, the model by registry name or ``--hyper`` config at the dataset's
input widths, and one fold's training through ``Trainer`` and
``fit_model``.

A torch module needs its input widths when it is built, so
``input_widths`` reads them from the dataset's graphs: float
``node_attributes`` give ``in_features``, float ``edge_attributes``
``edge_in_features`` (integer ones: None, embedded; none at all: 0), and
``graph_attributes`` ``graph_in_features``; a builder gets those its
``model_default`` names.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.common import mlp_width
from ..models.registry import get_model_class
from ..utils.wandb_wizard import finish_wandb, init_wandb
from .fit import fit_model
from .trainer import Trainer

# the drivers' GIN, at the width they train it (the others at their defaults)
GIN_DRIVER_KW = dict(depth=3, gin_mlp={"units": [64, 64], "activation": ["relu", "linear"]},
                     last_mlp={"units": [64], "activation": ["relu"]})
LEARNING_RATE = 1e-3  # optax.adam(1e-3) in the JAX drivers


def driver_parser(description: str, dataset_help: Optional[str] = None
                  ) -> argparse.ArgumentParser:
    """The JAX drivers' arguments (``--dataset`` where ``dataset_help`` is
    given), and ``--device`` (the CUDA card unless ``cpu``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--model", default="GIN")
    if dataset_help is not None:
        ap.add_argument("--dataset", default=None, help=dataset_help)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--folds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="kept for the JAX driver's command line; eager PyTorch "
                         "runs the steps one by one")
    ap.add_argument("--early-stopping", type=int, default=0,
                    help="EarlyStopping patience (0 = off); restores the best weights")
    ap.add_argument("--use-wandb", action="store_true")
    ap.add_argument("--plots", dest="plots", action="store_true", default=True)
    ap.add_argument("--no-plots", dest="plots", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return ap


def input_widths(graphs: Sequence[dict]) -> Dict[str, Optional[int]]:
    """The build widths of the graphs' inputs (module docstring)."""
    g = graphs[0]
    widths: Dict[str, Optional[int]] = {}
    x = g.get("node_attributes")
    if x is not None and (np.asarray(x).dtype.kind == "f" or np.asarray(x).ndim != 1):
        widths["in_features"] = int(np.asarray(x).shape[-1])
    e = g.get("edge_attributes")
    if e is None:
        widths["edge_in_features"] = 0
    elif np.asarray(e).dtype.kind == "f" or np.asarray(e).ndim != 1:
        widths["edge_in_features"] = int(np.asarray(e).shape[-1])
    else:
        widths["edge_in_features"] = None
    u = g.get("graph_attributes")
    if u is not None:
        widths["graph_in_features"] = int(np.asarray(u).reshape(-1).shape[0])
    return widths


def widths_for(builder: Callable, widths: Dict[str, Optional[int]]) -> Dict[str, Optional[int]]:
    """The entries of ``widths`` that ``builder``'s module's
    ``model_default`` names."""
    defaults = importlib.import_module(builder.__module__).model_default
    return {k: v for k, v in widths.items() if k in defaults}


def load_hyper(path: str, model: str):
    """``(HyperParameter of path's entry for model, its dataset)``; the
    dataset through ``data/serial.py``'s ``deserialize`` with the config's
    methods."""
    from ..data.serial import deserialize
    from .hyper import HyperParameter
    hyper = HyperParameter(path, model_name=model)
    return hyper, deserialize(hyper["data"]["dataset"])


def build_hyper_model(hyper, widths: Dict[str, Optional[int]], device=None,
                      generator: Optional[torch.Generator] = None):
    """``hyper``'s model at the config's widths and the data's ``widths``
    that its ``model_default`` names."""
    m = hyper["model"]
    builder = get_model_class(m.get("module_name", hyper.model_module or hyper.model_name),
                              m.get("class_name", hyper.model_class))
    return hyper.make_model(device=device, generator=generator, **widths_for(builder, widths))


def build_model(name: str, n_out: int, widths: Dict[str, Optional[int]],
                device=None, generator: Optional[torch.Generator] = None):
    """The drivers' model: GIN at ``GIN_DRIVER_KW`` with a linear output of
    ``n_out``, any other registry name at its defaults, its output MLP's
    last layer (MEGAN's last ``final_units``) made ``n_out`` linear units
    where the default has another width (the JAX drivers keep the default
    there, whose one output is no classifier of two classes); each with the
    ``widths`` its ``model_default`` names. DMPNN and CMPNN then raise
    ``ValueError`` at their first batch, which has no reverse edges, as the
    JAX drivers stop at their assert."""
    builder = get_model_class(name)
    defaults = importlib.import_module(builder.__module__).model_default
    kw = widths_for(builder, widths)
    if name == "GIN":
        kw.update(GIN_DRIVER_KW, output_mlp={"units": [n_out], "activation": ["linear"]})
    elif "output_mlp" not in defaults:
        if defaults["final_units"][-1] != n_out:
            kw.update(final_units=list(defaults["final_units"][:-1]) + [n_out],
                      final_activation="linear")
    elif mlp_width(defaults["output_mlp"]["units"]) != n_out:
        out = defaults["output_mlp"]
        units, acts = list(out["units"]), list(out["activation"])
        kw["output_mlp"] = dict(out, units=units[:-1] + [n_out],
                                activation=acts[:-1] + ["linear"])
    return builder(device=device, generator=generator, **kw)


def graph_mae_loss(model, **call_kw) -> Callable:
    """The masked MAE of the model's graph ``output`` (called with
    ``call_kw``) against ``graph_labels``, with no metrics."""
    from .losses import masked_graph_mae

    def fn(b):
        return masked_graph_mae(model(b, **call_kw)["output"], b.globals["graph_labels"],
                                b.globals["graph_mask"]), {}
    return fn


def holdout_folds(n: int, folds: int, seed: int):
    """``(test, train)`` index arrays of each of ``folds`` folds (at least
    one) of a seeded permutation of ``range(n)``, as the JAX crystal and
    visual-graph drivers cut it: a fifth of it as the test set with one
    fold, a k-th with more; the training indices sorted."""
    idx = np.random.RandomState(seed).permutation(n)
    k = max(folds, 1)
    size = max(n // (5 if k == 1 else k), 1)
    return [(idx[f * size:(f + 1) * size], np.setdiff1d(idx, idx[f * size:(f + 1) * size]))
            for f in range(k)]


def train_fold(model, loss_fn: Callable, loader, eval_fn: Callable, args, fold: int,
               run_name: str, optimizer: Optional[Callable] = None):
    """One fold: ``optimizer`` (Adam at ``LEARNING_RATE`` if None) over the
    model's parameters, ``fit_model`` for ``args.epochs`` with the driver's
    early stopping and wandb run; returns the history and the fold's
    seconds."""
    trainer = Trainer(loss_fn, optimizer or functools.partial(torch.optim.Adam,
                                                              lr=LEARNING_RATE))
    state = trainer.init_state(model.parameters())
    if args.use_wandb:
        init_wandb("gcnn_keras_tpu", name=f"{run_name}_fold{fold}", config=vars(args))
    t0 = time.perf_counter()
    state, hist = fit_model(trainer, state, loader, eval_fn, args.epochs,
                            steps_per_dispatch=args.steps_per_dispatch,
                            early_stopping=args.early_stopping, fold=fold, verbose_every=0)
    seconds = time.perf_counter() - t0
    if args.use_wandb:
        finish_wandb()
    return hist, seconds


def evaluation(fn: Callable) -> Callable:
    """``fn`` under ``torch.no_grad``, the model's parameters as its
    argument ignored (they live in the model)."""
    def eval_fn(params: Any) -> Dict[str, float]:
        with torch.no_grad():
            return fn()
    return eval_fn


def plot_fold(model, test_batch, model_name: str, dataset_name: str, filepath: str,
              **call_kw) -> None:
    """The fold's predicted-against-true graph labels as
    ``<filepath>/predict.png`` (needs matplotlib)."""
    from ..utils.plots import plot_predict_true
    with torch.no_grad():
        out = model(test_batch, **call_kw)["output"].cpu().numpy().reshape(-1)
    gm = test_batch.globals["graph_mask"].cpu().numpy().astype(bool).reshape(-1)
    plot_predict_true(out[gm], test_batch.globals["graph_labels"].cpu().numpy().reshape(-1)[gm],
                      model_name=model_name, dataset_name=dataset_name,
                      target_names="graph_labels", filepath=filepath, file_name="predict.png")
