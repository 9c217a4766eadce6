"""Transfer learning: reload a trained checkpoint, freeze the
representation and retrain the heads on new data; counterpart of the root
``transfer_learning.py``.

    python -m gcnn_keras_tpu_torch.scripts.transfer_learning --checkpoint DIR
        [--device cpu] [--script force_hdnnp4th] [--data-path P] [--epochs 20]
        [--trainable mlp_local output] [--out model_transfer] [--conf C.json]

A new scaler is fitted on the data; batches of 8, the loss E + 100 F
(unnormalized), Adam at 1e-4 on the trainable parameters only, so the
frozen ones stay bit for bit. A parameter is trainable when a prefix of
``--trainable`` starts, or occurs in, its flax path (``params/<module
path>/<leaf>``, ``utils/convert.py``), the JAX script's rule on its
parameter tree. Writes ``<out>/step_<epochs>/checkpoint.pt`` and
``<out>/scaler.json``. ``--conf`` (JSON merged onto the script's
``CONFIG``) is the port's, as ``evaluate_models`` has it.
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Dict, Sequence

import numpy as np
import torch

from gcnn_keras_tpu_torch.training.force_script import (
    force_loss_fn, load_config, load_script_dataset, script_module)
from gcnn_keras_tpu_torch.training.trainer import Trainer

# E + 100 F, unnormalized
LOSS_WEIGHTS = {"energy": 1.0, "force": 100.0, "charge": 0.0}


def freeze_mask(model: torch.nn.Module, trainable_prefixes: Sequence[str]) -> Dict[str, str]:
    """``"trainable"`` or ``"frozen"`` for each parameter name of
    ``model``: trainable where some prefix ``p`` has ``path.startswith(p)``
    or ``p in path``, ``path`` its flax path with the top-level
    ``params``."""
    from gcnn_keras_tpu_torch.utils.convert import flax_leaf_names
    labels = {}
    for name, leaf in flax_leaf_names(model).items():
        path = f"params/{leaf}"
        labels[name] = "trainable" if any(path.startswith(p) or p in path
                                          for p in trainable_prefixes) else "frozen"
    return labels


def transfer(checkpoint: str, script: str = "force_hdnnp4th", data_path=None,
             epochs: int = 20, trainable: Sequence[str] = ("mlp_local", "output"),
             out: str = "model_transfer", device=None, conf=None) -> Dict:
    """Retrain ``checkpoint``'s heads as the module docstring says; the
    config is ``load_config``'s. Returns the output directory, each
    epoch's mean loss and wall time (the losses read on the host each
    step, as the JAX script reads them) and the labels."""
    from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader
    from gcnn_keras_tpu_torch.data.scalers import EnergyForceExtensiveLabelScaler
    from gcnn_keras_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    device = resolve_device(device)
    mod = script_module(script)
    cfg = load_config(mod, data_path, conf)
    ds = load_script_dataset(mod, cfg)
    fmodel = mod.build_model(cfg, device=device)
    model = fmodel.energy_model
    model.load_state_dict(load_checkpoint(checkpoint, map_location=device)["params"])

    scaler = EnergyForceExtensiveLabelScaler()
    scaler.fit_dataset(ds)
    scaler.transform_dataset(ds)
    loader = GraphBatchLoader(list(ds), 8, shuffle=True, global_keys=("energy", "total_charge"),
                              device=device, **ds.batch_shape_hint(8))

    labels = freeze_mask(model, trainable)
    params = [p for n, p in model.named_parameters() if labels[n] == "trainable"]
    loss_fn = force_loss_fn(fmodel, LOSS_WEIGHTS)
    # with every parameter frozen the JAX script still takes its steps,
    # which change nothing: here the loss alone is computed
    trainer = Trainer(loss_fn, functools.partial(torch.optim.Adam, lr=1e-4)) if params else None
    state = trainer.init_state(params) if params else None
    epoch_losses, epoch_s = [], []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        losses = []
        for b in loader:
            if trainer is not None:
                state, metrics = trainer.step(state, b)
                losses.append(float(metrics["loss"]))
            else:
                losses.append(float(loss_fn(b)[0]))
        epoch_s.append(time.perf_counter() - t0)
        epoch_losses.append(float(np.mean(losses)))
        if epoch % 5 == 0 or epoch == epochs - 1:
            print(f"epoch {epoch}: loss={epoch_losses[-1]:.4f}")

    save_checkpoint(out, model, state.optimizer if state else None, step=epochs)
    scaler.save(f"{out}/scaler.json")
    return {"saved": out, "epoch_losses": epoch_losses, "epoch_s": epoch_s, "labels": labels}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--script", default="force_hdnnp4th")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--trainable", nargs="+", default=["mlp_local", "output"],
                    help="module-name prefixes to keep trainable")
    ap.add_argument("--out", default="model_transfer")
    ap.add_argument("--conf", default=None,
                    help="JSON config merged onto the script's CONFIG")
    ap.add_argument("--device", default=None,
                    help="the device to train on: the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)
    transfer(args.checkpoint, args.script, args.data_path, args.epochs, args.trainable,
             args.out, args.device, args.conf)
    print(json.dumps({"saved": args.out}))


if __name__ == "__main__":
    main()
