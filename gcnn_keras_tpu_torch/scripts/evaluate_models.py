"""Ensemble evaluation: load every checkpoint of an ensemble, predict a
dataset, report each member's and the ensemble mean's errors and write
each member's evaluator artifacts; counterpart of the root
``evaluate_models.py``.

    python -m gcnn_keras_tpu_torch.scripts.evaluate_models [--device cpu]
        [--prefix model_energy_force] [--script force_hdnnp4th] [--data-path P]
        [--output-dir evaluation_results] [--indices I.pickle] [--conf C.json]

``--script`` names a module of ``gcnn_keras_tpu_torch.scripts`` (its
``build_model`` and ``CONFIG``); the members are the ``<prefix>_*``
directories its training wrote (``torch.save`` checkpoints and
``scaler.json``). The config's ``make_plots`` (true unless ``--conf``
says otherwise) decides the PNGs.
"""
from __future__ import annotations

import argparse
import glob
import json

import numpy as np
import torch


def load_ensemble(prefix: str, build_model, cfg, device=None):
    """``(fmodel, scaler)`` for every ``<prefix>_*`` directory, the model
    on ``device`` with the directory's latest checkpoint, the scaler from
    its ``scaler.json`` (None without one)."""
    from gcnn_keras_tpu_torch.data.scalers import EnergyForceExtensiveLabelScaler
    from gcnn_keras_tpu_torch.utils.checkpoint import load_checkpoint
    members = []
    for d in sorted(glob.glob(f"{prefix}_*")):
        fmodel = build_model(cfg, device=device)
        dev = next(fmodel.energy_model.parameters()).device
        fmodel.energy_model.load_state_dict(load_checkpoint(d, map_location=dev)["params"])
        scaler = EnergyForceExtensiveLabelScaler()
        try:
            scaler.load(f"{d}/scaler.json")
        except FileNotFoundError:
            scaler = None
        members.append((fmodel, scaler))
    return members


def predict_ensemble(members, batch, graphs=None):
    """Each member's outputs on ``batch``, stacked: ``{key: (n_members,
    ...)}`` numpy arrays, in raw units where a member has a scaler and
    ``graphs`` (the batch's graphs) are given: energies through the
    member's inverse transform, forces times its ``scale_[0]``."""
    outs = []
    gm = batch.globals["graph_mask"].cpu().numpy().astype(bool).reshape(-1)
    for fmodel, scaler in members:
        out = {k: v.detach().cpu().numpy() for k, v in fmodel.apply(batch).items()
               if torch.is_tensor(v)}
        if scaler is not None and scaler.scale_ is not None and graphs is not None:
            z = [np.asarray(g["node_number"]) for g in graphs]
            e = out["energy"].reshape(batch.n_graphs, -1)[:, 0]
            e_raw = e.copy()
            e_raw[gm] = scaler.inverse_transform(e[gm], z)
            out["energy"] = e_raw[:, None]
            if "force" in out:
                out["force"] = out["force"] * scaler.scale_[0]
        outs.append(out)
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def ensemble_report(preds, batch) -> dict:
    """Each member's and the ensemble mean's MAE of the energies and
    forces against the batch's labels."""
    gm = batch.globals["graph_mask"].cpu().numpy().astype(bool).reshape(-1)
    nm = batch.node_mask.cpu().numpy().astype(bool)
    report = {"n_members": len(next(iter(preds.values())))}
    if "energy" in preds and "energy" in batch.globals:
        target = batch.globals["energy"].cpu().numpy()[gm]
        report["energy_mae_per_model"] = [float(np.abs(p[gm] - target).mean())
                                          for p in preds["energy"]]
        report["energy_mae_ensemble"] = float(
            np.abs(preds["energy"].mean(axis=0)[gm] - target).mean())
    if "force" in preds and "force" in batch.nodes:
        target = batch.nodes["force"].cpu().numpy()[nm]
        report["force_mae_per_model"] = [float(np.abs(p[nm] - target).mean())
                                         for p in preds["force"]]
        report["force_mae_ensemble"] = float(
            np.abs(preds["force"].mean(axis=0)[nm] - target).mean())
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix", default="model_energy_force")
    ap.add_argument("--script", default="force_hdnnp4th",
                    help="module of gcnn_keras_tpu_torch.scripts providing build_model + CONFIG")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--output-dir", default="evaluation_results",
                    help="each member's artifacts: errors_{i}.json, geoms_{i}.extxyz, "
                         "*_predictions_{i}.csv, predict_*_{i}.png")
    ap.add_argument("--indices", default=None,
                    help="pickle of a dict holding the 'test' indices; default: the whole "
                         "dataset as the test split")
    ap.add_argument("--conf", default=None,
                    help="JSON config merged onto the script's CONFIG")
    ap.add_argument("--device", default=None,
                    help="the device to evaluate on: the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)

    from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
    from gcnn_keras_tpu_torch.training.evaluation import evaluate_model
    from gcnn_keras_tpu_torch.training.force_script import (
        load_config, load_script_dataset, script_module)
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    device = resolve_device(args.device)
    mod = script_module(args.script)
    cfg = load_config(mod, args.data_path, args.conf)
    ds = load_script_dataset(mod, cfg)

    members = load_ensemble(args.prefix, mod.build_model, cfg, device)
    if not members:
        raise SystemExit(f"no checkpoints matching {args.prefix}_*")

    batch = ds.to_batch(global_keys=("energy", "total_charge"), device=device)
    report = ensemble_report(predict_ensemble(members, batch, graphs=list(ds)), batch)

    if args.indices:
        import pickle
        with open(args.indices, "rb") as f:
            test = np.asarray(pickle.load(f)["test"])
    else:
        test = np.arange(len(ds))
    empty = np.array([], np.int64)
    for i, (fmodel, scaler) in enumerate(members):
        ds_m = MemoryGraphDataset(graphs=[dict(g) for g in ds])
        if scaler is not None:
            scaler.transform_dataset(ds_m)
        evaluate_model(ds_m, fmodel, (empty, empty, test), scaler=scaler, model_index=i,
                       output_dir=args.output_dir,
                       dataset_name=cfg.get("data_path") or "synthetic",
                       model_name=args.script, make_plots=cfg.get("make_plots", True))
    report["output_dir"] = args.output_dir
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
