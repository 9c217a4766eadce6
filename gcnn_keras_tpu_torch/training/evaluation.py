"""Evaluation of a trained model on its splits, with the fork's artifact
set; counterpart of ``gcnn_keras_tpu/training/evaluation.py``
(``evaluate_model``, ``_predict_stage``).

In ``output_dir``, for model index ``i`` (the suffix ``_i``, none if
None):

- ``errors{i}.json``: RMSE, MAE and R2 of each split (Train, Val, Test) for
  energy, force and charge, as ``"Test RMSE Force"``;
- from the test split only: ``geoms{i}.extxyz`` with the reference and
  predicted energies, forces and charges, ``{energy,force,charge}_
  predictions{i}.csv`` with the element of each row, and, with
  ``make_plots``, ``predict_{label}{i}.png``.

The model is the ``EnergyForceModel`` whose module holds the weights (the
JAX package takes ``(fmodel, params)``); batches go to its device.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.loader import GraphBatchLoader
from ..mol.io import PERIODIC_TABLE


def _element_symbol(z: int) -> str:
    return PERIODIC_TABLE[z] if 0 <= z < len(PERIODIC_TABLE) else str(z)


def _metrics(true: np.ndarray, pred: np.ndarray) -> Tuple[float, float, float]:
    true = np.asarray(true, np.float64).reshape(-1)
    pred = np.asarray(pred, np.float64).reshape(-1)
    err = pred - true
    rmse = float(np.sqrt(np.mean(err * err)))
    mae = float(np.mean(np.abs(err)))
    ss_tot = float(np.sum((true - true.mean()) ** 2))
    r2 = float(1.0 - np.sum(err * err) / ss_tot) if ss_tot > 0 else float("nan")
    return rmse, mae, r2


def _write_csv(path: str, columns: Dict[str, np.ndarray]):
    keys = list(columns)
    rows = len(next(iter(columns.values())))
    with open(path, "w") as f:
        f.write(",".join(keys) + "\n")
        for i in range(rows):
            f.write(",".join(str(columns[k][i]) for k in keys) + "\n")


def _predict_stage(stage_ds, fmodel, global_keys, batch_size):
    """Predictions of a split in batches of ``batch_size`` graphs, in the
    split's order: ``pred_e``/``true_e``, and ``pred_f``/``true_f``,
    ``pred_q``/``true_q`` where the model and the data have them, real
    entries only."""
    graphs = list(stage_ds)
    size = min(batch_size, len(graphs))
    device = next(fmodel.energy_model.parameters()).device
    loader = GraphBatchLoader(graphs, size, shuffle=False, drop_last=False,
                              global_keys=global_keys, device=device,
                              **stage_ds.batch_shape_hint(size))
    pred_e, true_e, pred_f, true_f, pred_q, true_q = [], [], [], [], [], []
    for batch in loader:
        out = {k: v.detach().cpu().numpy() for k, v in fmodel.apply(batch).items()
               if torch.is_tensor(v)}
        gm = batch.globals["graph_mask"].cpu().numpy().astype(bool).reshape(-1)
        nm = batch.node_mask.cpu().numpy().astype(bool)
        pred_e.append(out["energy"].reshape(batch.n_graphs, -1)[:, 0][gm])
        true_e.append(batch.globals["energy"].cpu().numpy().reshape(batch.n_graphs, -1)[:, 0][gm])
        if "force" in out and "force" in batch.nodes:
            pred_f.append(out["force"][nm])
            true_f.append(batch.nodes["force"].cpu().numpy()[nm])
        if "charge" in out and "charge" in batch.nodes:
            pred_q.append(out["charge"].reshape(len(nm), -1)[:, 0][nm])
            true_q.append(batch.nodes["charge"].cpu().numpy().reshape(len(nm), -1)[:, 0][nm])
    res = {"pred_e": np.concatenate(pred_e), "true_e": np.concatenate(true_e)}
    if pred_f:
        res["pred_f"], res["true_f"] = np.concatenate(pred_f), np.concatenate(true_f)
    if pred_q:
        res["pred_q"], res["true_q"] = np.concatenate(pred_q), np.concatenate(true_q)
    return res


def evaluate_model(ds, fmodel, indices: Sequence[np.ndarray],
                   scaler=None, model_index: Optional[int] = None,
                   output_dir: str = "", dataset_name: str = "",
                   model_name: str = "model",
                   global_keys: Tuple[str, ...] = ("energy", "total_charge"),
                   make_plots: bool = True,
                   eval_batch_size: int = 32) -> Dict[str, float]:
    """Evaluate ``fmodel`` on the splits ``indices`` = (train, val, test) of
    ``ds`` and write the artifacts above; an empty split is skipped.
    ``ds`` holds labels in the scaled (training) space of ``scaler``, the
    fold's fitted ``EnergyForceExtensiveLabelScaler``; predictions and
    labels are both taken back to raw units, in which every metric and
    artifact is. Returns the errors."""
    suffix = f"_{model_index}" if model_index is not None else ""
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    scaled = scaler is not None and getattr(scaler, "scale_", None) is not None

    error_dict: Dict[str, float] = {}
    flats = {}
    test_stage = None
    for stage, idx in zip(("train", "val", "test"), indices):
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        if idx.size == 0:
            continue
        stage_ds = ds[idx]
        res = _predict_stage(stage_ds, fmodel, global_keys, eval_batch_size)
        z_list = [np.asarray(g["node_number"]) for g in stage_ds]

        pred_e, true_e = res["pred_e"], res["true_e"]
        if scaled:
            pred_e = scaler.inverse_transform(pred_e, z_list)
            true_e = scaler.inverse_transform(true_e, z_list)
        stage_flats = {"energy": (true_e, pred_e)}
        if "pred_f" in res:
            pred_f, true_f = res["pred_f"], res["true_f"]
            if scaled:
                pred_f = pred_f * float(scaler.scale_[0])
                true_f = true_f * float(scaler.scale_[0])
            stage_flats["force"] = (true_f, pred_f)
        if "pred_q" in res:
            stage_flats["charge"] = (res["true_q"], res["pred_q"])

        for label, (tv, pv) in stage_flats.items():
            rmse, mae, r2 = _metrics(tv, pv)
            error_dict[f"{stage.title()} RMSE {label.title()}"] = rmse
            error_dict[f"{stage.title()} MAE {label.title()}"] = mae
            error_dict[f"{stage.title()} R2 {label.title()}"] = r2
        if stage == "test":
            flats = stage_flats
            test_stage = (stage_ds, z_list)

    with open(os.path.join(output_dir, f"errors{suffix}.json"), "w") as f:
        json.dump(error_dict, f, indent=2, sort_keys=True)
    if test_stage is None:
        return error_dict

    from ..utils.save_load_utils import save_extxyz
    stage_ds, z_list = test_stage
    frames = []
    offset_n = 0
    ref_e_full, pred_e_full = flats["energy"]
    for gi, g in enumerate(stage_ds):
        n = len(np.asarray(g["node_number"]))
        fr = {"node_number": np.asarray(g["node_number"]),
              "node_coordinates": np.asarray(g["node_coordinates"]),
              "ref_energy": np.asarray(ref_e_full[gi:gi + 1]),
              "pred_energy": np.asarray(pred_e_full[gi:gi + 1])}
        for label, (ref_key, pred_key) in (("force", ("ref_forces", "pred_forces")),
                                           ("charge", ("ref_charges", "pred_charges"))):
            if label in flats:
                tv, pv = flats[label]
                fr[ref_key] = np.asarray(tv[offset_n:offset_n + n])
                fr[pred_key] = np.asarray(pv[offset_n:offset_n + n])
        frames.append(fr)
        offset_n += n
    save_extxyz(os.path.join(output_dir, f"geoms{suffix}.extxyz"), frames,
                array_keys=("ref_forces", "pred_forces", "ref_charges", "pred_charges"),
                info_keys=("ref_energy", "pred_energy"))

    at_types = np.concatenate([[_element_symbol(int(zz)) for zz in z] for z in z_list])
    for label, (tv, pv) in flats.items():
        cols = {f"{label}_reference": np.asarray(tv).reshape(-1),
                f"{label}_prediction": np.asarray(pv).reshape(-1)}
        if label != "energy" and len(cols[f"{label}_reference"]) % len(at_types) == 0:
            rep = len(cols[f"{label}_reference"]) // len(at_types)
            cols["at_types"] = np.repeat(at_types, rep)
        _write_csv(os.path.join(output_dir, f"{label}_predictions{suffix}.csv"), cols)

    if make_plots:
        from ..utils.plots import plot_predict_true
        units = {"charge": "e", "energy": "eV", "force": "eV/A"}
        for label, (tv, pv) in flats.items():
            plot_predict_true(np.asarray(pv), np.asarray(tv),
                              data_unit=units.get(label, ""), model_name=model_name,
                              dataset_name=dataset_name, target_names=label.title(),
                              filepath=output_dir or ".",
                              file_name=f"predict_{label}{suffix}.png")
    return error_dict
