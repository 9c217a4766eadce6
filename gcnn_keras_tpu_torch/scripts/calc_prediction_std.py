"""The ensemble's disagreement per frame, the active-learning signal:
frames whose largest force std exceeds a threshold are flagged for
recomputation; counterpart of the root ``calc_prediction_std.py``.

    python -m gcnn_keras_tpu_torch.scripts.calc_prediction_std [--device cpu]
        [--prefix model_energy_force] [--script force_hdnnp4th] [--data-path P]
        [--threshold T] [--conf C.json]

``--conf`` (JSON merged onto the script's ``CONFIG``) is the port's, as
``evaluate_models`` has it.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from gcnn_keras_tpu_torch.scripts.evaluate_models import load_ensemble, predict_ensemble
from gcnn_keras_tpu_torch.training.force_script import (
    load_config, load_script_dataset, script_module)


def prediction_std(preds, batch, n_frames: int, threshold=None) -> dict:
    """Each frame's largest force std over its real atoms (0 for a frame
    without atoms), their mean, the frames above ``threshold``, and each
    frame's energy std; the std over the members, in raw units."""
    nm = batch.node_mask.cpu().numpy().astype(bool)
    gid = batch.graph_id.cpu().numpy()
    report = {}
    if "force" in preds:
        f_std = preds["force"].std(axis=0)  # (N, 3)
        per_frame = []
        for g in range(n_frames):
            sel = nm & (gid == g)
            per_frame.append(float(f_std[sel].max()) if sel.any() else 0.0)
        report["force_std_max_per_frame"] = per_frame
        report["force_std_mean"] = float(np.mean(per_frame))
        if threshold is not None:
            report["flagged_frames"] = [i for i, v in enumerate(per_frame) if v > threshold]
    if "energy" in preds:
        gm = batch.globals["graph_mask"].cpu().numpy().astype(bool).reshape(-1)
        e_std = preds["energy"].std(axis=0)[gm]
        report["energy_std_per_frame"] = [float(v) for v in e_std.reshape(-1)]
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix", default="model_energy_force")
    ap.add_argument("--script", default="force_hdnnp4th")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--threshold", type=float, default=None,
                    help="flag frames with max force std above this")
    ap.add_argument("--conf", default=None,
                    help="JSON config merged onto the script's CONFIG")
    ap.add_argument("--device", default=None,
                    help="the device to predict on: the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)

    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    device = resolve_device(args.device)
    mod = script_module(args.script)
    cfg = load_config(mod, args.data_path, args.conf)
    ds = load_script_dataset(mod, cfg)
    members = load_ensemble(args.prefix, mod.build_model, cfg, device)

    batch = ds.to_batch(global_keys=("energy", "total_charge"), device=device)
    preds = predict_ensemble(members, batch, graphs=list(ds))
    report = prediction_std(preds, batch, len(ds), args.threshold)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
