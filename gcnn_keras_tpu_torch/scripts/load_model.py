"""Load a trained checkpoint and predict a few frames; counterpart of the
root ``load_model.py``.

    python -m gcnn_keras_tpu_torch.scripts.load_model --checkpoint DIR [--device cpu]
        [--script force_hdnnp4th] [--data-path P] [--n-frames 4] [--conf C.json]

``--conf`` (JSON merged onto the script's ``CONFIG``) is the port's, as
``evaluate_models`` has it.
"""
from __future__ import annotations

import argparse
import json

from gcnn_keras_tpu_torch.training.force_script import (
    load_config, load_script_dataset, script_module)


def load_and_predict(checkpoint: str, script: str = "force_hdnnp4th",
                     data_path: str | None = None, n_frames: int = 4, device=None,
                     conf=None) -> dict:
    """Restore ``checkpoint`` (a directory ``script``'s training wrote)
    into ``script``'s model on ``device`` and predict the first
    ``n_frames`` frames of its dataset: their energies, and whether the
    model gives forces and charges. The config is ``load_config``'s."""
    from gcnn_keras_tpu_torch.utils.checkpoint import load_checkpoint
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    device = resolve_device(device)
    mod = script_module(script)
    cfg = load_config(mod, data_path, conf)
    ds = load_script_dataset(mod, cfg)
    ds = ds[list(range(min(n_frames, len(ds))))]
    fmodel = mod.build_model(cfg, device=device)
    fmodel.energy_model.load_state_dict(load_checkpoint(checkpoint, map_location=device)["params"])

    batch = ds.to_batch(global_keys=("energy", "total_charge"), device=device)
    out = fmodel.apply(batch)
    gm = batch.globals["graph_mask"].cpu().numpy().astype(bool).reshape(-1)
    return {
        "energies": out["energy"].detach().cpu().numpy()[gm].reshape(-1).tolist(),
        "has_forces": "force" in out,
        "has_charges": "charge" in out,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--script", default="force_hdnnp4th")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--n-frames", type=int, default=4)
    ap.add_argument("--conf", default=None,
                    help="JSON config merged onto the script's CONFIG")
    ap.add_argument("--device", default=None,
                    help="the device to predict on: the CUDA card unless 'cpu'")
    args = ap.parse_args(argv)
    out = load_and_predict(args.checkpoint, args.script, args.data_path, args.n_frames,
                           args.device, args.conf)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
