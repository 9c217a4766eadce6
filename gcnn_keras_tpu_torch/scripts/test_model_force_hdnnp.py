"""The golden-IO check of a trained force model; counterpart of the root
``test_model_force_hdnnp.py``.

    python -m gcnn_keras_tpu_torch.scripts.test_model_force_hdnnp --checkpoint DIR
        [--device cpu] [--script force_hdnnp4th] [--inputs 'input_*.txt']
        [--golden output.json] [--record] [--atol 1e-4] [--conf C.json]

Each input file (``input_NN.txt``: the atom count, then ``z x y z [q
esp]`` rows) is a molecule; its neighbours within 6 Bohr (at most 25)
and its angle triples feed the model of ``--script`` (a module of
``gcnn_keras_tpu_torch.scripts``, its ``CONFIG`` under ``--conf``) with the
weights of the checkpoint directory ``--checkpoint`` (the port's
``utils/checkpoint.py`` files, as the training scripts write them).
``--record`` writes the energies, forces and charges to ``--golden``;
without it they are checked against that file: each within ``--atol``.
The command exits 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import List, Optional

import numpy as np


def read_input_file(path: str) -> dict:
    """``input_NN.txt``: line 1 the atom count, then ``z x y z [q esp]``
    rows; a fifth column is read as the atoms' ESP (with zero gradients)."""
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    n = int(lines[0][0])
    rows = lines[1:1 + n]
    g = {"node_number": np.array([int(float(r[0])) for r in rows], dtype=np.int64),
         "node_coordinates": np.array([[float(v) for v in r[1:4]] for r in rows],
                                      dtype=np.float32),
         "total_charge": np.array([0.0], dtype=np.float32)}
    if len(rows[0]) > 4:
        g["esp"] = np.array([float(r[4]) for r in rows], dtype=np.float32)
        g["esp_grad"] = np.zeros((n, 3), dtype=np.float32)
    return g


def predict(checkpoint: str, script: str, graphs: List[dict], cutoff: float = 6.0,
            need_angles: bool = True, device=None, conf=None) -> List[dict]:
    """Each graph's energy, forces and (where the model gives them) charges
    from ``script``'s model with the weights of ``checkpoint``."""
    import torch
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle, set_range
    from gcnn_keras_tpu_torch.training.force_script import load_config, script_module
    from gcnn_keras_tpu_torch.utils.checkpoint import load_checkpoint
    from gcnn_keras_tpu_torch.utils.devices import resolve_device
    device = resolve_device(device)
    mod = script_module(script)
    fmodel = mod.build_model(load_config(mod, conf=conf), device=device)
    fmodel.energy_model.load_state_dict(
        load_checkpoint(checkpoint, map_location=device)["params"])
    prepared = []
    for g in graphs:
        g = set_range(dict(g), max_distance=cutoff, max_neighbours=25)
        g["edge_indices"] = g["range_indices"]
        if need_angles:
            g = set_angle(g, range_indices="edge_indices")
        prepared.append(g)
    batch = batch_graphs(prepared, global_keys=("total_charge",), device=device)
    out = {k: v.detach().cpu().numpy() for k, v in fmodel.apply(batch).items()
           if isinstance(v, torch.Tensor)}
    nm = batch.node_mask.cpu().numpy()
    gid = batch.graph_id.cpu().numpy()
    results = []
    for i in range(len(graphs)):
        sel = nm & (gid == i)
        r = {"energy": float(out["energy"][i].reshape(-1)[0]),
             "force": out["force"][sel].tolist()}
        if "charge" in out:
            r["charge"] = out["charge"][sel].tolist()
        results.append(r)
    return results


def compare(results: List[dict], golden: List[dict], atol: float) -> bool:
    """Print each frame's largest differences; whether all lie within
    ``atol`` (energy, forces, and charges where both have them)."""
    ok = True
    for i, (r, g) in enumerate(zip(results, golden)):
        de = abs(r["energy"] - g["energy"])
        df = np.abs(np.array(r["force"]) - np.array(g["force"])).max()
        line = f"frame {i}: dE={de:.2e} dF={df:.2e}"
        if "charge" in r and "charge" in g:
            dq = np.abs(np.array(r["charge"]) - np.array(g["charge"])).max()
            line += f" dq={dq:.2e}"
            ok &= bool(dq < atol)
        ok &= bool(de < atol and df < atol)
        print(line)
    print("PASS" if ok else "FAIL")
    return ok


def parser(default_script: str, scripts=None) -> argparse.ArgumentParser:
    """The root harness's arguments, ``--conf`` and ``--device`` (the CUDA
    card unless ``cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--script", default=default_script, choices=scripts)
    ap.add_argument("--inputs", default="input_*.txt")
    ap.add_argument("--golden", default="output.json")
    ap.add_argument("--record", action="store_true",
                    help="write the golden file instead of checking")
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--conf", default=None,
                    help="JSON config merged onto the script's CONFIG")
    ap.add_argument("--device", default=None,
                    help="the device to predict on: the CUDA card unless 'cpu'")
    return ap


def run(args, cutoff: float, need_angles: bool) -> dict:
    """Record or check (``args.record``): ``{"ok", "results"}``."""
    paths = sorted(glob.glob(args.inputs))
    if not paths:
        raise SystemExit(f"no input files match {args.inputs}")
    results = predict(args.checkpoint, args.script, [read_input_file(p) for p in paths],
                      cutoff=cutoff, need_angles=need_angles, device=args.device,
                      conf=args.conf)
    if args.record:
        with open(args.golden, "w") as f:
            json.dump(results, f, indent=2)
        print(f"recorded {len(results)} goldens -> {args.golden}")
        return {"ok": True, "results": results}
    with open(args.golden) as f:
        golden = json.load(f)
    return {"ok": compare(results, golden, args.atol), "results": results}


def main(argv: Optional[List[str]] = None) -> dict:
    return run(parser("force_hdnnp4th").parse_args(argv), cutoff=6.0, need_angles=True)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
