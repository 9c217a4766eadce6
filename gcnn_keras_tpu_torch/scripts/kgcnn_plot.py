"""Correlation plots and a metric table for evaluated geometries;
counterpart of the root ``KGCNNPlot.py``. Reads an extended-xyz file whose
frames carry reference and predicted energies, forces and charges
(``ref_energy``/``pred_energy`` frame keys, ``ref_forces``/``pred_forces``/
``ref_charges``/``pred_charges`` per-atom columns), prints the MAE, RMSE
and R2 of each quantity, and writes predicted-against-true scatter plots
(skipped where matplotlib is missing).

    python -m gcnn_keras_tpu_torch.scripts.kgcnn_plot -g geoms.extxyz [-o DIR] [--json FILE]
        [--atomic-units] [--per-atom]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from gcnn_keras_tpu_torch.mol.io import _parse_extxyz_comment, _parse_properties

H_TO_EV = 27.2114
BOHR_TO_ANGSTROM = 0.529177

UNITS = {"energy": "eV", "forces": "eV/Å", "charges": "e"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-g", "--geoms", default="model_geoms.extxyz",
                    help="extxyz with ref_*/pred_* fields")
    ap.add_argument("-s", "--data-sources", default=None,
                    help="optional text file: one source label per frame")
    ap.add_argument("-o", "--out-dir", default=".")
    ap.add_argument("--atomic-units", action="store_true",
                    help="convert Hartree/Bohr inputs to eV/Angstrom")
    ap.add_argument("--per-atom", action="store_true",
                    help="divide energies by atom count")
    ap.add_argument("--json", default=None,
                    help="also dump the metric table to this JSON path")
    return ap.parse_args(argv)


def extract_data(path: str) -> List[dict]:
    """Every frame of an extended-xyz file: its atom count, each numeric
    comment key and each non-string per-atom column."""
    frames = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].split()[0])
        props = _parse_extxyz_comment(lines[i + 1])
        col_spec = _parse_properties(props.get("Properties", "species:S:1:pos:R:3"))
        per_atom: Dict[str, list] = {name: [] for name, kind, _ in col_spec if kind != "S"}
        for j in range(i + 2, i + 2 + n):
            parts = lines[j].split()
            c = 0
            for name, kind, width in col_spec:
                vals = parts[c:c + width]
                c += width
                if kind != "S":
                    per_atom[name].append([float(v) for v in vals])
        frame = {"n_atoms": n}
        for k, v in props.items():
            try:
                frame[k] = float(v)
            except (TypeError, ValueError):
                pass
        for k, v in per_atom.items():
            frame[k] = np.array(v, dtype=np.float64)
        frames.append(frame)
        i += 2 + n
    return frames


def _collect(frames: List[dict], key_pair, per_atom_energy=False,
             scale=1.0) -> Optional[Dict[str, np.ndarray]]:
    ref_key, pred_key = key_pair
    refs, preds = [], []
    for fr in frames:
        if ref_key not in fr or pred_key not in fr:
            return None
        r, p = np.asarray(fr[ref_key]), np.asarray(fr[pred_key])
        if per_atom_energy and r.ndim == 0:
            r, p = r / fr["n_atoms"], p / fr["n_atoms"]
        refs.append(np.ravel(r) * scale)
        preds.append(np.ravel(p) * scale)
    return {"ref": np.concatenate(refs), "pred": np.concatenate(preds)}


def create_metrics_collection(data: Dict[str, Dict[str, np.ndarray]],
                              sources: Optional[List[str]] = None) -> dict:
    """Each quantity's count, MAE, RMSE, R2 and unit. ``sources`` is
    accepted, as the root script's signature has it, and groups nothing."""
    out = {}
    for quantity, d in data.items():
        r, p = d["ref"], d["pred"]
        err = p - r
        ss_res = float(np.sum(err ** 2))
        ss_tot = float(np.sum((r - r.mean()) ** 2))
        out[quantity] = {
            "count": int(r.size),
            "mae": float(np.abs(err).mean()),
            "rmse": float(np.sqrt((err ** 2).mean())),
            "r2": 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan"),
            "unit": UNITS.get(quantity, ""),
        }
    return out


def plot_data(data: Dict[str, Dict[str, np.ndarray]], metrics: dict, out_dir: str):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plots")
        return
    for quantity, d in data.items():
        fig, ax = plt.subplots(figsize=(5, 5), dpi=100)
        lo = min(d["ref"].min(), d["pred"].min())
        hi = max(d["ref"].max(), d["pred"].max())
        ax.plot([lo, hi], [lo, hi], "k--", lw=1)
        ax.scatter(d["ref"], d["pred"], s=4, alpha=0.4)
        m = metrics[quantity]
        ax.set_xlabel(f"reference {quantity} [{m['unit']}]")
        ax.set_ylabel(f"predicted {quantity} [{m['unit']}]")
        ax.set_title(f"{quantity}: MAE {m['mae']:.4g} {m['unit']}, R2 {m['r2']:.4f}")
        fig.tight_layout()
        path = os.path.join(out_dir, f"correlation_{quantity}.png")
        fig.savefig(path)
        plt.close(fig)
        print(f"wrote {path}")


def main(argv=None):
    args = parse_args(argv)
    frames = extract_data(args.geoms)
    e_scale = H_TO_EV if args.atomic_units else 1.0
    f_scale = H_TO_EV / BOHR_TO_ANGSTROM if args.atomic_units else 1.0
    data = {}
    for quantity, pair, scale in [
            ("energy", ("ref_energy", "pred_energy"), e_scale),
            ("forces", ("ref_forces", "pred_forces"), f_scale),
            ("charges", ("ref_charges", "pred_charges"), 1.0)]:
        d = _collect(frames, pair, per_atom_energy=args.per_atom and quantity == "energy",
                     scale=scale)
        if d is not None:
            data[quantity] = d
    if not data:
        raise SystemExit(f"no ref_*/pred_* pairs found in {args.geoms}")
    metrics = create_metrics_collection(data)
    for q, m in metrics.items():
        print(f"{q:>8}: n={m['count']:<8} MAE={m['mae']:.6g} {m['unit']}  "
              f"RMSE={m['rmse']:.6g} {m['unit']}  R2={m['r2']:.5f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=2)
    os.makedirs(args.out_dir, exist_ok=True)
    plot_data(data, metrics, args.out_dir)
    return metrics


if __name__ == "__main__":
    main()
