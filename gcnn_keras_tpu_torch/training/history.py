"""Score files; counterpart of ``gcnn_keras_tpu/training/history.py``
(``save_history_score``, ``load_history_score``)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


def save_history_score(histories: List[Dict[str, List[float]]],
                       filepath: str,
                       model_name: str = "", dataset_name: str = "",
                       model_class: str = "make_model",
                       multi_target_indices=None,
                       execute_folds=None,
                       seed: Optional[int] = None,
                       time_list: Optional[List[float]] = None) -> dict:
    """Each metric's last-epoch value per fold, with their mean and
    standard deviation, written as YAML (as JSON beside it, ``.json``, where
    ``yaml`` is missing); returns the score dict."""
    score: Dict[str, object] = {
        "model_name": model_name, "model_class": model_class,
        "dataset_name": dataset_name, "date_time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "seed": seed, "number_histories": len(histories),
    }
    if time_list:
        score["execute_time"] = [float(t) for t in time_list]
    keys = set()
    for h in histories:
        keys.update(h.keys())
    for k in sorted(keys):
        vals = [h[k][-1] for h in histories if k in h and len(h[k])]
        if vals:
            score[k] = [float(v) for v in vals]
            score[f"{k}_mean"] = float(np.mean(vals))
            score[f"{k}_std"] = float(np.std(vals))
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    try:
        import yaml
        with open(filepath, "w") as f:
            yaml.safe_dump(score, f)
    except ImportError:
        with open(os.path.splitext(filepath)[0] + ".json", "w") as f:
            json.dump(score, f, indent=2)
    return score


def load_history_score(filepath: str) -> dict:
    """A score file that ``save_history_score`` wrote, YAML or JSON."""
    try:
        import yaml
        with open(filepath) as f:
            return yaml.safe_load(f)
    except (ImportError, FileNotFoundError):
        with open(os.path.splitext(filepath)[0] + ".json") as f:
            return json.load(f)
