"""Hyperparameter search; counterpart of
``gcnn_keras_tpu/training/hyper_search.py``, numpy and JSON copied over.

``SearchSpace`` samples configurations from a dict of specs;
``HyperbandSearch`` runs successive halving over them: every configuration
trains ``min_epochs``, the best ``1/eta`` go on with ``eta`` times the
epochs, until ``max_epochs`` or one is left. Each trial is written to
``<directory>/trial_XXXX.json`` and the best to ``best_trial.json``;
``retrieve_trial`` reads them back. The same seed samples the same
configurations and writes the same files as the JAX package.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np


class SearchSpace:
    """``{"name": spec}``, each spec one of ``{"choice": [...]}``,
    ``{"int": [lo, hi]}`` (both ends included), ``{"float": [lo, hi]}`` or
    ``{"log_float": [lo, hi]}``."""

    def __init__(self, space: Dict[str, Dict]):
        self.space = space

    def sample(self, rs: np.random.RandomState) -> Dict[str, Any]:
        out = {}
        for name, spec in self.space.items():
            if "choice" in spec:
                out[name] = spec["choice"][rs.randint(len(spec["choice"]))]
            elif "int" in spec:
                lo, hi = spec["int"]
                out[name] = int(rs.randint(lo, hi + 1))
            elif "float" in spec:
                lo, hi = spec["float"]
                out[name] = float(rs.uniform(lo, hi))
            elif "log_float" in spec:
                lo, hi = spec["log_float"]
                out[name] = float(np.exp(rs.uniform(np.log(lo), np.log(hi))))
            else:
                raise ValueError(f"bad spec for {name}: {spec}")
        return out


class HyperbandSearch:
    """``run(trial_fn)`` with ``trial_fn(hparams, epochs) -> {metric:
    value}``, ``objective`` one of the metrics, minimised (``direction=
    "min"``) or maximised."""

    def __init__(self, space: SearchSpace, objective: str,
                 direction: str = "min", max_epochs: int = 50,
                 min_epochs: int = 5, eta: int = 3, num_trials: int = 27,
                 seed: int = 0, directory: str = "hyp_search"):
        self.space = space
        self.objective = objective
        self.direction = direction
        self.max_epochs = max_epochs
        self.min_epochs = min_epochs
        self.eta = eta
        self.num_trials = num_trials
        self.seed = seed
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def run(self, trial_fn: Callable[[Dict, int], Dict[str, float]]) -> Dict:
        """Every rung, then the best trial (also in ``best_trial.json``)."""
        rs = np.random.RandomState(self.seed)
        configs = [self.space.sample(rs) for _ in range(self.num_trials)]
        ids = list(range(len(configs)))
        epochs = self.min_epochs
        sign = 1.0 if self.direction == "min" else -1.0
        results: Dict[int, Dict] = {}
        rung = 0
        while ids:
            scores = []
            for tid in ids:
                t0 = time.perf_counter()
                metrics = trial_fn(configs[tid], epochs)
                val = float(metrics[self.objective])
                results[tid] = {"trial_id": tid, "hparams": configs[tid],
                                "epochs": epochs, "metrics": metrics,
                                "score": val,
                                "time_s": time.perf_counter() - t0}
                self._save_trial(results[tid])
                scores.append(sign * val)
                print(f"rung {rung} trial {tid}: {self.objective}={val:.5f} "
                      f"({epochs} epochs)")
            if epochs >= self.max_epochs or len(ids) <= 1:
                break
            keep = max(len(ids) // self.eta, 1)
            order = np.argsort(scores)
            ids = [ids[i] for i in order[:keep]]
            epochs = min(epochs * self.eta, self.max_epochs)
            rung += 1

        best_id = min(results, key=lambda t: sign * results[t]["score"])
        best = results[best_id]
        with open(os.path.join(self.directory, "best_trial.json"), "w") as f:
            json.dump(best, f, indent=2, default=str)
        return best

    def _save_trial(self, trial: Dict):
        path = os.path.join(self.directory, f"trial_{trial['trial_id']:04d}.json")
        with open(path, "w") as f:
            json.dump(trial, f, indent=2, default=str)


def retrieve_trial(directory: str, trial_id: Optional[int] = None) -> Dict:
    """A trial's record: ``trial_id``'s, or the best one's if None."""
    if trial_id is None:
        path = os.path.join(directory, "best_trial.json")
    else:
        path = os.path.join(directory, f"trial_{trial_id:04d}.json")
    with open(path) as f:
        return json.load(f)
