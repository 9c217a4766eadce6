"""Print a search trial's record; counterpart of the root
``retrieve_trial.py``.

    python -m gcnn_keras_tpu_torch.scripts.retrieve_trial [--directory DIR] [--trial-id N]
"""
from __future__ import annotations

import argparse
import json

from gcnn_keras_tpu_torch.training.hyper_search import retrieve_trial


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--directory", default="hyp_search_hdnnp4th")
    ap.add_argument("--trial-id", type=int, default=None, help="default: the best trial")
    args = ap.parse_args(argv)
    trial = retrieve_trial(args.directory, args.trial_id)
    print(json.dumps(trial, indent=2))
    return trial


if __name__ == "__main__":
    main()
