"""Plot learning curves from score files; counterpart of the root
``plot_learning_curve.py``. Each score file (``results/**/*_score.yaml`` by
default) with a list under a key that ends in ``--metric`` gets one PNG of
those values in ``--out``. Needs matplotlib.

    python -m gcnn_keras_tpu_torch.scripts.plot_learning_curve [--scores GLOB] [--metric loss] [--out DIR]
"""
from __future__ import annotations

import argparse
import glob

from gcnn_keras_tpu_torch.training.history import load_history_score
from gcnn_keras_tpu_torch.utils.plots import plot_train_test_loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scores", default="results/**/*_score.yaml")
    ap.add_argument("--metric", default="loss")
    ap.add_argument("--out", default="results/plots")
    args = ap.parse_args(argv)

    for path in glob.glob(args.scores, recursive=True):
        score = load_history_score(path)
        # a score file keeps each fold's last-epoch value: a list per metric
        hist_keys = [k for k in score if isinstance(score.get(k), list)
                     and k.endswith(args.metric)]
        hists = [{args.metric: score[k]} for k in hist_keys]
        if hists:
            plot_train_test_loss(
                hists, loss_name=args.metric,
                model_name=score.get("model_name", ""),
                dataset_name=score.get("dataset_name", ""),
                filepath=args.out,
                file_name=path.replace("/", "_") + ".png")
            print(f"plotted {path}")


if __name__ == "__main__":
    main()
