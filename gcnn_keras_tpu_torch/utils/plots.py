"""Training curves and predicted-against-true scatters as PNG files;
counterpart of ``gcnn_keras_tpu/utils/plots.py``. Each raises
``ImportError`` where matplotlib is not installed, as the JAX package's
does."""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_train_test_loss(histories: List[Dict[str, List[float]]],
                         loss_name: str = "loss",
                         val_loss_name: Optional[str] = None,
                         model_name: str = "", dataset_name: str = "",
                         filepath: Optional[str] = None,
                         file_name: str = "loss.png"):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, h in enumerate(histories):
        if loss_name in h:
            ax.plot(h[loss_name], label=f"train {i}", alpha=0.8)
        if val_loss_name and val_loss_name in h:
            ax.plot(h[val_loss_name], "--", label=f"val {i}", alpha=0.8)
    ax.set_xlabel("epoch")
    ax.set_ylabel(loss_name)
    ax.set_title(f"{model_name} on {dataset_name}")
    ax.legend(fontsize=7)
    if filepath:
        os.makedirs(filepath, exist_ok=True)
        fig.savefig(os.path.join(filepath, file_name), dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_predict_true(y_predict: np.ndarray, y_true: np.ndarray,
                      data_unit: str = "", model_name: str = "",
                      dataset_name: str = "", target_names: str = "",
                      filepath: Optional[str] = None,
                      file_name: str = "predict.png"):
    plt = _plt()
    y_predict = np.asarray(y_predict).reshape(-1)
    y_true = np.asarray(y_true).reshape(-1)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(y_true, y_predict, s=8, alpha=0.5)
    lim = [min(y_true.min(), y_predict.min()), max(y_true.max(), y_predict.max())]
    ax.plot(lim, lim, "k--", lw=1)
    mae = float(np.mean(np.abs(y_predict - y_true)))
    ax.set_xlabel(f"true {target_names} [{data_unit}]")
    ax.set_ylabel(f"predicted [{data_unit}]")
    ax.set_title(f"{model_name} on {dataset_name}: MAE={mae:.4g}")
    if filepath:
        os.makedirs(filepath, exist_ok=True)
        fig.savefig(os.path.join(filepath, file_name), dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig
