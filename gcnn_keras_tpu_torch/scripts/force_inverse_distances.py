"""Pair-distance baseline energy+force training; counterpart of the root
``force_inverse_distances.py``.

    python -m gcnn_keras_tpu_torch.scripts.force_inverse_distances [--device cpu] [--epochs N]

The model (``HDNNP2ndInverseDistances``) takes the M(M-1)/2 pair distances
of molecules padded to M atoms, M the dataset's largest molecule (its atom
counts, read once per data source); a batch of smaller molecules is padded
on to M by the model.
"""
import functools

from gcnn_keras_tpu_torch.training.force_script import (
    DEFAULTS, parse_config_cli, run_force_training)

CONFIG = dict(DEFAULTS, model_prefix="model_inverse_distances_force",
              mlp_units=[128, 64, 1])


@functools.lru_cache(maxsize=None)
def _largest(data_path, synthetic_frames: int, seed: int) -> int:
    if data_path:
        from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
        graphs = MemoryGraphDataset().load(data_path)
    else:
        from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticMDDataset
        graphs = SyntheticMDDataset(num_frames=synthetic_frames, seed=seed)
    return max(len(g["node_number"]) for g in graphs)


def largest_molecule(cfg) -> int:
    """The atoms of the largest molecule of the configuration's dataset
    (``load_force_dataset``'s source, without its neighbour lists)."""
    cfg = {**DEFAULTS, **cfg}
    return _largest(cfg.get("data_path") or None, cfg["synthetic_frames"], cfg["seed"])


def build_model(cfg, device=None, generator=None):
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_inverse_distances
    acts = ["swish"] * (len(cfg["mlp_units"]) - 1) + ["linear"]
    model = make_model_inverse_distances(
        device=device, generator=generator, max_nodes=largest_molecule(cfg),
        mlp_kwargs={"units": cfg["mlp_units"], "num_relations": 96, "activation": acts})
    return EnergyForceModel(model, device=device)


if __name__ == "__main__":
    run_force_training(build_model, parse_config_cli(CONFIG))
