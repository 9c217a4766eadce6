"""Serialized dataset instantiation; counterpart of
``gcnn_keras_tpu/data/serial.py`` (``deserialize``): ``{class_name,
module_name, config, methods}`` -> the dataset, with the listed methods run
on it in order.

The table holds the JAX package's dataset names. The three synthetic
datasets (``data/datasets/synthetic.py``) and the two visual-graph ones
made from a seed (``data/datasets/vgd.py``) are ported; every other name of
the table raises ``ValueError``: its class reads files that are not in the
repository, and waits for the rest of the host side (ROADMAP.md). Nothing
is downloaded or read. A ``module_name`` under ``gcnn_keras_tpu.`` is read
as the port's module of the same path.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

from ..utils.port_modules import port_module

_SYNTHETIC = "gcnn_keras_tpu_torch.data.datasets.synthetic"
_DATASET_MODULES = {
    "SyntheticQM9Dataset": _SYNTHETIC,
    "SyntheticMDDataset": _SYNTHETIC,
    "SyntheticCitationDataset": _SYNTHETIC,
    "VgdMockDataset": "gcnn_keras_tpu_torch.data.datasets.vgd",
    "VgdRbMotifsDataset": "gcnn_keras_tpu_torch.data.datasets.vgd",
}
# the rest of the JAX package's table: name -> its module there
_HOST_SIDE = {
    **{n: "data.datasets.qm" for n in ("QM7Dataset", "QM7bDataset", "QM8Dataset",
                                        "QM9Dataset")},
    **{n: "data.datasets.md17" for n in ("MD17Dataset", "MD17RevisedDataset",
                                          "ISO17Dataset")},
    **{n: "data.datasets.citation" for n in ("CoraDataset", "CoraLuDataset")},
    **{n: "data.datasets.moleculenet" for n in (
        "ESOLDataset", "FreeSolvDataset", "LipopDataset", "ClinToxDataset",
        "Tox21MolNetDataset", "SIDERDataset", "MoleculeNetDataset2018", "QM9MolNetDataset")},
    **{n: "data.datasets.tudataset" for n in ("MUTAGDataset", "MutagenicityDataset",
                                               "PROTEINSDataset", "GraphTUDataset2020")},
    **{n: "data.datasets.matproject" for n in (
        "MatProjectEFormDataset", "MatProjectGapDataset", "MatProjectIsMetalDataset",
        "MatProjectDielectricDataset", "MatProjectJdft2dDataset",
        "MatProjectLogGVRHDataset", "MatProjectLogKVRHDataset",
        "MatProjectPerovskitesDataset", "MatProjectPhononsDataset", "MatBenchDataset2020")},
    "VisualGraphDataset": "data.visual_graph",
}


def _not_ported(name: str, module: str) -> ValueError:
    return ValueError(f"dataset {name} ({module}) is not ported yet: its class reads files "
                      "that are not in the repository (ROADMAP.md, 'the rest of the host "
                      "side'); the ported ones are " + ", ".join(_DATASET_MODULES))


def deserialize(config: Dict[str, Any]):
    """The dataset ``config["class_name"]`` built with ``config["config"]``,
    each ``{method: kwargs}`` of ``config["methods"]`` called on it in turn
    (e.g. ``{"map_list": {"method": "set_range", "max_distance": 5.0}}``)."""
    name = config["class_name"]
    module = config.get("module_name")
    if module:
        found = port_module(module)
        if found is None:
            raise _not_ported(name, module)
        module = found
    elif name in _HOST_SIDE:
        raise _not_ported(name, "gcnn_keras_tpu." + _HOST_SIDE[name])
    else:
        module = _DATASET_MODULES.get(name)
    if module is None:
        raise ValueError(f"unknown dataset {name}")
    cls = getattr(importlib.import_module(module), name)
    ds = cls(**config.get("config", {}))
    for m in config.get("methods", []):
        for method_name, method_kwargs in m.items():
            getattr(ds, method_name)(**method_kwargs)
    return ds
