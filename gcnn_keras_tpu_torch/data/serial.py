"""Serialized dataset instantiation; counterpart of
``gcnn_keras_tpu/data/serial.py`` (``deserialize``): ``{class_name,
module_name, config, methods}`` -> the dataset, with the listed methods run
on it in order.

The table is the JAX package's, each name pointing at the port's module.
A ``module_name`` under ``gcnn_keras_tpu.`` is read as the port's module of
the same path. A dataset that is still empty once built, whose methods
name no ``read_in_memory``, is read (``read_in_memory()``) before them, as
kgcnn's classes read in their constructors: ``hyper_cora.py``,
``hyper_md17_revised.py``, the TUDataset and MoleculeNet configs list only
``map_list`` methods, and the JAX package builds their datasets empty.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

from ..utils.port_modules import port_module

_DATASETS = "gcnn_keras_tpu_torch.data.datasets."
_DATASET_MODULES = {
    **{n: _DATASETS + "qm" for n in ("QM7Dataset", "QM7bDataset", "QM8Dataset", "QM9Dataset")},
    **{n: _DATASETS + "md17" for n in ("MD17Dataset", "MD17RevisedDataset", "ISO17Dataset")},
    **{n: _DATASETS + "citation" for n in ("CoraDataset", "CoraLuDataset")},
    **{n: _DATASETS + "moleculenet" for n in (
        "ESOLDataset", "FreeSolvDataset", "LipopDataset", "ClinToxDataset",
        "Tox21MolNetDataset", "SIDERDataset", "MoleculeNetDataset2018", "QM9MolNetDataset")},
    **{n: _DATASETS + "tudataset" for n in ("MUTAGDataset", "MutagenicityDataset",
                                            "PROTEINSDataset", "GraphTUDataset2020")},
    **{n: _DATASETS + "matproject" for n in (
        "MatProjectEFormDataset", "MatProjectGapDataset", "MatProjectIsMetalDataset",
        "MatProjectDielectricDataset", "MatProjectJdft2dDataset", "MatProjectLogGVRHDataset",
        "MatProjectLogKVRHDataset", "MatProjectPerovskitesDataset", "MatProjectPhononsDataset",
        "MatBenchDataset2020")},
    "VgdMockDataset": _DATASETS + "vgd",
    "VgdRbMotifsDataset": _DATASETS + "vgd",
    "VisualGraphDataset": "gcnn_keras_tpu_torch.data.visual_graph",
    **{n: _DATASETS + "synthetic" for n in ("SyntheticQM9Dataset", "SyntheticMDDataset",
                                            "SyntheticCitationDataset")},
}


def deserialize(config: Dict[str, Any]):
    """The dataset ``config["class_name"]`` built with ``config["config"]``,
    read where the module docstring says, then each ``{method: kwargs}`` of
    ``config["methods"]`` called on it in turn (e.g. ``{"map_list":
    {"method": "set_range", "max_distance": 5.0}}``)."""
    name = config["class_name"]
    module = config.get("module_name")
    if module:
        found = port_module(module)
        if found is None:
            raise ValueError(f"dataset {name}: no module {module} in the port")
        module = found
    else:
        module = _DATASET_MODULES.get(name)
    if module is None:
        raise ValueError(f"unknown dataset {name}")
    cls = getattr(importlib.import_module(module), name)
    ds = cls(**config.get("config", {}))
    methods = config.get("methods", [])
    if len(ds) == 0 and hasattr(ds, "read_in_memory") and \
            not any("read_in_memory" in m for m in methods):
        ds.read_in_memory()
    for m in methods:
        for method_name, method_kwargs in m.items():
            getattr(ds, method_name)(**method_kwargs)
    return ds
