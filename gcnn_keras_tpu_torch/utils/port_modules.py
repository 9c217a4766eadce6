"""Module paths of the JAX package read as the port's."""
from __future__ import annotations

import importlib.util
from typing import Optional

JAX_PACKAGE = "gcnn_keras_tpu"
PORT_PACKAGE = "gcnn_keras_tpu_torch"


def is_jax_path(name: str) -> bool:
    """Whether ``name`` is the JAX package or one of its modules."""
    return name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + ".")


def port_path(name: str) -> str:
    """``gcnn_keras_tpu.X`` -> ``gcnn_keras_tpu_torch.X``; any other name as
    it is."""
    return PORT_PACKAGE + name[len(JAX_PACKAGE):] if is_jax_path(name) else name


def port_module(name: str) -> Optional[str]:
    """:func:`port_path` of ``name`` where that module exists, else None."""
    port = port_path(name)
    try:
        return port if importlib.util.find_spec(port) is not None else None
    except ModuleNotFoundError:
        return None
