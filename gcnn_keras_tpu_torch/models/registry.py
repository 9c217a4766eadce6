"""Model config helpers; counterpart of ``gcnn_keras_tpu/models/registry.py``
(``update_model_kwargs`` so far)."""
from __future__ import annotations

from typing import Any, Dict


def update_model_kwargs(defaults: Dict[str, Any], kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Nested-default merge: a dict value updates the default dict of the
    same key one level deep; any other value replaces it."""
    out = dict(defaults)
    for k, v in (kwargs or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            merged = dict(out[k])
            merged.update(v)
            out[k] = merged
        else:
            out[k] = v
    return out
