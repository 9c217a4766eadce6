"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; any other value is taken as given.

    Raises when no card is present and the caller did not name a device, so
    that a run meant for the card never carries on on the CPU unnoticed.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
