"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no card and no device given it raises rather than quietly
    running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
