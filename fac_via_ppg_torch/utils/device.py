"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means "cuda".  Raises when CUDA is asked for but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def device_name(device: torch.device) -> str:
    """The card's name as torch.cuda.get_device_name gives it; "cpu"."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
