"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  A CUDA device on a host without one raises — the port
    never slides onto the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpudist_torch runs on an NVIDIA GPU and this host has no CUDA "
            "device; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev
