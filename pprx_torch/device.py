"""Device selection for the port: explicit, never global."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when no GPU is present.

    Measurement paths call this instead of falling back to the CPU: a number
    taken on the CPU is never reported as a device number.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", 0)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. ``None`` means the first CUDA device and raises without one;
    there is no fallback to the CPU."""
    if device is None:
        return require_cuda()
    return torch.device(device)


def device_name(device: torch.device) -> str:
    """What a report names as its device: the card's name, or ``"cpu"``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
