"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no device given and no CUDA available, raise: the
    port never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def synchronize(factory) -> None:
    """Wait for the work queued on `factory`'s device when it is a CUDA
    device, so that a host clock read next measures work, not launches."""
    device = getattr(factory, "device", None)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
