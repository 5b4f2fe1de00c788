"""Where an entry point runs when the caller names no device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA device.
    Raises when there is none: the port never carries on on the CPU unasked
    (pass ``device="cpu"`` to run there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass device=\"cpu\" to "
            "run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
