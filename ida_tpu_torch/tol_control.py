"""Tolerance control: error-weight vector computation (L1 layer).

Port of ``ida_tpu/tol_control.py``: ``ewt_i = 1 / (rtol * |y_i| + atol_i)``.
One NamedTuple covers the scalar/scalar and scalar/vector cases; ``atol``
broadcasts against ``y``. Batch-native callers pass ``rtol`` [B] and
``atol`` [N, B].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .utils.device import resolve_device


class TolControl(NamedTuple):
    """Scalar relative tolerance + scalar-or-vector absolute tolerance."""

    rtol: torch.Tensor
    atol: torch.Tensor

    def ewt_set(self, ycur: torch.Tensor) -> torch.Tensor:
        """Error weights (reference src/tol_control.rs:36-44,71-82)."""
        return 1.0 / (self.rtol * ycur.abs() + self.atol)


def tol_ss(rtol: float, atol: float, *, device=None, dtype=torch.float64) -> TolControl:
    """Scalar rtol + scalar atol (reference ``TolControlSS``). ``device``
    None is the current CUDA device (raises when there is none)."""
    device = resolve_device(device)
    return TolControl(
        torch.as_tensor(rtol, dtype=dtype, device=device),
        torch.as_tensor(atol, dtype=dtype, device=device),
    )


def tol_sv(rtol: float, atol, *, device=None, dtype=torch.float64) -> TolControl:
    """Scalar rtol + vector atol (reference ``TolControlSV``). ``device``
    None is the current CUDA device (raises when there is none)."""
    device = resolve_device(device)
    return TolControl(
        torch.as_tensor(rtol, dtype=dtype, device=device),
        torch.as_tensor(atol, dtype=dtype, device=device),
    )
