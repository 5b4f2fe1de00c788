"""Tolerance control: error-weight vector computation (L1 layer).

Port of ``ida_tpu/tol_control.py``: ``ewt_i = 1 / (rtol * |y_i| + atol_i)``.
One NamedTuple covers the scalar/scalar and scalar/vector cases; ``atol``
broadcasts against ``y``. Batch-native callers pass ``rtol`` [B] and
``atol`` [N, B].
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TolControl(NamedTuple):
    """Scalar relative tolerance + scalar-or-vector absolute tolerance."""

    rtol: torch.Tensor
    atol: torch.Tensor

    def ewt_set(self, ycur: torch.Tensor) -> torch.Tensor:
        """Error weights (reference src/tol_control.rs:36-44,71-82)."""
        return 1.0 / (self.rtol * ycur.abs() + self.atol)


def tol_ss(rtol: float, atol: float, *, device, dtype=torch.float64) -> TolControl:
    """Scalar rtol + scalar atol (reference ``TolControlSS``)."""
    return TolControl(
        torch.as_tensor(rtol, dtype=dtype, device=device),
        torch.as_tensor(atol, dtype=dtype, device=device),
    )


def tol_sv(rtol: float, atol, *, device, dtype=torch.float64) -> TolControl:
    """Scalar rtol + vector atol (reference ``TolControlSV``)."""
    return TolControl(
        torch.as_tensor(rtol, dtype=dtype, device=device),
        torch.as_tensor(atol, dtype=dtype, device=device),
    )
