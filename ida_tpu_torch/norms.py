"""Weighted root-mean-square norms (L1 layer).

Port of ``ida_tpu/norms.py``: ``wrms(x, w) = sqrt(sum_i (x_i * w_i)^2 / N)``.
The masked variant zeroes masked entries but still divides by the FULL
length N (SUNDIALS ``N_VWrmsNormMask`` semantics). Sums run in the
reference's sequential order and the root is IEEE-correct
(:mod:`~ida_tpu_torch.utils.numerics`).

Sharding: for a state vector sharded over an axis of the current mesh
(``utils.sharding.use_mesh``), pass that axis as ``axis_name``: the sum
then runs over every rank's entries (``ida_tpu``'s ``psum``, here a gather
of the terms and the unsharded sum, bit for bit) and N is the global
length, the local one times the axis' size.
"""

from __future__ import annotations

import torch

from .utils.ad_mode import ssqrt
from .utils.sharding import axis_size, sum_over


def _mean_sqrt(sq: torch.Tensor, n: int) -> torch.Tensor:
    # divide by a tensor, not a Python number: on CUDA, ATen turns a
    # division by a CPU scalar into a multiply by its reciprocal, which
    # rounds differently from the reference's true division
    return ssqrt(sq / torch.full_like(sq, n))


def wrms_norm(x: torch.Tensor, w: torch.Tensor, axis_name: str | None = None) -> torch.Tensor:
    """Weighted RMS norm over the trailing axis of ``x``."""
    sq = sum_over(torch.square(x * w).movedim(-1, 0), axis_name)
    return _mean_sqrt(sq, x.shape[-1] * axis_size(axis_name))


def wrms_norm_masked(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                     axis_name: str | None = None) -> torch.Tensor:
    """Masked weighted RMS norm over the trailing axis; divides by full N."""
    t = x * w * mask.to(x.dtype)
    sq = sum_over(torch.square(t).movedim(-1, 0), axis_name)
    return _mean_sqrt(sq, x.shape[-1] * axis_size(axis_name))


def wrms_norm_bnd(
    x: torch.Tensor,
    w: torch.Tensor,
    n: int,
    bnd: int,
    mask: torch.Tensor | None = None,
    axis_name: str | None = None,
) -> torch.Tensor:
    """WRMS norm over the DATA axis of a possibly batch-native array:
    ``x`` is [..., N, *batch] with ``bnd`` trailing batch dims (N the local
    length under ``axis_name``)."""
    t = x * w
    if mask is not None:
        t = t * mask.to(x.dtype).reshape((n,) + (1,) * bnd)
    axis = x.dim() - 1 - bnd
    sq = sum_over(torch.square(t).movedim(axis, 0), axis_name)
    return _mean_sqrt(sq, n * axis_size(axis_name))


def wrms_norm_maybe_masked(
    x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor | None, use_mask: bool,
    axis_name: str | None = None,
) -> torch.Tensor:
    """Dispatch mirroring ``Ida::wrms_norm`` (reference src/lib.rs:1353-1370)."""
    if use_mask and mask is not None:
        return wrms_norm_masked(x, w, mask, axis_name)
    return wrms_norm(x, w, axis_name)
