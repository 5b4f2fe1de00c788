"""The "safe AD" mode for reverse-mode differentiation through the solver.

Port of ``ida_tpu/utils/ad_mode.py``. The solver's loop bodies are
self-masked: inactive or not-yet-initialized lanes compute garbage (often
``inf``/``nan`` from divisions by zeroed ``psi``/``beta`` entries) that a
``torch.where`` discards. Plain evaluation and forward-mode AD are untouched
by this, but reverse mode is not: the backward of ``x / y`` multiplies the
(zero) incoming cotangent by the (infinite) partial ``-x / y**2``, and
``0 * inf = nan`` leaks a NaN into otherwise masked gradients. The fix is the
double-where / safe-denominator trick.

``safe_ad()`` sets a module flag that the helpers read when they are CALLED
(``ida_tpu`` reads its flag when it traces; the port has no trace): under
it, ``smask_den`` / ``smask_pos`` substitute a harmless 1 for zero
denominators (or non-positive power bases) whose quotient a later mask
provably discards. Outside the context every helper is the identity (or the
plain ``sqrt_`` / ``pow_``), so the C-parity forward is unchanged bit for
bit. ``ssqrt`` and ``spow`` go through :mod:`.numerics`, so the CPU keeps
the C library's rounding inside the context too.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .numerics import pow_, sqrt_

_SAFE = False


def is_safe_ad() -> bool:
    """True inside ``safe_ad()``."""
    return _SAFE


@contextmanager
def safe_ad():
    """Enable the safe-denominator guards for reverse-mode AD."""
    global _SAFE
    old = _SAFE
    _SAFE = True
    try:
        yield
    finally:
        _SAFE = old


def smask_den(y: torch.Tensor) -> torch.Tensor:
    """Denominator guard: 1 where y == 0 (identity outside safe_ad)."""
    if not _SAFE:
        return y
    return torch.where(y == 0.0, torch.ones_like(y), y)


def smask_pos(y: torch.Tensor) -> torch.Tensor:
    """Power-base / sqrt-argument guard: 1 where y <= 0 (identity outside
    safe_ad), for expressions like ``y ** (-1/k)`` whose result is
    discarded where y <= 0."""
    if not _SAFE:
        return y
    return torch.where(y <= 0.0, torch.ones_like(y), y)


def ssqrt(x: torch.Tensor) -> torch.Tensor:
    """PRIMAL-PRESERVING sqrt with a finite gradient at x == 0 (the
    double-where trick): sqrt(0) stays 0, but the backward sees the constant
    branch instead of the 1/(2*sqrt(0)) = inf partial. Plain ``sqrt_``
    outside safe_ad. WRMS norms of exactly-zero vectors (converged lanes
    running masked extra iterations) are legitimate primal values whose
    cotangent must not turn into 0 * inf."""
    if not _SAFE:
        return sqrt_(x)
    pos = x > 0.0
    return torch.where(pos, sqrt_(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))


def spow(base: torch.Tensor, expo) -> torch.Tensor:
    """PRIMAL-PRESERVING ``base ** expo`` for base >= 0 with finite
    gradients at base == 0 (and for garbage negative bases in masked lanes,
    whose result is discarded later): the zero / negative branch returns 0
    with zero partials. Plain ``pow_`` outside safe_ad."""
    if not _SAFE:
        return pow_(base, expo)
    pos = base > 0.0
    return torch.where(pos, pow_(torch.where(pos, base, torch.ones_like(base)), expo),
                       torch.zeros_like(base))
