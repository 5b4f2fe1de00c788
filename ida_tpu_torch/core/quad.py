"""Quadratures along the solution (the IDAS quadrature role).

Port of ``ida_tpu/core/quad.py``. After every ACCEPTED step the integral
``int_{tn-hused}^{tn} q(t, y(t), y'(t)) dt`` is added to ``state.yQ`` by
3-point Gauss-Legendre on the solver's own BDF interpolant
(``interp.interpolate``, the polynomial C IDA's IDAGetSolution evaluates).
Gauss-3 integrates the interpolant (degree <= 5) exactly. As IDAS with
errconQ false, the quadratures enter neither the Newton system nor the
error test.

``state.yQ`` holds the integral up to the internal time ``tn``;
:func:`get_quad` gives it at any ``t`` inside the last step (IDAS
IDAGetQuad), the usual case being a return at ``tret < tn``. Shapes are
batch-native: ``yQ`` is [nquad, *batch].
"""

from __future__ import annotations

import torch

from .interp import interpolate
from .state import IdaState

# 3-point Gauss-Legendre on [-1, 1]: exact for polynomial degree <= 5
_G3 = (
    (-0.7745966692414834, 5.0 / 9.0),  # -sqrt(3/5)
    (0.0, 8.0 / 9.0),
    (0.7745966692414834, 5.0 / 9.0),
)


def quad_increment(state: IdaState, problem, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``int_a^b q(t, y(t), y'(t)) dt`` on the current interpolant, valid for
    ``a``/``b`` inside its window (the last completed step); signed, 0 for an
    empty interval. [nquad, *batch]."""
    mid = 0.5 * (a + b)
    half = 0.5 * (b - a)
    acc = None
    for xi, w in _G3:
        t = mid + half * xi
        yy, yp = interpolate(state, t)
        term = w * problem.quad(t, yy, yp)
        acc = term if acc is None else acc + term
    return half * acc


def accumulate_quad(state: IdaState, problem, mask: torch.Tensor) -> IdaState:
    """Add the last step's contribution for the lanes in ``mask`` (the attempt
    loop passes the lanes whose step was accepted)."""
    inc = quad_increment(state, problem, state.tn - state.hused, state.tn)
    return state._replace(yQ=torch.where(mask, state.yQ + inc, state.yQ))


def get_quad(state: IdaState, problem, t: torch.Tensor) -> torch.Tensor:
    """The integral of ``quad`` from t0 to ``t`` (IDAS IDAGetQuad): the
    accumulator less the tail from ``t`` to ``tn``; ``t`` must lie inside
    the last step, as every solver return time does."""
    return state.yQ - quad_increment(state, problem, t, state.tn)
