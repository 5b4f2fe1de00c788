"""Interpolated output from the BDF history (L4).

Port of ``ida_tpu/core/interp.py`` (reference ``get_solution``,
src/lib.rs:1274-1343): evaluate y(t), y'(t) from the divided-difference
array phi and the step sums psi; and ``get_dky`` (src/lib.rs:424-529), the
general k-th-derivative variant.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import constants as C
from ..utils.ad_mode import smask_den
from ..utils.numerics import sum0
from ..utils.profiling import scope
from .coeffs import kidx
from .state import IdaState


def _eps(state: IdaState) -> float:
    """Unit roundoff of the state's dtype (a Python float: no promotion)."""
    return torch.finfo(state.dtype).eps


def check_t_legal(state: IdaState, t: torch.Tensor) -> torch.Tensor:
    """True iff t lies within (fuzzed) [tn - hused, tn] in the direction of
    integration (src/lib.rs:1279-1291)."""
    tfuzz = 100.0 * _eps(state) * (state.tn.abs() + state.hh.abs()) * torch.sign(state.hh)
    tp = state.tn - state.hused - tfuzz
    return (t - tp) * state.hh >= 0.0


@scope("get_solution.interpolate")
def interpolate(state: IdaState, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(yy, yp) at t from phi/psi without legality checks; the cvals/dvals
    recurrences (src/lib.rs:1301-1314) unrolled to the static order bound."""
    kord = state.kused.clamp(min=1)
    delt = t - state.tn
    c = torch.ones_like(delt)
    d = torch.zeros_like(delt)
    zero = torch.zeros_like(delt)
    gam = delt / smask_den(state.psi[0])

    cvals = [c] + [zero] * (C.MXORDP1 - 1)
    dvals = [zero] * C.MXORDP1
    for j in range(1, C.MXORDP1):
        active = kord >= j
        d_new = d * gam + c / smask_den(state.psi[j - 1])
        c_new = c * gam
        gam_new = (delt + state.psi[j - 1]) / smask_den(state.psi[j])
        c = torch.where(active, c_new, c)
        d = torch.where(active, d_new, d)
        gam = torch.where(active, gam_new, gam)
        cvals[j] = torch.where(active, c, zero)
        dvals[j] = torch.where(active, d, zero)

    cvec = torch.stack(cvals)
    dvec = torch.stack(dvals)
    csel = torch.where(kidx(state) <= kord, cvec, torch.zeros_like(cvec))
    yy = sum0(csel.unsqueeze(1) * state.phi)
    yp = sum0(dvec.unsqueeze(1) * state.phi)
    return yy, yp


def get_solution(state: IdaState, t: torch.Tensor) -> Tuple[IdaState, torch.Tensor]:
    """Interpolate into state.yy/state.yp; returns (state, ok). On an illegal
    t the state is unchanged and ok is False (the caller maps it to BAD_T)."""
    ok = check_t_legal(state, t)
    yy, yp = interpolate(state, t)
    yy = torch.where(ok, yy, state.yy)
    yp = torch.where(ok, yp, state.yp)
    return state._replace(yy=yy, yp=yp), ok


@scope("get_dky")
def get_dky(state: IdaState, t: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-th derivative of the interpolating polynomial at t (reference
    src/lib.rs:424-529, with C IDAGetDky's index bounds, not the reference's
    off-by-one). ``k`` is a Python int, 0 <= k <= kused.

    Returns (dky [N, *batch], ok); ok is False where t lies outside the last
    step or k > kused for the lane."""
    kused = state.kused
    ok = check_t_legal(state, t) & (kused >= k)

    delt = t - state.tn
    zero = torch.zeros_like(delt)
    cjk = [zero] * C.MXORDP1
    cjk_1 = [zero] * C.MXORDP1
    psij_1 = zero

    for i in range(0, k + 1):
        if i == 0:
            cjk[0] = torch.ones_like(delt)
        else:
            # c_i^(i) = prod_{j<=i} j / psi_{j-1} (src/lib.rs:486-494)
            cjk[i] = cjk[i - 1] * i / smask_den(state.psi[i - 1])
            psij_1 = state.psi[i - 1]
        # update c_j^(i) for j = i+1 ..= kused - k + i (src/lib.rs:499-503)
        for j in range(i + 1, C.MXORDP1):
            active = kused - k + i >= j
            val = (i * cjk_1[j - 1] + cjk[j - 1] * (delt + psij_1)) / smask_den(state.psi[j - 1])
            cjk[j] = torch.where(active, val, cjk[j])
            psij_1 = torch.where(active, state.psi[j - 1], psij_1)
        cjk_1 = list(cjk)

    idx = kidx(state)
    cvec = torch.stack(cjk)
    sel = torch.where((idx >= k) & (idx <= kused), cvec, torch.zeros_like(cvec))
    dky = sum0(sel.unsqueeze(1) * state.phi)
    return dky, ok
