"""Successful-step completion: order/stepsize selection and phi update (L4).

Port of ``ida_tpu/core/complete_step.py`` (reference ``complete_step``,
src/impl_complete_step.rs:22-177): counters, the startup (phase 0)
order-raise/step-double policy, the steady-state (phase 1)
Lower/Maintain/Raise order selection, the stepsize ratio, and the phi update
recurrence.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..problem import IdaProblem
from ..utils.ad_mode import smask_den, spow
from ..utils.profiling import scope
from ..utils.tree import take_row
from .coeffs import phi_star_scale
from .error_test import _norm
from .state import IdaOptions, IdaState

_LOWER, _MAINTAIN, _RAISE = 0, 1, 2


@scope("complete_step")
def complete_step(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    err_k: torch.Tensor,
    err_km1: torch.Tensor,
    ck: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
) -> IdaState:
    """``mask`` (per-lane bool): lanes with mask=False pass through bit for
    bit. When ``ck`` is given, the success path's ``ee *= ck``
    (src/lib.rs:708) is applied here under the same mask."""
    dtype = state.dtype
    if mask is None:
        mask = torch.ones(state.tn.shape, dtype=torch.bool, device=state.tn.device)
    nst = state.nst + 1
    kdiff = state.kk - state.kused  # (impl_complete_step.rs:27)
    kused = state.kk
    hused = state.hh

    phase = torch.where((state.knew == state.kk - 1) | (state.kk == opts.maxord), 1, state.phase)

    # ---- phase 0: raise order and double step (impl_complete_step.rs:43-52)
    hnew0 = 2.0 * state.hh
    tmp0 = hnew0.abs() * state.hmax_inv
    hnew0 = torch.where(tmp0 > 1.0, hnew0 / smask_den(tmp0), hnew0)
    do_startup_grow = (phase == 0) & (nst > 1)
    kk_p0 = torch.where(do_startup_grow, state.kk + 1, state.kk)
    hh_p0 = torch.where(do_startup_grow, hnew0, state.hh)
    rr_p0 = state.rr

    # ---- phase 1: order selection (impl_complete_step.rs:54-121)
    kkf = state.kk.to(dtype)
    # err_kp1 from ||ee - phi[kk+1]|| (impl_complete_step.rs:74-78); the
    # index is clamped: the estimate is used only when kk < maxord
    kp1_idx = (state.kk + 1).clamp(max=C.MXORDP1 - 1)
    enorm_kp1 = _norm(state, problem, opts, state.ee - take_row(state.phi, kp1_idx))
    err_kp1 = enorm_kp1 / (kkf + 2.0)

    terr_k = (kkf + 1.0) * err_k
    terr_kp1 = (kkf + 2.0) * err_kp1
    terr_km1 = kkf * err_km1

    lower = torch.full_like(state.kk, _LOWER)
    maintain = torch.full_like(state.kk, _MAINTAIN)
    raise_ = torch.full_like(state.kk, _RAISE)
    # kk == 1 branch (impl_complete_step.rs:85-90)
    action_k1 = torch.where(terr_kp1 >= 0.5 * terr_k, maintain, raise_)
    # kk > 1 branch (impl_complete_step.rs:91-100)
    action_kn = torch.where(
        terr_km1 <= torch.minimum(terr_k, terr_kp1),
        lower,
        torch.where(terr_kp1 >= terr_k, maintain, raise_),
    )
    action = torch.where(state.kk == 1, action_k1, action_kn)
    # short-circuit cases that skip the err_kp1 estimate (:63-68)
    action = torch.where((state.kk + 1 >= state.ns) | (kdiff == 1), maintain, action)
    action = torch.where(state.kk == opts.maxord, maintain, action)
    action = torch.where(state.knew == state.kk - 1, lower, action)

    kk_p1 = state.kk + (action == _RAISE).to(torch.int32) - (action == _LOWER).to(torch.int32)
    err_knew = torch.where(
        action == _RAISE, err_kp1, torch.where(action == _LOWER, err_km1, err_k)
    )

    # stepsize ratio rr = (2*err_knew + 1e-4)^(-1/(kk+1)) (:126-146)
    base = 2.0 * err_knew + 1.0e-4
    rr_p1 = spow(base, -1.0 / (kk_p1.to(dtype) + 1.0))
    hnew1_double = 2.0 * state.hh
    tmp1 = hnew1_double.abs() * state.hmax_inv
    hnew1_double = torch.where(tmp1 > 1.0, hnew1_double / smask_den(tmp1), hnew1_double)
    rr_clamped = torch.maximum(torch.full_like(rr_p1, 0.5), torch.minimum(torch.full_like(rr_p1, 0.9), rr_p1))
    hh_p1 = torch.where(
        rr_p1 >= 2.0,
        hnew1_double,
        torch.where(rr_p1 <= 1.0, state.hh * rr_clamped, state.hh),
    )
    rr_p1_out = torch.where(rr_p1 <= 1.0, rr_clamped, rr_p1)

    in_phase0 = phase == 0
    kk = torch.where(in_phase0, kk_p0, kk_p1)
    hh = torch.where(in_phase0, hh_p0, hh_p1)
    rr = torch.where(in_phase0, rr_p0, rr_p1_out)

    # ONE phi construction for both updates (each row is touched by exactly
    # one): save ee into phi[kused+1] for a possible order raise
    # (impl_complete_step.rs:152-156), and the recurrence walking rows
    # kused..0 (:158-176): tmp = ee; tmp += phi[j]; phi[j] = tmp. Under
    # fast_math phi holds unscaled rows: the recurrence takes the phi-star
    # value phi[j] * s[j] (the one rounding the parity mode's set_coeffs
    # makes) and writes true phi rows
    phi = state.phi
    s = phi_star_scale(state) if opts.fast_math else None
    save = (kused < opts.maxord) & mask
    tmp = state.ee
    rows = []
    for j in range(C.MXORDP1 - 1, -1, -1):
        active = (kused >= j) & mask
        new_tmp = tmp + (phi[j] * s[j].unsqueeze(0) if opts.fast_math else phi[j])
        row = torch.where(active, new_tmp, phi[j])
        row = torch.where(save & (kused + 1 == j), state.ee, row)
        tmp = torch.where(active, new_tmp, tmp)
        rows.append(row)
    phi = torch.stack(rows[::-1])

    ee = state.ee if ck is None else torch.where(mask, state.ee * ck, state.ee)
    m = mask
    return state._replace(
        nst=torch.where(m, nst, state.nst),
        kused=torch.where(m, kused, state.kused),
        hused=torch.where(m, hused, state.hused),
        phase=torch.where(m, phase, state.phase),
        kk=torch.where(m, kk, state.kk),
        hh=torch.where(m, hh, state.hh),
        rr=torch.where(m, rr, state.rr),
        phi=phi,
        ee=ee,
    )
