"""BDF coefficient recurrences, predictor, and failure restore (L4 layer).

Port of ``ida_tpu/core/coeffs.py`` (reference ``set_coeffs``
src/lib.rs:722-782, ``predict`` :894-959, ``restore`` :1044-1083, ``reset``
:1249-1252). Loops over the current order ``kk`` are unrolled over the
static MAXORD bound with per-index masks; the arithmetic of every active
row is the reference's, in its order.

``mask``: lanes with mask=False pass through bit for bit, so a self-masked
loop body needs no full-state merge afterwards.

``fast_math`` (``IdaOptions.fast_math``, not C-parity): phi stays unscaled
in the state; :func:`phi_star_scale` gives the phi -> phi-star row factors
that :func:`predict`, the error test and ``complete_step`` fold in, and
:func:`restore` has no phi to un-scale.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import constants as C
from ..utils.ad_mode import smask_den
from ..utils.numerics import sum0
from ..utils.profiling import scope
from ..utils.tree import take1
from .state import IdaState


def kidx(state: IdaState) -> torch.Tensor:
    """[K1, 1 x batch-ndim] int32 row index, aligned with [K1, *batch]."""
    bnd = state.kk.dim()
    return torch.arange(C.MXORDP1, dtype=torch.int32, device=state.phi.device).reshape(
        (C.MXORDP1,) + (1,) * bnd
    )


def _ones_mask(state: IdaState) -> torch.Tensor:
    return torch.ones(state.tn.shape, dtype=torch.bool, device=state.tn.device)


def phi_star_scale(state: IdaState) -> torch.Tensor:
    """The phi -> phi-star row scale of fast_math: beta on rows ns..kk,
    exactly 1 elsewhere ([K1, *batch])."""
    idx = kidx(state)
    sel = (idx >= state.ns) & (idx <= state.kk)
    return torch.where(sel, state.beta, torch.ones_like(state.beta))


@scope("set_coeffs")
def set_coeffs(state: IdaState, mask: torch.Tensor | None = None,
               fast_math: bool = False) -> Tuple[IdaState, torch.Tensor]:
    """Method coefficients for the current (hh, kk); returns (state, ck)
    with ck the variable-stepsize error coefficient. ``fast_math`` leaves
    phi unscaled (module doc)."""
    dtype = state.dtype
    kk = state.kk
    if mask is None:
        mask = _ones_mask(state)

    # ns tracking (src/lib.rs:727-731)
    ns_new = torch.where((state.hh != state.hused) | (state.kk != state.kused), 0, state.ns)
    ns_new = torch.minimum(ns_new + 1, state.kused + 2)
    ns = torch.where(mask, ns_new, state.ns)

    update = (kk + 1 >= ns) & mask  # (src/lib.rs:731)
    hh = state.hh
    one = torch.ones_like(hh)

    # whole-array form of the reference recurrence (src/lib.rs:732-748)
    psi_o = state.psi
    psi_n = torch.cat([hh.unsqueeze(0), psi_o[:-1] + hh])
    alpha_rows = [one]
    for i in range(1, C.MXORDP1):
        alpha_rows.append(hh / smask_den(psi_n[i]))
    beta_rows = [one]
    sigma_rows = [one]
    gamma_rows = [torch.zeros_like(hh)]
    for i in range(1, C.MXORDP1):
        beta_rows.append(beta_rows[i - 1] * psi_n[i - 1] / smask_den(psi_o[i - 1]))
        sigma_rows.append((i * sigma_rows[i - 1]) * alpha_rows[i])
        gamma_rows.append(gamma_rows[i - 1] + alpha_rows[i - 1] / smask_den(hh))

    idx = kidx(state)
    row_act = update & (idx <= kk)
    psi = torch.where(row_act, psi_n, psi_o)
    alpha = torch.where(row_act, torch.stack(alpha_rows), state.alpha)
    beta = torch.where(row_act, torch.stack(beta_rows), state.beta)
    sigma = torch.where(row_act, torch.stack(sigma_rows), state.sigma)
    gamma = torch.where(row_act, torch.stack(gamma_rows), state.gamma)

    # alphas, alpha0 sums over i = 0..kk-1 (src/lib.rs:750-756); the
    # reference forms 1/(i+1) in float64 and casts the sum to the state dtype
    in_sum = idx < kk
    inv = 1.0 / (idx.to(torch.float64) + 1.0)
    alphas = -sum0(torch.where(in_sum, inv, torch.zeros_like(inv))).to(dtype)
    alpha0 = -sum0(torch.where(in_sum, alpha, torch.zeros_like(alpha)))

    # leading coefficient cj, saving cjlast (src/lib.rs:758-760)
    cjlast = torch.where(mask, state.cj, state.cjlast)
    cj = torch.where(mask, -alphas / smask_den(state.hh), state.cj)

    # error coefficient ck (src/lib.rs:762-764)
    alpha_kk = take1(alpha, kk)
    ck = torch.abs(alpha_kk + alphas - alpha0)
    ck = torch.maximum(ck, alpha_kk)

    # phi -> phi-star: scale rows ns..kk by beta (src/lib.rs:766-779);
    # fast_math defers the multiply into the consumers (phi_star_scale)
    if fast_math:
        phi = state.phi
    else:
        scale_row = (idx >= ns) & (idx <= kk) & mask
        phi = state.phi * torch.where(scale_row, beta, torch.ones_like(beta)).unsqueeze(1)

    state = state._replace(
        ns=ns, psi=psi, alpha=alpha, beta=beta, sigma=sigma, gamma=gamma,
        cj=cj, cjlast=cjlast, phi=phi,
    )
    return state, ck


@scope("predict")
def predict(state: IdaState, mask: torch.Tensor | None = None,
            fast_math: bool = False) -> IdaState:
    """yypredict = sum_{j<=kk} phi[j], yppredict = sum_{1<=j<=kk} gamma[j]
    phi[j] (src/lib.rs:894-959). ``fast_math``: phi is unscaled, and
    :func:`phi_star_scale` goes into the row coefficients (the yy sum is the
    same bit for bit; the yp sum multiplies phi by (beta * gamma))."""
    idx = kidx(state)
    yy_mask = (idx <= state.kk).to(state.dtype)
    yp_coef = torch.where((idx >= 1) & (idx <= state.kk), state.gamma, torch.zeros_like(state.gamma))
    if fast_math:
        s = phi_star_scale(state)
        yy_mask = yy_mask * s
        yp_coef = yp_coef * s
    yypredict = sum0(state.phi * yy_mask.unsqueeze(1))
    yppredict = sum0(state.phi * yp_coef.unsqueeze(1))
    if mask is not None:
        yypredict = torch.where(mask, yypredict, state.yypredict)
        yppredict = torch.where(mask, yppredict, state.yppredict)
    return state._replace(yypredict=yypredict, yppredict=yppredict)


@scope("restore")
def restore(state: IdaState, saved_t: torch.Tensor, mask: torch.Tensor | None = None,
            fast_math: bool = False) -> IdaState:
    """Undo a failed step attempt: restore tn and psi, un-scale phi-star back
    to phi (src/lib.rs:1044-1083). ``fast_math``: phi was never scaled and
    is left as it is."""
    idx = kidx(state)
    if mask is None:
        mask = _ones_mask(state)
    # psi[j-1] = psi[j] - hh for j = 1..kk
    shifted = torch.roll(state.psi, -1, dims=0) - state.hh
    psi = torch.where((idx < state.kk) & mask, shifted, state.psi)
    if fast_math:
        phi = state.phi
    else:
        # phi rows ns..kk multiplied by 1/beta
        unscale = (idx >= state.ns) & (idx <= state.kk) & mask
        phi = state.phi * torch.where(unscale, 1.0 / smask_den(state.beta),
                                      torch.ones_like(state.beta)).unsqueeze(1)
    return state._replace(tn=torch.where(mask, saved_t, state.tn), psi=psi, phi=phi)


@scope("reset")
def reset(state: IdaState, mask: torch.Tensor | None = None) -> IdaState:
    """nst == 0 re-prediction: psi[0] = hh, phi[1] *= rr — C ``IDAReset``
    semantics (only the h-scaled derivative row; the reference's scaling of
    the whole phi array, src/lib.rs:1249-1252, is a bug not carried over)."""
    if mask is None:
        mask = _ones_mask(state)
    idx = kidx(state)
    one = torch.ones_like(state.rr)
    phi = state.phi * torch.where((idx == 1) & mask, state.rr, one).unsqueeze(1)
    psi = torch.where((idx == 0) & mask, state.hh, state.psi)
    return state._replace(psi=psi, phi=phi)
