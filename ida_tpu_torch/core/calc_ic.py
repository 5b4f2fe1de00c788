"""IDACalcIC: consistent initial conditions, every lane at once.

Port of ``ida_tpu/core/calc_ic.py`` (C ``ida_ic.c``; the reference only
keeps its constants):

* ``IC_YA_YDP_INIT``: given the differential/algebraic split ``problem.id``,
  solve F(t0, y, y') = 0 for the algebraic components of y and the
  differential components of y', by a damped Newton iteration with
  cj = 1/hic, retried with hic/10 up to MAXNH times.
* ``IC_Y_INIT``: given y', solve for all of y.

Updates (C IDANewyyp): YA_YDP ``y -= lam (1-id) delta``,
``y' -= lam cj id delta``; Y_INIT ``y -= lam delta``, with a halving line
search on lam (up to MAXBACKS, bounded below by C's steptol). Converged
when the WRMS norm of the linearly solved residual is <= 0.01 epcon.

``ida_tpu`` runs this one lane at a time under ``jax.vmap``. Here the lanes
of a batch-native state ([N, *batch]) run together: the h-retry, Newton
and line-search loops are per-lane masked loops (a lane whose outer loop
is done does not run the inner ones; its result would be discarded), and
the exact Jacobian of the IC system is [N, N, *batch], from the unit
tangents shared by every lane, batched through one vmapped jvp. The first
Newton pass reuses the factor and residual of the starting point, which
the JAX module computes twice. A lane that fails keeps its guesses and
reports ok = False.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import constants as C
from ..norms import wrms_norm_bnd
from ..ops.dense_lu import lu_factor_auto, lu_solve_auto
from ..problem import IdaProblem, jacobian
from ..utils.tree import masked_while_loop
from .state import IdaOptions, IdaState

IC_YA_YDP_INIT = 1
IC_Y_INIT = 2
IC_CODES = {"ya_ydp": IC_YA_YDP_INIT, "y": IC_Y_INIT}


class _NewtonIC(NamedTuple):
    yy: torch.Tensor
    yp: torch.Tensor
    fnorm: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor  # bool converged
    failed: torch.Tensor  # bool


class _Search(NamedTuple):
    lam: torch.Tensor
    nback: torch.Tensor
    accepted: torch.Tensor
    yy: torch.Tensor
    yp: torch.Tensor
    fn: torch.Tensor


def ic_jacobian(problem: IdaProblem, t0, yy, yp, cj, id_mask, icopt: int) -> torch.Tensor:
    """The exact Jacobian of the IC system with respect to its unknowns,
    [N, N, *batch]: of ``e -> res(t0, yy + (1-id) e, yp + cj id e)``
    (YA_YDP) or ``e -> res(t0, yy + e, yp)`` (Y_INIT), at e = 0, by
    :func:`ida_tpu_torch.problem.jacobian` (one vmapped jvp)."""
    if icopt == IC_YA_YDP_INIT:
        def f(e):
            return problem.res(t0, yy + (1.0 - id_mask) * e, yp + cj * id_mask * e)
    else:
        def f(e):
            return problem.res(t0, yy + e, yp)

    return jacobian(f, torch.zeros_like(yy))


def calc_ic(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    tol,
    icopt: int,
    tout1,
) -> Tuple[IdaState, torch.Tensor]:
    """Consistent (y0, y'0) for every lane of ``state`` (one lane, or
    batch-native). Returns (state, ok [*batch]); where ok, the corrected
    values are in phi[0]/phi[1] and yy/yp."""
    dtype, dev = state.dtype, state.tn.device
    n = problem.n
    t0 = state.tn
    bnd = t0.dim()
    yy0, yp0 = state.phi[0], state.phi[1]
    if icopt == IC_YA_YDP_INIT:
        if problem.id is None:
            raise ValueError("IC_YA_YDP_INIT requires problem.id (diff/alg split)")
        id_mask = problem.id.to(device=dev, dtype=dtype).reshape((n,) + (1,) * bnd)
    elif icopt == IC_Y_INIT:
        id_mask = None
    else:
        raise ValueError(f"icopt must be IC_YA_YDP_INIT or IC_Y_INIT, got {icopt!r}")
    tout1 = torch.as_tensor(tout1, dtype=dtype, device=dev)

    # the initial artificial step hic, and the error weights (computed here,
    # as C IDACalcIC does: calc_ic runs before the first solve)
    tdist = (tout1 - t0).abs()
    hic = 0.001 * tdist
    ewt = tol.ewt_set(yy0)
    ypnorm = wrms_norm_bnd(yp0, ewt, n, bnd)
    hic = torch.where(ypnorm > 0.5 / hic, 0.5 / ypnorm, hic)
    hic = torch.where(tout1 < t0, -hic, hic)
    epsic = 0.01 * state.epcon
    steptol = torch.finfo(dtype).eps ** (2.0 / 3.0)

    def factor_at(yy, yp, cj):
        return lu_factor_auto(ic_jacobian(problem, t0, yy, yp, cj, id_mask, icopt))

    def fnorm_of(yy, yp, f):
        # C IDAfnorm: the norm of the linearly solved residual
        delta = lu_solve_auto(f, problem.res(t0, yy, yp))
        return delta, wrms_norm_bnd(delta, ewt, n, bnd)

    def apply(yy, yp, delta, lam, cj):
        if icopt == IC_YA_YDP_INIT:
            return yy - lam * (1.0 - id_mask) * delta, yp - lam * cj * id_mask * delta
        return yy - lam * delta, yp

    def newton_ic(cj, running):
        """Damped Newton from (yy0, yp0) with a fresh Jacobian every
        iteration (C IDANewtonIC/IDALineSrch). Lanes not ``running`` start
        failed."""
        f0 = factor_at(yy0, yp0, cj)
        delta0, fnorm0 = fnorm_of(yy0, yp0, f0)
        passes = 0

        def cond(c: _NewtonIC):
            return ~(c.done | c.failed)

        def body(c: _NewtonIC):
            nonlocal passes
            if passes == 0:  # every lane is still at (yy0, yp0)
                f, delta_c, fnorm_c = f0, delta0, fnorm0
            else:
                f = factor_at(c.yy, c.yp, cj)
                delta_c, fnorm_c = fnorm_of(c.yy, c.yp, f)
            passes += 1
            # line search lam = 1, 1/2, ...: the first lam that reduces
            # fnorm enough (Armijo, C ALPHA) wins; a step below C's steptol
            # is a failure
            rlmin = torch.full_like(fnorm_c, steptol) / torch.maximum(
                fnorm_c, torch.full_like(fnorm_c, steptol))
            searching = cond(c)

            def ls_cond(s: _Search):
                return ~s.accepted & (s.nback < C.MAXBACKS) & (s.lam >= rlmin) & searching

            def ls_body(s: _Search):
                yyt, ypt = apply(c.yy, c.yp, delta_c, s.lam, cj)
                _, ft = fnorm_of(yyt, ypt, f)
                good = ft <= (1.0 - C.ALPHA_LS * s.lam) * fnorm_c
                return _Search(
                    lam=s.lam * 0.5, nback=s.nback + 1, accepted=s.accepted | good,
                    yy=torch.where(good, yyt, s.yy), yp=torch.where(good, ypt, s.yp),
                    fn=torch.where(good, ft, s.fn),
                )

            s = masked_while_loop(ls_cond, ls_body, _Search(
                lam=torch.ones_like(fnorm_c), nback=torch.zeros_like(c.it),
                accepted=torch.zeros_like(c.done), yy=c.yy, yp=c.yp, fn=fnorm_c,
            ))
            it = c.it + 1
            done = s.fn <= epsic
            failed = (~s.accepted | (it >= C.MAXNI)) & ~done
            return _NewtonIC(yy=s.yy, yp=s.yp, fnorm=s.fn, it=it, done=done, failed=failed)

        out = masked_while_loop(cond, body, _NewtonIC(
            yy=yy0, yp=yp0, fnorm=fnorm0, it=torch.zeros(t0.shape, dtype=torch.int32, device=dev),
            done=fnorm0 <= epsic, failed=(f0.fail_col > 0) | ~running,
        ))
        return out.yy, out.yp, out.done & ~out.failed

    # h-retry loop (YA_YDP only; Y_INIT has no cj dependence)
    max_nh = C.MAXNH if icopt == IC_YA_YDP_INIT else 1

    def h_cond(c):
        return ~c[4] & (c[3] < max_nh)

    def h_body(c):
        yy, yp, hic_c, nh, _ = c
        cj = 1.0 / hic_c if icopt == IC_YA_YDP_INIT else torch.zeros_like(hic_c)
        yyn, ypn, okn = newton_ic(cj, h_cond(c))
        return (torch.where(okn, yyn, yy), torch.where(okn, ypn, yp), hic_c * 0.1, nh + 1, okn)

    yy_f, yp_f, _, _, ok = masked_while_loop(h_cond, h_body, (
        yy0, yp0, hic, torch.zeros(t0.shape, dtype=torch.int32, device=dev),
        torch.zeros(t0.shape, dtype=torch.bool, device=dev),
    ))
    phi = state.phi.clone()
    phi[0] = torch.where(ok, yy_f, yy0)
    phi[1] = torch.where(ok, yp_f, yp0)
    state = state._replace(
        phi=phi, yy=torch.where(ok, yy_f, state.yy), yp=torch.where(ok, yp_f, state.yp),
    )
    return state, ok
