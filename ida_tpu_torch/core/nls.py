"""Nonlinear system solution for one step attempt (L3 layer), dense path.

Port of ``ida_tpu/core/nls.py`` for ``linear_solver="dense"``,
``ls_precision="full"`` (reference ``nonlinear_solve`` src/lib.rs:787-890,
``crates/nonlinear/src/newton.rs:51-167``, ``src/ida_nls.rs:105-266``,
``src/ida_ls.rs:232-455``). The outer (retry with a fresh Jacobian) and
inner (Newton iteration) loops are masked while loops: every lane runs its
own iteration count, finished lanes are frozen. The LU factor and solve go
through ``ops.dense_lu.lu_factor_auto``/``lu_solve_auto``: the CUDA kernel
on the card, the plain version on the CPU.

Not ported here: the inequality-constraints block (ida_tpu/core/nls.py:636-681) and the
Krylov, band and mixed-precision linear solvers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import constants as C
from ..norms import wrms_norm_bnd
from ..ops.dense_lu import DenseLU, lu_factor_auto, lu_solve_auto
from ..problem import IdaProblem
from ..utils.numerics import pow_
from ..utils.tree import masked_while_loop, tree_where
from .state import IdaOptions, IdaState

# internal Newton loop status
_CONTINUE = 0
_OK = 1
_CONV_RECVR = 2  # recoverable: retry with fresh Jacobian or fail the attempt
_LSETUP_RECVR = 3  # singular/non-finite Jacobian in lsetup
_RES_RECVR = 4  # non-finite residual (C IDA_RES_RECVR)
_LSOLVE_RECVR = 5  # failed linear solve (C IDA_LSOLVE_RECVR)


def _res_ok(r: torch.Tensor) -> torch.Tensor:
    """Per-lane recoverable-residual channel: a non-finite entry marks the
    lane's residual evaluation recoverably failed."""
    return torch.isfinite(r).all(dim=0)


class _Lin(NamedTuple):
    """Linear-solver state threaded through the Newton loops."""

    lu: torch.Tensor
    piv: torch.Tensor
    cjold: torch.Tensor
    cjratio: torch.Tensor
    nje: torch.Tensor
    nsetups: torch.Tensor


class _Inner(NamedTuple):
    """Carry of the inner Newton iteration: only what it mutates. yy/yp are
    ``predict + ycor`` and savres equals ``delta`` (dense path), so they are
    rebuilt where needed. Counters tally in local int32 lanes."""

    ycor: torch.Tensor
    delta: torch.Tensor
    oldnrm: torch.Tensor
    ss: torch.Tensor
    curiter: torch.Tensor  # int32 m
    istatus: torch.Tensor  # int32
    knni: torch.Tensor  # int32 Newton iterations this nonlinear_solve
    kre: torch.Tensor  # int32 residual evaluations this nonlinear_solve


class _Outer(NamedTuple):
    inner: _Inner
    lin: _Lin
    ss: torch.Tensor
    call_lsetup: torch.Tensor  # bool
    jcur: torch.Tensor  # bool
    ostatus: torch.Tensor  # int32


def _lsetup(
    state: IdaState, problem: IdaProblem, lin: _Lin, yy, yp, savres
) -> Tuple[_Lin, torch.Tensor]:
    """idaNlsLSetup + idaLsSetup (reference src/ida_nls.rs:156-187,
    src/ida_ls.rs:232-290): J = dF/dy + cj*dF/dy' at the predictor, LU-factored."""
    j = problem.sys_jacobian(state.tn, state.cj, yy, yp, savres)
    f = lu_factor_auto(j)
    # singular (pivot == 0) OR non-finite Jacobian => recoverable lsetup
    # failure (a NaN pivot passes the == 0 test)
    fail = (f.fail_col > 0) | ~torch.isfinite(j).all(dim=0).all(dim=0)
    lin = lin._replace(
        lu=f.lu, piv=f.piv, nje=lin.nje + 1, nsetups=lin.nsetups + 1,
        cjold=state.cj, cjratio=torch.ones_like(state.cj),
    )
    return lin, fail


def _newton_iterate(
    state: IdaState, problem: IdaProblem, opts: IdaOptions, lin: _Lin, inner0: _Inner
) -> _Inner:
    """The inner Newton loop (reference newton.rs:96-135 + idaNlsConvTest
    src/ida_nls.rs:218-266). ``lin`` and the predictor/weights in ``state``
    are loop invariants."""
    cj, tn = state.cj, state.tn
    ewt, eps_newt, toldel = state.ewt, state.eps_newt, state.toldel
    yypredict, yppredict = state.yypredict, state.yppredict
    bnd = cj.dim()
    zero = torch.zeros_like(cj)
    # idaLsSolve's cj-change correction (reference src/ida_ls.rs:406-410)
    scale = torch.where(lin.cjratio != 1.0, 2.0 / (1.0 + lin.cjratio), torch.ones_like(cj))
    factored = DenseLU(lin.lu, lin.piv, torch.zeros(cj.shape, dtype=torch.int32, device=cj.device))

    def cond(c: _Inner) -> torch.Tensor:
        return c.istatus == _CONTINUE

    def body(c: _Inner) -> _Inner:
        m = c.curiter
        first = m == 0
        x = lu_solve_auto(factored, -c.delta) * scale
        ycor = c.ycor + x

        # --- convergence test (idaNlsConvTest) ---
        delnrm = wrms_norm_bnd(x, ewt, problem.n, bnd)
        oldnrm = torch.where(first, delnrm, c.oldnrm)
        conv_direct = first & (delnrm <= 1.0e-4 * toldel)
        expo = 1.0 / m.clamp(min=1).to(cj.dtype)
        rate = torch.where(first, zero, pow_(delnrm / oldnrm, expo))
        diverged = ~first & (rate > C.RATEMAX)
        ss = torch.where(~first, rate / (1.0 - rate), c.ss)
        converged = conv_direct | (ss * delnrm <= eps_newt)

        curiter = m + 1
        continuing = torch.full_like(c.istatus, _CONTINUE)
        exhausted = curiter >= opts.maxnlsit
        istatus = torch.where(
            diverged,
            _CONV_RECVR,
            torch.where(converged, _OK, torch.where(exhausted, _CONV_RECVR, continuing)),
        )

        # re-evaluate the residual only if iterating again; a non-finite
        # result ends the Newton loop with the recoverable-residual kind
        keep = istatus == _CONTINUE
        r = problem.res(tn, yypredict + ycor, yppredict + cj * ycor)
        rbad = keep & ~_res_ok(r)
        istatus = torch.where(rbad, _RES_RECVR, istatus)
        keep_w = keep & ~rbad
        return _Inner(
            ycor=ycor,
            delta=torch.where(keep_w, r, c.delta),
            oldnrm=oldnrm,
            ss=ss,
            curiter=curiter,
            istatus=istatus,
            knni=c.knni + 1,
            kre=c.kre + keep.to(torch.int32),
        )

    return masked_while_loop(cond, body, inner0)


def nonlinear_solve(
    state: IdaState, problem: IdaProblem, opts: IdaOptions, active: torch.Tensor | None = None
) -> Tuple[IdaState, torch.Tensor]:
    """Attempt the nonlinear solve for the current step (reference
    src/lib.rs:787-890). Returns (state, nl_status), nl_status one of
    REC_NONE (ok), REC_CONV, REC_RESIDUAL, REC_LSETUP, REC_LSOLVE. On
    success state.ee/yy/yp hold the accepted correction. Lanes with
    active=False pass through bit for bit and report REC_NONE."""
    bshape, dev = state.tn.shape, state.tn.device
    if active is None:
        active = torch.ones(bshape, dtype=torch.bool, device=dev)

    # first-call initialisation (src/lib.rs:794-799)
    first = state.nst == 0
    cjold = torch.where(first, state.cj, state.cjold)
    ss = torch.where(first, torch.full_like(state.ss, 20.0), state.ss)

    # lsetup decision from the cj ratio (src/lib.rs:804-812)
    cjratio = state.cj / cjold
    lo = (1.0 - C.XRATE) / (1.0 + C.XRATE)
    call_lsetup = (first | (cjratio < lo) | (cjratio > 1.0 / lo)) & active
    ss = torch.where(state.cj != state.cjlast, torch.full_like(ss, 100.0), ss)

    lin0 = _Lin(
        lu=state.lu, piv=state.piv, cjold=cjold, cjratio=cjratio,
        nje=state.nje, nsetups=state.nsetups,
    )
    zero_i = torch.zeros(bshape, dtype=torch.int32, device=dev)

    def fresh_inner(knni, delta, ss, kre) -> _Inner:
        return _Inner(
            ycor=torch.zeros_like(state.yy), delta=delta, oldnrm=state.oldnrm, ss=ss,
            curiter=zero_i,
            istatus=torch.where(active, _CONTINUE, _OK).to(torch.int32),
            knni=knni, kre=kre,
        )

    # --- outer loop: residual -> (lsetup?) -> Newton; one retry with a
    # fresh Jacobian on recoverable failure (newton.rs:73-160)
    def cond(c: _Outer) -> torch.Tensor:
        return c.ostatus == _CONTINUE

    def body(c: _Outer) -> _Outer:
        # residual at the predictor (ycor = 0)
        yy, yp = state.yypredict, state.yppredict
        r = problem.res(state.tn, yy, yp)
        kre = c.inner.kre + 1
        # a non-finite predictor residual is terminal for this attempt and
        # skips the lsetup (no Jacobian at a non-finite point)
        res_bad = ~_res_ok(r)

        lin2, setup_fail = _lsetup(state, problem, c.lin, yy, yp, r)
        do_setup = c.call_lsetup & ~res_bad
        lin = tree_where(do_setup, lin2, c.lin)
        # lsetup refreshes ss to 20 (src/ida_nls.rs:179)
        ss = torch.where(do_setup, torch.full_like(c.ss, 20.0), c.ss)
        setup_fail = do_setup & setup_fail
        jcur = c.jcur | do_setup

        inner0 = fresh_inner(c.inner.knni, r, ss, kre)
        inner_out = _newton_iterate(state, problem, opts, lin, inner0)
        skip_newton = setup_fail | res_bad
        inner = tree_where(~skip_newton, inner_out, inner0)

        # any recoverable inner failure earns ONE retry with a fresh
        # Jacobian if the current one is stale
        recvr = (
            (inner.istatus == _CONV_RECVR)
            | (inner.istatus == _LSOLVE_RECVR)
            | (inner.istatus == _RES_RECVR)
        )
        retry = recvr & ~jcur & ~skip_newton
        ostatus = torch.where(
            setup_fail,
            _LSETUP_RECVR,
            torch.where(res_bad, _RES_RECVR, torch.where(retry, _CONTINUE, inner.istatus)),
        )
        return _Outer(
            inner=inner, lin=lin, ss=inner.ss, call_lsetup=retry,
            jcur=jcur & (inner.istatus != _OK), ostatus=ostatus,
        )

    init = _Outer(
        inner=fresh_inner(zero_i, state.savres, ss, zero_i),
        lin=lin0,
        ss=ss,
        call_lsetup=call_lsetup,
        jcur=torch.zeros(bshape, dtype=torch.bool, device=dev),
        # inactive lanes start terminal so the Newton loops never touch them
        ostatus=torch.where(active, _CONTINUE, _OK).to(torch.int32),
    )
    out = masked_while_loop(cond, body, init)
    inner, lin = out.inner, out.lin

    # fold the loop-local pieces back into the state (inactive lanes keep
    # every field: their loops never ran)
    a = active
    state = state._replace(
        lu=lin.lu, piv=lin.piv,
        cjold=torch.where(a, lin.cjold, state.cjold),
        cjratio=torch.where(a, lin.cjratio, state.cjratio),
        nje=lin.nje, nsetups=lin.nsetups,
        nni=state.nni + inner.knni.to(state.nni.dtype),
        nre=state.nre + inner.kre.to(state.nre.dtype),
        oldnrm=torch.where(a, inner.oldnrm, state.oldnrm),
        ss=torch.where(a, inner.ss, state.ss),
        savres=inner.delta,
    )

    # apply the final correction (src/lib.rs:845-849)
    ee = torch.where(a, inner.ycor, state.ee)
    yy = torch.where(a, state.yypredict + inner.ycor, state.yy)
    yp = torch.where(a, state.yppredict + state.cj * inner.ycor, state.yp)
    state = state._replace(ee=ee, yy=yy, yp=yp)

    o = out.ostatus
    nl_status = torch.where(
        o == _OK,
        C.REC_NONE,
        torch.where(
            o == _LSETUP_RECVR,
            C.REC_LSETUP,
            torch.where(
                o == _RES_RECVR,
                C.REC_RESIDUAL,
                torch.where(o == _LSOLVE_RECVR, C.REC_LSOLVE, C.REC_CONV),
            ),
        ),
    )
    nl_status = torch.where(active, nl_status, C.REC_NONE).to(torch.int32)
    return state, nl_status
