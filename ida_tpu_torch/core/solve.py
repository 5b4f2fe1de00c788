"""The main integration driver (L4 top).

Port of ``ida_tpu/core/solve.py::solve`` (reference ``solve``
src/impl_solve.rs:69-377 and the stop tests src/impl_stop_test.rs:36-211)
for TASK_NORMAL and TASK_ONE_STEP, without roots: first-call
initialisation, pre-step stop tests, then one masked loop over step ATTEMPTS
(mxstep guard, ewt refresh, accuracy test, attempt, completion, post-step
stop test). The loop body is self-masked: finished lanes pass through bit
for bit. The interpolation an exiting lane needs is deferred to one pass
after the loop. The budgeted form (``max_attempts``/``resume_carry``) stops
the loop after a fixed number of attempts and resumes it exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import constants as C
from ..problem import IdaProblem
from ..tol_control import TolControl
from ..utils.tree import tree_where
from .coeffs import kidx
from .complete_step import complete_step
from .error_test import _norm
from .interp import _eps, get_solution
from .state import IdaOptions, IdaState
from .step import attempt_once, step_begin

TASK_NORMAL = 0
TASK_ONE_STEP = 1


def _ewt_invalid(ewt: torch.Tensor) -> torch.Tensor:
    """Per-component BAD_EWT predicate: ewt <= 0 or non-finite (C
    IDAEwtSetSS/SV check the denominator before inverting)."""
    return ~(ewt > 0.0) | ~torch.isfinite(ewt)


def _any_data(x: torch.Tensor, bnd: int) -> torch.Tensor:
    """``any`` over the leading data axes of [..., *batch]."""
    for _ in range(x.dim() - bnd):
        x = x.any(dim=0)
    return x


def _first_call_init(
    state: IdaState, problem: IdaProblem, opts: IdaOptions, tol: TolControl, tout
) -> Tuple[IdaState, torch.Tensor]:
    """First-call block (reference impl_solve.rs:84-173). Returns
    (state, istate); istate == CONTINUE unless input checks fail."""
    bnd = state.tn.dim()
    istate = torch.full(state.tn.shape, C.CONTINUE, dtype=torch.int32, device=state.tn.device)

    # initial_setup: error weights from phi[0] (src/lib.rs:537-545)
    ewt = tol.ewt_set(state.phi[0])
    istate = torch.where(_any_data(_ewt_invalid(ewt), bnd), C.BAD_EWT, istate)
    state = state._replace(ewt=ewt)

    # tout sanity (impl_solve.rs:97-109)
    tdist = (tout - state.tn).abs()
    troundoff = 2.0 * _eps(state) * (state.tn.abs() + tout.abs())
    istate = torch.where((tdist == 0.0) | (tdist < troundoff), C.ILL_INPUT, istate)

    # initial step selection (impl_solve.rs:111-133)
    hh = state.hin
    istate = torch.where((hh != 0.0) & ((tout - state.tn) * hh < 0.0), C.ILL_INPUT, istate)
    hh_auto = 0.001 * tdist
    ypnorm = _norm(state, problem, opts, state.phi[1])
    hh_auto = torch.where(ypnorm > 2.0 / hh_auto, 0.5 / ypnorm, hh_auto)
    hh_auto = torch.where(tout < state.tn, -hh_auto, hh_auto)
    hh = torch.where(hh == 0.0, hh_auto, hh)

    # hmax clamp (impl_solve.rs:135-138)
    rh = hh.abs() * state.hmax_inv
    hh = torch.where(rh > 1.0, hh / rh, hh)

    # tstop guard (impl_solve.rs:140-155)
    bad_tstop = state.tstop_set & ((state.tstop - state.tn) * hh <= 0.0)
    istate = torch.where(bad_tstop, C.ILL_INPUT, istate)
    clamp = state.tstop_set & ((state.tn + hh - state.tstop) * hh > 0.0)
    hh = torch.where(clamp, (state.tstop - state.tn) * (1.0 - 4.0 * _eps(state)), hh)

    state = state._replace(
        hh=hh, h0u=hh, kk=torch.zeros_like(state.kk), kused=torch.zeros_like(state.kused)
    )

    # phi[1] *= hh; Newton constants (impl_solve.rs:166-172)
    row_scale = torch.where(kidx(state) == 1, hh, torch.ones_like(hh))
    state = state._replace(
        phi=state.phi * row_scale.unsqueeze(1),
        eps_newt=state.epcon,
        toldel=1.0e-4 * state.epcon,
    )
    return state, istate


def _stop_test1(state: IdaState, tout, tret, itask: int):
    """Pre-step stop tests (reference impl_stop_test.rs:36-125).
    Returns (state, tret, istate)."""
    cont = torch.full(state.tn.shape, C.CONTINUE, dtype=torch.int32, device=state.tn.device)
    bad_tstop = state.tstop_set & ((state.tn - state.tstop) * state.hh > 0.0)
    istate = torch.where(bad_tstop, C.ILL_INPUT, cont)
    troundoff = 100.0 * _eps(state) * (state.tn.abs() + state.hh.abs())

    if itask == TASK_NORMAL:
        # tout == tretlast (impl_stop_test.rs:54-58): return without interp
        hit_prev = tout == state.tretlast
        # tn past tout (:60-65)
        past_tout = (state.tn - tout) * state.hh >= 0.0
        st_interp, ok = get_solution(state, tout)
        # near tstop (:67-83)
        at_tstop = state.tstop_set & ((state.tn - state.tstop).abs() <= troundoff)
        st_tstop, _ = get_solution(state, state.tstop)

        # priority: hit_prev, then past_tout, then tstop
        sel_tstop = at_tstop & ~(hit_prev | past_tout)
        sel_tout = past_tout & ok & ~hit_prev
        state = tree_where(sel_tstop, st_tstop, tree_where(sel_tout, st_interp, state))

        hit_or_past = hit_prev | past_tout
        newret = torch.where(hit_or_past, tout, torch.where(sel_tstop, state.tstop, tret))
        returning = hit_or_past | sel_tstop
        tret = torch.where(returning, newret, tret)
        state = state._replace(
            tretlast=torch.where(returning, newret, state.tretlast),
            tstop_set=state.tstop_set & ~sel_tstop,
        )
        code = torch.where(
            hit_or_past,
            torch.where(past_tout & ~(hit_prev | ok), C.BAD_T, C.SUCCESS),
            torch.where(sel_tstop, C.TSTOP_RETURN, C.CONTINUE),
        ).to(torch.int32)
        istate = torch.where(istate != C.CONTINUE, istate, code)
    else:
        # ONE_STEP (impl_stop_test.rs:94-123)
        past_last = (state.tn - state.tretlast) * state.hh > 0.0
        st_interp, _ = get_solution(state, state.tn)
        at_tstop = state.tstop_set & ((state.tn - state.tstop).abs() <= troundoff)
        st_tstop, _ = get_solution(state, state.tstop)
        sel_tstop = at_tstop & ~past_last
        state = tree_where(past_last, st_interp, tree_where(sel_tstop, st_tstop, state))
        newret = torch.where(past_last, state.tn, torch.where(sel_tstop, state.tstop, tret))
        returning = past_last | sel_tstop
        tret = torch.where(returning, newret, tret)
        state = state._replace(tretlast=torch.where(returning, newret, state.tretlast))
        code = torch.where(
            past_last, C.SUCCESS, torch.where(sel_tstop, C.TSTOP_RETURN, C.CONTINUE)
        ).to(torch.int32)
        istate = torch.where(istate != C.CONTINUE, istate, code)

    # clamp hh to land on tstop (both tasks)
    clamp = state.tstop_set & (istate == C.CONTINUE) & (
        (state.tn + state.hh - state.tstop) * state.hh > 0.0
    )
    state = state._replace(
        hh=torch.where(clamp, (state.tstop - state.tn) * (1.0 - 4.0 * _eps(state)), state.hh)
    )
    return state, tret, istate


def _stop_test2(state: IdaState, tout, tret, itask: int):
    """Post-step stop tests (reference impl_stop_test.rs:146-211) with the
    interpolation DEFERRED: returns (state, tret, istate, ikind, itgt) where
    ikind/itgt say which interpolation the exiting lane needs; the caller
    applies it once after the loop (lanes freeze at exit, so this is
    bit-identical to interpolating inline)."""
    troundoff = 100.0 * _eps(state) * (state.tn.abs() + state.hh.abs())
    zero_t = torch.zeros_like(state.tn)
    at_tstop = state.tstop_set & ((state.tn - state.tstop).abs() <= troundoff)

    if itask == TASK_NORMAL:
        past_tout = (state.tn - tout) * state.hh >= 0.0
        sel_tstop = at_tstop & ~past_tout
        ikind = (past_tout | sel_tstop).to(torch.int32)
        itgt = torch.where(past_tout, tout, torch.where(sel_tstop, state.tstop, zero_t))
        newret = torch.where(past_tout, tout, torch.where(sel_tstop, state.tstop, tret))
        returning = past_tout | sel_tstop
        tret = torch.where(returning, newret, tret)
        state = state._replace(
            tretlast=torch.where(returning, newret, state.tretlast),
            tstop_set=state.tstop_set & ~sel_tstop,
        )
        istate = torch.where(
            past_tout, C.SUCCESS, torch.where(sel_tstop, C.TSTOP_RETURN, C.CONTINUE)
        ).to(torch.int32)
    else:
        ikind = at_tstop.to(torch.int32)
        itgt = torch.where(at_tstop, state.tstop, zero_t)
        tret = torch.where(at_tstop, state.tstop, state.tn)
        state = state._replace(tretlast=tret, tstop_set=state.tstop_set & ~at_tstop)
        istate = torch.where(at_tstop, C.TSTOP_RETURN, C.SUCCESS).to(torch.int32)

    clamp = state.tstop_set & (istate == C.CONTINUE) & (
        (state.tn + state.hh - state.tstop) * state.hh > 0.0
    )
    state = state._replace(
        hh=torch.where(clamp, (state.tstop - state.tn) * (1.0 - 4.0 * _eps(state)), state.hh)
    )
    return state, tret, istate, ikind, itgt


class _Loop(NamedTuple):
    state: IdaState
    tret: torch.Tensor
    istate: torch.Tensor
    nstloc: torch.Tensor
    saved_t: torch.Tensor
    ncf: torch.Tensor
    nef: torch.Tensor
    fresh: torch.Tensor  # bool: next iteration begins a new step
    ikind: torch.Tensor  # int32: deferred interpolation (0 none, 1 at itgt)
    itgt: torch.Tensor  # target time of the deferred interpolation


def _step_preamble(state: IdaState, problem, opts, tol, nstloc, istate, tret, ikind, itgt, active):
    """Per-step guards (impl_solve.rs:249-308): mxstep, ewt refresh +
    positivity, too-much-accuracy, for the lanes about to start a new step."""
    too_much = active & (nstloc >= opts.mxstep)
    refresh = active & (state.nst > 0)
    ewt = tol.ewt_set(state.phi[0])
    ewt_bad = refresh & _any_data(_ewt_invalid(ewt), state.tn.dim())
    state = state._replace(ewt=torch.where(refresh, ewt, state.ewt))
    nrm = _norm(state, problem, opts, state.phi[0])
    tolsf = _eps(state) * nrm
    too_acc = active & (tolsf > 1.0)
    state = state._replace(tolsf=torch.where(too_acc, tolsf * 10.0, state.tolsf))

    abort = too_much | ewt_bad | too_acc
    code = torch.where(
        too_much, C.TOO_MUCH_WORK, torch.where(ewt_bad, C.BAD_EWT, C.TOO_MUCH_ACC)
    ).to(torch.int32)
    istate = torch.where(abort, code, istate)
    tret = torch.where(abort, state.tn, tret)
    state = state._replace(tretlast=torch.where(abort, state.tn, state.tretlast))
    ikind = torch.where(abort, 1, ikind)
    itgt = torch.where(abort, state.tn, itgt)
    return state, istate, tret, ikind, itgt


def _run_attempt_loop(init: _Loop, problem, opts, tol, tout, itask: int, max_attempts=None):
    """The flattened internal loop over step ATTEMPTS (impl_solve.rs:246-373
    + src/lib.rs:613-711): each iteration is one attempt; a lane that lands
    its step also does the completion and stop-test work. With
    ``max_attempts`` the loop stops after that many iterations and also
    returns the carry to resume from."""

    def body(c: _Loop) -> _Loop:
        # SELF-MASKED: every write is masked, finished lanes pass through
        state, tret, istate = c.state, c.tret, c.istate
        active = c.istate == C.CONTINUE
        fresh = c.fresh & active

        # step begin: save tn, first-step init, reset local failure counters
        saved_t = torch.where(fresh, state.tn, c.saved_t)
        state = step_begin(state, mask=fresh)
        ncf = torch.where(fresh, 0, c.ncf)
        nef = torch.where(fresh, 0, c.nef)

        st2, success, fatal, ck, err_k, err_km1, ncf, nef = attempt_once(
            state, problem, opts, saved_t, ncf, nef, active=active
        )
        step_failed = fatal != C.CONTINUE

        # success epilogue (src/lib.rs:697-708), mask folded in
        st2 = complete_step(st2, problem, opts, err_k, err_km1, ck=ck, mask=success)

        # on fatal attempt failure: y(tn) (deferred), tret = tn
        ikind = torch.where(step_failed, 1, c.ikind)
        itgt = torch.where(step_failed, st2.tn, c.itgt)
        tret = torch.where(step_failed, st2.tn, tret)
        st2 = st2._replace(tretlast=torch.where(step_failed, st2.tn, st2.tretlast))
        istate = torch.where(step_failed, fatal, istate)
        nstloc = torch.where(success, c.nstloc + 1, c.nstloc)

        ok = (istate == C.CONTINUE) & success

        # post-step stop tests (interpolation deferred to after the loop)
        st3, tret3, istate3, ikind3, itgt3 = _stop_test2(st2, tout, tret, itask)
        st2 = tree_where(ok, st3, st2)
        tret = torch.where(ok, tret3, tret)
        istate = torch.where(ok, istate3, istate)
        ikind = torch.where(ok, ikind3, ikind)
        itgt = torch.where(ok, itgt3, itgt)

        # preamble for the NEXT step (lanes that continue)
        nxt = (istate == C.CONTINUE) & success
        st2, istate, tret, ikind, itgt = _step_preamble(
            st2, problem, opts, tol, nstloc, istate, tret, ikind, itgt, nxt
        )
        return _Loop(
            state=st2, tret=tret, istate=istate, nstloc=nstloc, saved_t=saved_t,
            ncf=ncf, nef=nef,
            # retry the same step unless the attempt landed; frozen lanes
            # keep their carried value
            fresh=(active & success) | (~active & c.fresh),
            ikind=ikind, itgt=itgt,
        )

    c = init
    n = 0
    while (max_attempts is None or n < max_attempts) and bool((c.istate == C.CONTINUE).any()):
        c = body(c)
        n += 1
    # the deferred interpolation; a budgeted call applies it to the returned
    # state but not to the carry (only finished lanes have ikind > 0, and
    # get_solution reads phi/psi, never yy/yp, so a resume is unaffected)
    st_i, _ = get_solution(c.state, c.itgt)
    state = tree_where(c.ikind > 0, st_i, c.state)._replace(status=c.istate)
    if max_attempts is None:
        return state, c.tret, c.istate
    return state, c.tret, c.istate, tuple(c)[1:]


def solve(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    tol: TolControl,
    tout,
    itask: int = TASK_NORMAL,
    max_attempts: int | None = None,
    resume_carry: tuple | None = None,
):
    """Integrate toward ``tout`` (reference impl_solve.rs:69-377).

    ``state`` is batch-native (one trailing batch axis, or none for a single
    lane); ``tout`` is a number or a per-lane tensor. TASK_NORMAL steps past
    tout then interpolates; TASK_ONE_STEP returns after each internal step.
    Returns (state, tret, istate), istate one of SUCCESS, TSTOP_RETURN or a
    negative failure code.

    ``max_attempts`` bounds the loop to that many step attempts. Lanes that
    need more come back with istate == CONTINUE, and the return becomes
    ``(state, tret, istate, carry)`` with ``carry`` the 9-tuple (tret,
    istate, nstloc, saved_t, ncf, nef, fresh, ikind, itgt). Passing the
    returned state and ``resume_carry=carry`` (with ``max_attempts``) skips
    the prologue and continues the loop exactly where it stopped, so a
    budgeted and resumed solve is bit for bit the unbudgeted one."""
    if problem.nroots > 0:
        raise NotImplementedError("rootfinding is not ported yet (problem.nroots > 0)")
    if itask not in (TASK_NORMAL, TASK_ONE_STEP):
        raise ValueError(f"itask must be TASK_NORMAL or TASK_ONE_STEP, got {itask}")
    if max_attempts is not None and max_attempts < 1:
        raise ValueError(f"max_attempts must be at least 1, got {max_attempts}")
    dtype, dev, bshape = state.dtype, state.phi.device, state.tn.shape
    tout = torch.broadcast_to(torch.as_tensor(tout, dtype=dtype, device=dev), bshape)
    if resume_carry is not None:
        if max_attempts is None:
            raise ValueError("resume_carry requires max_attempts")
        init = _Loop(state, *resume_carry)
        return _run_attempt_loop(init, problem, opts, tol, tout, itask, max_attempts)
    # tret defaults to tn so failures raised before any step report the
    # true time for problems with nonzero t0
    tret = state.tn

    if itask == TASK_NORMAL:
        state = state._replace(toutc=tout)
    state = state._replace(
        taskc=torch.full(bshape, itask, dtype=torch.int32, device=dev),
        status=torch.full(bshape, C.CONTINUE, dtype=torch.int32, device=dev),
    )

    first = state.nst == 0

    # ---- first-call block ----
    st_init, istate_init = _first_call_init(state, problem, opts, tol, tout)
    state = tree_where(first, st_init, state)
    istate = torch.where(first, istate_init, C.CONTINUE)

    # ---- pre-step stop tests (nst > 0 only) ----
    st_s, tret_s, istate_s = _stop_test1(state, tout, tret, itask)
    pre_ok = ~first & (istate == C.CONTINUE)
    state = tree_where(pre_ok, st_s, state)
    tret = torch.where(pre_ok, tret_s, tret)
    istate = torch.where(pre_ok, istate_s, istate)

    # first-iteration preamble (the loop body runs it at iteration END for
    # the next step; entering lanes need it once here)
    zero_i = torch.zeros(bshape, dtype=torch.int32, device=dev)
    state, istate, tret, ikind0, itgt0 = _step_preamble(
        state, problem, opts, tol, zero_i, istate, tret, zero_i, torch.zeros_like(state.tn),
        istate == C.CONTINUE,
    )
    init = _Loop(
        state=state, tret=tret, istate=istate, nstloc=zero_i, saved_t=state.tn,
        ncf=zero_i, nef=zero_i,
        fresh=torch.ones(bshape, dtype=torch.bool, device=dev),
        ikind=ikind0, itgt=itgt0,
    )
    return _run_attempt_loop(init, problem, opts, tol, tout, itask, max_attempts)
