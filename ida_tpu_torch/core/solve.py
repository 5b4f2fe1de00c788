"""The main integration driver (L4 top).

Port of ``ida_tpu/core/solve.py::solve`` (reference ``solve``
src/impl_solve.rs:69-377 and the stop tests src/impl_stop_test.rs:36-211)
for TASK_NORMAL and TASK_ONE_STEP: first-call initialisation (with the root
init at t0), pre-step root re-checks and stop tests, then one masked loop
over step ATTEMPTS (mxstep guard, ewt refresh, accuracy test, attempt,
completion, per-step root check, post-step stop test). The loop body is
self-masked: finished lanes pass through bit for bit. The interpolation an
exiting lane needs is deferred to one pass after the loop. The budgeted
form (``max_attempts``/``resume_carry``) stops the loop after a fixed number
of attempts and resumes it exactly.

:func:`solve_dense` integrates through a whole monotone output grid inside
one loop, each lane advancing its own row index, and records root crossings
into a per-lane event buffer instead of returning at each.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.utils.checkpoint

from .. import constants as C
from ..problem import IdaProblem
from ..tol_control import TolControl
from ..utils.ad_mode import smask_den
from ..utils.sharding import any_over, state_axis
from ..utils.tree import take1, tree_where
from .coeffs import kidx
from .complete_step import complete_step
from .error_test import _norm
from .interp import _eps, check_t_legal, get_solution, interpolate
from .quad import accumulate_quad
from .root import r_check1, r_check2, r_check3
from .state import IdaOptions, IdaState
from .step import attempt_once, step_begin

TASK_NORMAL = 0
TASK_ONE_STEP = 1


def _ewt_invalid(ewt: torch.Tensor) -> torch.Tensor:
    """Per-component BAD_EWT predicate: ewt <= 0 or non-finite (C
    IDAEwtSetSS/SV check the denominator before inverting)."""
    return ~(ewt > 0.0) | ~torch.isfinite(ewt)


def _any_data(x: torch.Tensor, bnd: int) -> torch.Tensor:
    """``any`` over the leading data axes of [..., N, *batch] (N across the
    shards of a state vector sharded over it)."""
    for _ in range(x.dim() - bnd - 1):
        x = x.any(dim=0)
    return any_over(x, state_axis())


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
    hh_auto = torch.where(ypnorm > 2.0 / smask_den(hh_auto), 0.5 / smask_den(ypnorm), hh_auto)
    hh_auto = torch.where(tout < state.tn, -hh_auto, hh_auto)
    hh = torch.where(hh == 0.0, hh_auto, hh)

    # hmax clamp (impl_solve.rs:135-138)
    rh = hh.abs() * state.hmax_inv
    hh = torch.where(rh > 1.0, hh / smask_den(rh), hh)

    # tstop guard (impl_solve.rs:140-155)
    bad_tstop = state.tstop_set & ((state.tstop - state.tn) * hh <= 0.0)
    istate = torch.where(bad_tstop, C.ILL_INPUT, istate)
    clamp = state.tstop_set & ((state.tn + hh - state.tstop) * hh > 0.0)
    hh = torch.where(clamp, (state.tstop - state.tn) * (1.0 - 4.0 * _eps(state)), hh)

    state = state._replace(
        hh=hh, h0u=hh, kk=torch.zeros_like(state.kk), kused=torch.zeros_like(state.kused)
    )

    # root init at t0 (impl_solve.rs:161-164)
    if problem.nroots > 0:
        state = r_check1(state, problem)

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


def _pre_root(state: IdaState, problem, opts, istate, tret, itask: int):
    """Pre-step root checks of a re-entered solve (impl_solve.rs:186-227):
    re-check at the last root (``r_check2``), then search what is left of
    the last step (``r_check3``). Returns (state, istate, tret)."""
    irfndp = state.irfnd
    chk2 = r_check2(state, problem)
    state = chk2.state
    istate = torch.where((istate == C.CONTINUE) & chk2.close_roots, C.CLOSE_ROOTS, istate)
    found2 = (istate == C.CONTINUE) & chk2.found
    tret = torch.where(found2, state.tlo, tret)
    state = state._replace(tretlast=torch.where(found2, state.tlo, state.tretlast))
    istate = torch.where(found2, C.ROOT_RETURN, istate)

    troundoff = 100.0 * _eps(state) * (state.tn.abs() + state.hh.abs())
    do3 = (istate == C.CONTINUE) & ((state.tn - state.tretlast).abs() > troundoff)
    chk3 = r_check3(state, problem, opts, itask == TASK_NORMAL)
    state = tree_where(do3, chk3.state, state)
    found3 = do3 & chk3.found
    state = state._replace(
        irfnd=torch.where(do3, found3, state.irfnd),
        tretlast=torch.where(found3, state.tlo, state.tretlast),
    )
    tret = torch.where(found3, state.tlo, tret)
    istate = torch.where(found3, C.ROOT_RETURN, istate)

    # ONE_STEP: if an earlier root pre-empted y(tn), return it now
    if itask == TASK_ONE_STEP:
        ret_tn = do3 & ~found3 & irfndp
        st_tn, _ = get_solution(state, state.tn)
        state = tree_where(ret_tn, st_tn, state)
        tret = torch.where(ret_tn, state.tn, tret)
        state = state._replace(tretlast=torch.where(ret_tn, state.tn, state.tretlast))
        istate = torch.where(ret_tn, C.SUCCESS, istate)
    return state, istate, tret


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


def _constraints_opts(state: IdaState, opts: IdaOptions) -> IdaOptions:
    """``opts`` without the constraints block when no lane has constraints
    set: the block is then an identity, so the result is the same bit for
    bit, and the eager path launches none of its operations (one host read
    a call)."""
    if opts.enable_constraints and not bool(state.constraints_set.any()):
        return dataclasses.replace(opts, enable_constraints=False)
    return opts


def _run_attempt_loop(init: _Loop, problem, opts, tol, tout, itask: int, max_attempts=None):
    """The flattened internal loop over step ATTEMPTS (impl_solve.rs:246-373
    + src/lib.rs:613-711): each iteration is one attempt; a lane that lands
    its step also does the completion and stop-test work. With
    ``max_attempts`` the loop stops after that many iterations and also
    returns the carry to resume from."""
    has_roots = problem.nroots > 0

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
        # quadratures over the accepted step: the post-complete_step phi/psi
        # are the interpolant C IDAGetSolution evaluates for it
        if problem.nquad > 0:
            st2 = accumulate_quad(st2, problem, success)

        # on fatal attempt failure: y(tn) (deferred), tret = tn
        ikind = torch.where(step_failed, 1, c.ikind)
        itgt = torch.where(step_failed, st2.tn, c.itgt)
        tret = torch.where(step_failed, st2.tn, tret)
        st2 = st2._replace(tretlast=torch.where(step_failed, st2.tn, st2.tretlast))
        istate = torch.where(step_failed, fatal, istate)
        nstloc = torch.where(success, c.nstloc + 1, c.nstloc)

        ok = (istate == C.CONTINUE) & success

        # per-step root check (impl_solve.rs:335-359)
        if has_roots:
            chk3 = r_check3(st2, problem, opts, itask == TASK_NORMAL)
            st2 = tree_where(ok, chk3.state, st2)
            found = ok & chk3.found
            st2 = st2._replace(
                irfnd=st2.irfnd | found, tretlast=torch.where(found, st2.tlo, st2.tretlast)
            )
            tret = torch.where(found, st2.tlo, tret)
            istate = torch.where(found, C.ROOT_RETURN, istate)
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

    step = body
    if opts.remat_attempts and torch.is_grad_enabled():
        # autograd keeps only the carry of each attempt and recomputes its
        # internals (Newton iterates, factors) in the backward pass
        def step(c: _Loop) -> _Loop:
            return torch.utils.checkpoint.checkpoint(body, c, use_reentrant=False)

    c = init
    n = 0
    # the early exit once no lane continues stays: further masked attempts
    # would add nothing, to the result or to a gradient
    while (max_attempts is None or n < max_attempts) and bool((c.istate == C.CONTINUE).any()):
        c = step(c)
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
    Returns (state, tret, istate), istate one of SUCCESS, TSTOP_RETURN,
    ROOT_RETURN or a negative failure code. After a ROOT_RETURN (tret the
    event time, ``state.iroots`` its signs) call again with the same
    ``tout`` to go on.

    ``max_attempts`` bounds the loop to that many step attempts. Lanes that
    need more come back with istate == CONTINUE, and the return becomes
    ``(state, tret, istate, carry)`` with ``carry`` the 9-tuple (tret,
    istate, nstloc, saved_t, ncf, nef, fresh, ikind, itgt). Passing the
    returned state and ``resume_carry=carry`` (with ``max_attempts``) skips
    the prologue and continues the loop exactly where it stopped, so a
    budgeted and resumed solve is bit for bit the unbudgeted one."""
    if itask not in (TASK_NORMAL, TASK_ONE_STEP):
        raise ValueError(f"itask must be TASK_NORMAL or TASK_ONE_STEP, got {itask}")
    if max_attempts is not None and max_attempts < 1:
        raise ValueError(f"max_attempts must be at least 1, got {max_attempts}")
    dtype, dev, bshape = state.dtype, state.phi.device, state.tn.shape
    tout = torch.broadcast_to(torch.as_tensor(tout, dtype=dtype, device=dev), bshape)
    opts = _constraints_opts(state, opts)
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

    # ---- pre-step root checks (impl_solve.rs:186-227) ----
    if problem.nroots > 0:
        st_r, istate_r, tret_r = _pre_root(state, problem, opts, istate, tret, itask)
        state = tree_where(~first, st_r, state)
        istate = torch.where(first, istate, istate_r)
        tret = torch.where(first, tret, tret_r)

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


class DenseEvents(NamedTuple):
    """Root-crossing events recorded by :func:`solve_dense` (the dense-output
    counterpart of the scan form's ROOT_RETURN re-entry loop; reference
    impl_r_check.rs:343-576 locates them, impl_solve.rs:335-359 returns them
    one call at a time).

    ``count`` is the TOTAL number of events each lane found; events past
    ``max_events`` are dropped (the first ``max_events`` per lane are kept),
    so ``count > max_events`` flags an undersized buffer."""

    t: torch.Tensor  # [E, *batch] event times (unused rows = 0)
    iroots: torch.Tensor  # [E, R, *batch] int32, C sign convention (+1 up, -1 down)
    yy: torch.Tensor  # [E, N, *batch] solution at the event
    yp: torch.Tensor  # [E, N, *batch] derivative at the event
    count: torch.Tensor  # [*batch] int32 total events found (may exceed E)


class _GridLoop(NamedTuple):
    state: IdaState
    istate: torch.Tensor  # CONTINUE while any grid rows remain for the lane
    nstloc: torch.Tensor  # per-row internal-step budget (mxstep, reset per row)
    saved_t: torch.Tensor
    ncf: torch.Tensor
    nef: torch.Tensor
    fresh: torch.Tensor
    gidx: torch.Tensor  # int32: next grid row to fill (T = done)
    out_tret: torch.Tensor  # [T, *batch]
    out_ist: torch.Tensor  # [T, *batch] int32
    out_yy: torch.Tensor  # [T, N, *batch]
    out_yp: torch.Tensor  # [T, N, *batch]
    out_nst: torch.Tensor  # [T, *batch] cumulative lane nst at each row
    eidx: torch.Tensor  # [*batch] int32: events found so far
    out_tev: torch.Tensor  # [E, *batch]
    out_irt: torch.Tensor  # [E, R, *batch] int32
    out_yev: torch.Tensor  # [E, N, *batch]
    out_ypev: torch.Tensor  # [E, N, *batch]


def _any_of(*masks: torch.Tensor) -> list:
    """``any`` of each mask, in ONE device-to-host read."""
    return torch.stack([m.any() for m in masks]).tolist()


def _interp_if(flag: bool, state: IdaState, t: torch.Tensor):
    """(yy, yp) at t when some lane wants it (``flag``, read on the host),
    else the state's own, which every lane then keeps: value-exact either
    way, and an interpolation costs more than the read."""
    return interpolate(state, t) if flag else (state.yy, state.yp)


def solve_dense(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    tol: TolControl,
    touts,
    max_events: int = 0,
):
    """Integrate through a whole monotone output grid inside ONE loop: the
    barrier-free form of a loop of :func:`solve` calls over the grid (the
    scan form, ``IDA.solve_grid(fused=False)``).

    The scan form synchronizes the whole lockstep batch at every grid row:
    no lane may start row i+1 until the slowest lane finishes row i. Here
    each lane advances its OWN row index ``gidx`` the moment it passes
    ``touts[gidx]``, recording the interpolated solution in-loop, so lanes
    never wait.

    Semantics per row mirror the NORMAL-mode solve exactly (reference
    impl_solve.rs:69-377 / impl_stop_test.rs:36-211): each lane's stepping
    sequence, interpolated outputs and per-row status codes are bit for bit
    the scan form's on all-success paths. ``tstop`` follows the scan form's
    semantics (impl_stop_test.rs:67-83,177-203): steps clamp to land on it,
    the row whose tout lies beyond gets TSTOP_RETURN at t = tstop, tstop_set
    clears, and later rows integrate past it. Deliberate scope limits
    against the scan form:

    * a lane whose row FAILS records the failure code at that row and keeps
      integrating toward the next row with fresh budgets (the scan form's
      per-leg re-entry), except a first-call input failure
      (ILL_INPUT/BAD_EWT at t0), which freezes the lane and stamps every
      row with that code.

    Rootfinding (``problem.nroots > 0``) requires ``max_events > 0``: root
    crossings are recorded into a SEPARATE per-lane event buffer of that
    size as they are located, instead of interrupting the sweep the way the
    scan form's ROOT_RETURN does. The event machinery is the same
    r_check2/r_check3 + Illinois stack the scan form runs; "return to the
    caller and re-enter" becomes "record and continue", which visits the
    identical check sequence. A lane that finds more than ``max_events``
    events keeps integrating and counting but drops the extras
    (``DenseEvents.count`` gives the true total). The r_check2 close-roots
    condition freezes the lane with CLOSE_ROOTS as the scan form returns it.

    ``touts`` is [T] (shared) or [T, *batch] (per lane). Returns ``(state,
    out_tret [T,*b], out_ist [T,*b], out_yy [T,N,*b], out_yp [T,N,*b],
    out_nst [T,*b])`` (``out_nst``: each lane's cumulative internal step
    count when the row was recorded) plus a trailing :class:`DenseEvents`
    when ``problem.nroots > 0``.

    Each pass of the loop reads three small flag sets on the host (is any
    lane active and past a row or pending a root scan; did a guard abort a
    row; did a row land): one read where the scan form has one, two more to
    skip interpolations no lane needs.
    """
    has_roots = problem.nroots > 0
    if has_roots and max_events <= 0:
        raise ValueError(
            "solve_dense: a problem with roots needs max_events > 0 "
            "(the event-buffer size per lane)"
        )
    n_ev = int(max_events) if has_roots else 0
    dtype, dev, bshape = state.dtype, state.phi.device, state.tn.shape
    opts = _constraints_opts(state, opts)
    bnd = len(bshape)
    touts = torch.as_tensor(touts, dtype=dtype, device=dev)
    n_rows = int(touts.shape[0])
    if touts.dim() == 1 and bnd > 0:
        touts = touts.reshape((n_rows,) + (1,) * bnd).expand((n_rows,) + tuple(bshape))
    touts = touts.contiguous()

    state = state._replace(
        taskc=torch.full(bshape, TASK_NORMAL, dtype=torch.int32, device=dev),
        status=torch.full(bshape, C.CONTINUE, dtype=torch.int32, device=dev),
        toutc=touts[-1],
    )

    first = state.nst == 0
    st_init, istate_init = _first_call_init(state, problem, opts, tol, touts[0])
    state = tree_where(first, st_init, state)
    istate = torch.where(first, istate_init, C.CONTINUE)

    def zeros(shape, dt=dtype):
        return torch.zeros(tuple(shape), dtype=dt, device=dev)

    zero_i = zeros(bshape, torch.int32)
    zero_t = zeros(bshape)
    c = _GridLoop(
        state=state, istate=istate, nstloc=zero_i, saved_t=state.tn, ncf=zero_i, nef=zero_i,
        fresh=torch.ones(bshape, dtype=torch.bool, device=dev), gidx=zero_i,
        out_tret=zeros((n_rows,) + bshape),
        out_ist=torch.full((n_rows,) + tuple(bshape), C.CONTINUE, dtype=torch.int32, device=dev),
        out_yy=zeros((n_rows,) + state.yy.shape), out_yp=zeros((n_rows,) + state.yp.shape),
        out_nst=zeros((n_rows,) + bshape, state.nst.dtype),
        eidx=zero_i,
        out_tev=zeros((n_ev,) + bshape), out_irt=zeros((n_ev,) + state.iroots.shape, torch.int32),
        out_yev=zeros((n_ev,) + state.yy.shape), out_ypev=zeros((n_ev,) + state.yp.shape),
    )

    def iota(k):
        return torch.arange(k, dtype=torch.int32, device=dev).reshape((k,) + (1,) * bnd)

    iota_rows, iota_ev = iota(n_rows), iota(n_ev)
    # tstop is only ever cleared inside the loop: with none set at entry the
    # tstop rows and their interpolations never happen
    any_tstop = bool(state.tstop_set.any())

    def record(c, mask, code, t_rec, yy_rec, yp_rec, nstloc, hold=None):
        """Fill row gidx for masked lanes; advance gidx; freeze when done.
        ``hold``: lanes whose istate stamping is DEFERRED even when the
        final row lands (events still pending in the last step); the
        pending-scan phase stamps them once the scan dries up."""
        row = (iota_rows == c.gidx) & mask
        row_n = row.unsqueeze(1)
        gidx = c.gidx + mask.to(torch.int32)
        done = mask & (gidx >= n_rows)
        if hold is not None:
            done = done & ~hold
        return c._replace(
            out_tret=torch.where(row, t_rec, c.out_tret),
            out_ist=torch.where(row, code, c.out_ist),
            out_yy=torch.where(row_n, yy_rec.unsqueeze(0), c.out_yy),
            out_yp=torch.where(row_n, yp_rec.unsqueeze(0), c.out_yp),
            out_nst=torch.where(row, c.state.nst, c.out_nst),
            gidx=gidx,
            istate=torch.where(done, code, c.istate),
            nstloc=torch.where(mask, 0, nstloc),
        )

    def record_event(c, mask, t_ev, iroots_ev, yy_ev, yp_ev):
        """Append one event row for masked lanes; rows past the buffer are
        dropped but still counted."""
        row = (iota_ev == c.eidx) & mask
        row_r = row.unsqueeze(1)
        return c._replace(
            eidx=c.eidx + mask.to(torch.int32),
            out_tev=torch.where(row, t_ev, c.out_tev),
            out_irt=torch.where(row_r, iroots_ev.unsqueeze(0), c.out_irt),
            out_yev=torch.where(row_r, yy_ev.unsqueeze(0), c.out_yev),
            out_ypev=torch.where(row_r, yp_ev.unsqueeze(0), c.out_ypev),
        )

    def pend_phase(c):
        """The scan form's pre-step re-checks (impl_solve.rs:186-227, run on
        re-entry after a ROOT_RETURN): lanes whose last step still holds an
        unsearched (tlo, tn] scan it WITHOUT stepping: r_check2 at the last
        root, then r_check3 over the remainder; each found root records an
        event and keeps irfnd set so the scan resumes next pass. Every write
        is masked by ``pend``, recomputed from the carry."""
        state = c.state
        act = c.istate == C.CONTINUE
        pend = c.fresh & act & state.irfnd
        chk2 = r_check2(state, problem)  # self-skips when ~irfnd
        st_a = tree_where(pend, chk2.state, state)
        close = pend & chk2.close_roots
        found2 = pend & chk2.found & ~close
        # r_check2's probe leaves yy/yp at tlo+smallh; the event row wants
        # y(tlo) (C IDASolve calls IDAGetSolution(tlo) after Rcheck2's RTFOUND)
        (any_found2,) = _any_of(found2)
        yy_e2, yp_e2 = _interp_if(any_found2, st_a, st_a.tlo)
        c = c._replace(state=st_a)
        c = record_event(c, found2, st_a.tlo, st_a.iroots, yy_e2, yp_e2)
        istate2 = torch.where(close, C.CLOSE_ROOTS, c.istate)
        # r_check3 over the remaining (tlo, tn], skipped when the interval is
        # within roundoff of empty (impl_solve.rs:203-207; tlo plays
        # tretlast's role: rows overwrite tretlast here)
        troundoff = 100.0 * _eps(st_a) * (st_a.tn.abs() + st_a.hh.abs())
        do3 = pend & ~(found2 | close) & ((st_a.tn - st_a.tlo).abs() > troundoff)
        chk3p = r_check3(st_a, problem, opts, True)
        st_b = tree_where(do3, chk3p.state, st_a)
        found3 = do3 & chk3p.found
        c = c._replace(state=st_b)
        c = record_event(c, found3, st_b.tlo, st_b.iroots, st_b.yy, st_b.yp)
        irfnd = torch.where(pend, found2 | found3, st_b.irfnd)
        # scan drained on a rows-complete lane: stamp the deferred terminal
        # code (the last recorded row's own). c.gidx: the fast path may have
        # recorded the final row in THIS pass
        drained = pend & ~irfnd & (c.gidx >= n_rows)
        istate2 = torch.where(drained, c.out_ist[n_rows - 1], istate2)
        return c._replace(state=st_b._replace(irfnd=irfnd), istate=istate2)

    while True:
        state = c.state
        active = c.istate == C.CONTINUE
        fresh = c.fresh & active
        tout_cur = take1(touts, torch.clamp(c.gidx, max=n_rows - 1))
        # lanes kept alive past their last row only to drain pending root
        # scans (has_roots): no row/step work, only the pend phase below
        rows_left = c.gidx < n_rows
        # events pending in the last step: defer istate stamping (hold)
        hold = state.irfnd if has_roots else None

        # ---- bad-tstop guard (the scan form's _stop_test1 ILL_INPUT,
        # impl_solve.rs:140-155 / impl_stop_test.rs:44-47): a stop time
        # BEHIND tn in the direction of integration is an input error.
        # Freezing with ILL_INPUT stamps every remaining row through the
        # post-loop unfilled-rows pass, matching the scan form's per-leg
        # ILL_INPUT returns (nst == 0 lanes: _first_call_init's guard) ----
        new_istate = c.istate
        if any_tstop:
            bad_tstop = (
                fresh & (state.nst > 0) & state.tstop_set
                & ((state.tn - state.tstop) * state.hh > 0.0)
            )
            new_istate = torch.where(bad_tstop, C.ILL_INPUT, c.istate)
            fresh = fresh & (new_istate == C.CONTINUE)

        # ---- row fast path (the scan form's _stop_test1, NORMAL): a lane
        # already past its current tout records it WITHOUT stepping; same
        # priority order: hit_prev, past_tout, at_tstop (a lane parked at
        # tstop whose tout lies beyond records the row as TSTOP_RETURN at
        # t = tstop and clears tstop_set, impl_stop_test.rs:67-83) ----
        hit_prev = tout_cur == state.tretlast
        past = (state.tn - tout_cur) * state.hh >= 0.0
        can_fp = fresh & (state.nst > 0) & rows_left
        fp_main = can_fp & (hit_prev | past)
        flags = [active, fp_main]
        if any_tstop:
            troundoff = 100.0 * _eps(state) * (state.tn.abs() + state.hh.abs())
            sel_tstop = (
                state.tstop_set & ((state.tn - state.tstop).abs() <= troundoff)
                & ~(hit_prev | past)
            )
            fp_tstop = can_fp & sel_tstop  # disjoint from fp_main
            flags.append(fp_tstop)
        if has_roots:
            # a superset of the pend phase's own mask (the records below can
            # only finish lanes): when empty the phase is skipped exactly
            flags.append(fresh & state.irfnd)
        # ONE read: the loop condition and which rare phases this pass needs
        flags = _any_of(*flags)
        if not flags[0]:
            break
        any_fp_main = flags[1]
        any_fp_tstop = any_tstop and flags[2]
        any_pend = has_roots and flags[-1]
        c = c._replace(istate=new_istate)

        skip = None  # lanes that recorded without stepping: re-check next pass
        if any_fp_main or any_fp_tstop:
            iok = check_t_legal(state, tout_cur)
            yy_fp, yp_fp = _interp_if(any_fp_main, state, tout_cur)
            # interp applies only on the past-and-legal path (not hit_prev /
            # BAD_T), like get_solution's ok-masked write; the tstop path
            # interpolates unconditionally (the scan's get_solution(tstop))
            use_interp = fp_main & past & iok & ~hit_prev
            yy_rec = torch.where(use_interp, yy_fp, state.yy)
            yp_rec = torch.where(use_interp, yp_fp, state.yp)
            tgt_fp = tout_cur
            fp_code = torch.where(past & ~(hit_prev | iok), C.BAD_T, C.SUCCESS).to(torch.int32)
            fp_any = fp_main
            if any_fp_tstop:
                yy_ts, yp_ts = interpolate(state, state.tstop)
                yy_rec = torch.where(fp_tstop, yy_ts, yy_rec)
                yp_rec = torch.where(fp_tstop, yp_ts, yp_rec)
                tgt_fp = torch.where(fp_tstop, state.tstop, tout_cur)
                fp_code = torch.where(sel_tstop, C.TSTOP_RETURN, fp_code)
                fp_any = fp_main | fp_tstop
                state = state._replace(tstop_set=state.tstop_set & ~fp_tstop)
            state = state._replace(
                yy=yy_rec, yp=yp_rec, tretlast=torch.where(fp_any, tgt_fp, state.tretlast)
            )
            c = c._replace(state=state)
            c = record(c, fp_any, fp_code, tgt_fp, yy_rec, yp_rec, c.nstloc, hold=hold)
            state = c.state
            skip = fp_any
        active = c.istate == C.CONTINUE

        # ---- pending root scan: needed only in the pass right after a root
        # was found; all its writes are pend-masked, so skipping is exact ----
        if any_pend:
            pend = fresh & state.irfnd & active
            c = pend_phase(c)
            state = c.state
            active = c.istate == C.CONTINUE
            skip = pend if skip is None else skip | pend

        # ---- per-step preamble at the START of the pass (the scan form runs
        # it after its _stop_test1 and before each step; the state is the
        # same at either loop boundary) ----
        pre = fresh & active if skip is None else fresh & ~skip & active
        if has_roots:
            pre = pre & rows_left  # drain-only lanes never step
        st_p, ist_p, _, _, _ = _step_preamble(
            state, problem, opts, tol, c.nstloc, c.istate, state.tn, zero_i, zero_t, pre
        )
        aborted = pre & (ist_p != C.CONTINUE)
        (any_aborted,) = _any_of(aborted)
        if any_aborted:
            # the scan form records the abort at tret = tn with y(tn)
            yy_ab, yp_ab = interpolate(st_p, st_p.tn)
            st_p = st_p._replace(
                yy=torch.where(aborted, yy_ab, st_p.yy),
                yp=torch.where(aborted, yp_ab, st_p.yp),
            )
            c = c._replace(state=st_p)
            c = record(c, aborted, ist_p, st_p.tn, st_p.yy, st_p.yp, c.nstloc)
            skip = aborted if skip is None else skip | aborted
        else:
            c = c._replace(state=st_p)
        state = c.state
        active = c.istate == C.CONTINUE

        # ---- the attempt ----
        att = active if skip is None else active & ~skip
        if has_roots:
            att = att & rows_left
        begin = fresh & att
        saved_t = torch.where(begin, state.tn, c.saved_t)
        state = step_begin(state, mask=begin)
        ncf = torch.where(begin, 0, c.ncf)
        nef = torch.where(begin, 0, c.nef)
        st2, success, fatal, ck, err_k, err_km1, ncf, nef = attempt_once(
            state, problem, opts, saved_t, ncf, nef, active=att
        )
        step_failed = fatal != C.CONTINUE
        st2 = complete_step(st2, problem, opts, err_k, err_km1, ck=ck, mask=success)
        if problem.nquad > 0:
            st2 = accumulate_quad(st2, problem, success)
        nstloc = torch.where(success, c.nstloc + 1, c.nstloc)
        ok = success & att

        # ---- per-step root check (the scan form's impl_solve.rs:335-359):
        # a found root records an event in-loop instead of returning ----
        if has_roots:
            chk3 = r_check3(st2, problem, opts, True)
            st2 = tree_where(ok, chk3.state, st2)
            found = ok & chk3.found
            st2 = st2._replace(irfnd=st2.irfnd | found)
            c = c._replace(state=st2)
            c = record_event(c, found, st2.tlo, st2.iroots, st2.yy, st2.yp)
            hold = st2.irfnd  # fresh events defer this pass's stamping

        # ---- post-step: fatal failure, row crossing, or landing on tstop
        # records in-loop (the scan form's _stop_test2, NORMAL: past_tout
        # takes priority over at_tstop, impl_stop_test.rs:146-211) ----
        past2 = ok & ((st2.tn - tout_cur) * st2.hh >= 0.0)
        rec_main = step_failed | past2
        flags = [rec_main]
        if any_tstop:
            tro2 = 100.0 * _eps(st2) * (st2.tn.abs() + st2.hh.abs())
            stop2 = ok & st2.tstop_set & ((st2.tn - st2.tstop).abs() <= tro2) & ~past2
            flags.append(stop2)
        flags = _any_of(*flags)
        any_stop2 = any_tstop and flags[1]
        if flags[0] or any_stop2:
            tgt = torch.where(step_failed, st2.tn, tout_cur)
            yy_po, yp_po = _interp_if(flags[0], st2, tgt)
            yy_new = torch.where(rec_main, yy_po, st2.yy)
            yp_new = torch.where(rec_main, yp_po, st2.yp)
            rec_post = rec_main
            code_post = torch.where(step_failed, fatal, C.SUCCESS)
            if any_stop2:
                yy_st, yp_st = interpolate(st2, st2.tstop)
                yy_new = torch.where(stop2, yy_st, yy_new)
                yp_new = torch.where(stop2, yp_st, yp_new)
                rec_post = rec_main | stop2
                tgt = torch.where(stop2, st2.tstop, tgt)
                code_post = torch.where(
                    step_failed, fatal, torch.where(stop2, C.TSTOP_RETURN, C.SUCCESS)
                )
                st2 = st2._replace(tstop_set=st2.tstop_set & ~stop2)
            st2 = st2._replace(
                yy=yy_new, yp=yp_new, tretlast=torch.where(rec_post, tgt, st2.tretlast)
            )
        else:
            rec_post = None
        if any_tstop:
            # clamp the next h to land on tstop (the scan form clamps per leg
            # in _stop_test1/2; complete_step may have raised h past it)
            clamp = st2.tstop_set & ok & ((st2.tn + st2.hh - st2.tstop) * st2.hh > 0.0)
            st2 = st2._replace(
                hh=torch.where(clamp, (st2.tstop - st2.tn) * (1.0 - 4.0 * _eps(st2)), st2.hh)
            )
        c = c._replace(state=st2)
        if rec_post is not None:
            c = record(c, rec_post, code_post.to(torch.int32), tgt, st2.yy, st2.yp, nstloc,
                       hold=hold)
        else:
            c = c._replace(nstloc=nstloc)

        # a failed-row lane restarts fresh toward the next row, like the scan
        # form's re-entry; recoverable failures retry
        landed = success | step_failed
        if skip is not None:
            landed = landed | skip
        c = c._replace(
            saved_t=saved_t, ncf=ncf, nef=nef, fresh=(active & landed) | (~active & c.fresh)
        )

    # lanes frozen before filling every row (first-call input failures)
    # stamp their terminal code on the remaining rows
    unfilled = iota_rows >= c.gidx
    out_ist = torch.where(unfilled, c.istate, c.out_ist)
    out_tret = torch.where(unfilled, c.state.tn, c.out_tret)
    out_nst = torch.where(unfilled, c.state.nst, c.out_nst)
    state = c.state._replace(status=c.istate)
    rows = (state, out_tret, out_ist, c.out_yy, c.out_yp, out_nst)
    if has_roots:
        return rows + (DenseEvents(t=c.out_tev, iroots=c.out_irt, yy=c.out_yev, yp=c.out_ypev,
                                   count=c.eidx),)
    return rows
