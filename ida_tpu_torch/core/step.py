"""One step attempt and its failure policy (L4 core).

Port of ``ida_tpu/core/step.py`` (reference ``step`` src/lib.rs:613-711 and
``handle_n_flag`` :1120-1244): set_coeffs -> advance tn (tstop roundoff
clamp, C semantics) -> predict -> nonlinear_solve -> error test; on failure
restore + handle_n_flag (+ reset while nst == 0). The solve loop in
``core/solve.py`` calls :func:`attempt_once` once per loop iteration;
:func:`step` is the standalone one-internal-step retry machine around it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import constants as C
from ..utils.ad_mode import smask_den, spow
from ..utils.profiling import scope
from ..utils.trace import TRACE_FIELDS, trace_sink
from ..utils.tree import masked_while_loop
from .coeffs import kidx, predict, reset, restore, set_coeffs
from .complete_step import complete_step
from .error_test import error_test
from .nls import nonlinear_solve
from .state import IdaOptions, IdaState


class _Attempt(NamedTuple):
    state: IdaState
    ck: torch.Tensor
    err_k: torch.Tensor
    err_km1: torch.Tensor
    ncf: torch.Tensor  # int32 local convergence-failure counter
    nef: torch.Tensor  # int32 local error-test-failure counter
    done: torch.Tensor  # bool: success
    fatal: torch.Tensor  # int32 fatal status (CONTINUE while fine)


def _handle_n_flag(
    state: IdaState,
    opts: IdaOptions,
    kind: torch.Tensor,  # REC_CONV / REC_LSETUP / ... or ERROR_TEST_FAIL
    err_k: torch.Tensor,
    err_km1: torch.Tensor,
    ncf: torch.Tensor,
    nef: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> Tuple[IdaState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Failure policy (reference src/lib.rs:1120-1244). Returns
    (state, ncf, nef, fatal_status); masked-out lanes pass through."""
    dtype = state.dtype
    if mask is None:
        mask = torch.ones(state.tn.shape, dtype=torch.bool, device=state.tn.device)
    state = state._replace(phase=torch.where(mask, 1, state.phase))
    is_etf = kind == C.ERROR_TEST_FAIL

    # ---------- error test failure branch (src/lib.rs:1143-1198) ----------
    nef_new = nef + 1
    err_knew = torch.where(state.kk == state.knew, err_k, err_km1)
    kk1 = state.knew
    rr1 = 0.9 * spow(2.0 * err_knew + 1.0e-4, -1.0 / (kk1.to(dtype) + 1.0))
    rr1 = torch.maximum(torch.full_like(rr1, 0.25), torch.minimum(torch.full_like(rr1, 0.9), rr1))
    # nef == 1 -> (knew, rr1); nef == 2 -> (knew, 0.25); nef >= 3 -> (1, 0.25)
    kk_etf = torch.where(nef_new >= 3, 1, kk1)
    rr_etf = torch.where(nef_new == 1, rr1, torch.full_like(rr1, 0.25))
    etf_fatal = nef_new >= opts.maxnef

    # ---------- recoverable convergence failure branch (:1201-1237) ----------
    ncf_new = ncf + 1
    rr_cf = torch.where(kind == C.REC_CONSTRAINT, state.rr, torch.full_like(state.rr, 0.25))
    cf_fatal = ncf_new >= opts.maxncf
    # fatal code at maxncf keyed on the recoverable kind (C IDAHandleNFlag)
    cf_fatal_code = torch.where(
        kind == C.REC_RESIDUAL,
        C.REP_RES_ERR,
        torch.where(
            kind == C.REC_CONSTRAINT,
            C.CONSTR_FAIL,
            torch.where(
                kind == C.REC_LSETUP,
                C.LSETUP_FAIL,
                torch.where(kind == C.REC_LSOLVE, C.LSOLVE_FAIL, C.CONV_FAIL),
            ),
        ),
    ).to(torch.int32)

    kk = torch.where(is_etf, kk_etf, state.kk)
    rr = torch.where(is_etf, rr_etf, rr_cf)
    hh = state.hh * rr
    nef = torch.where(is_etf, nef_new, nef)
    ncf = torch.where(is_etf, ncf, ncf_new)
    netf = state.netf + (is_etf & mask).to(state.netf.dtype)
    ncfn = state.ncfn + (~is_etf & mask).to(state.ncfn.dtype)

    cont = torch.full_like(cf_fatal_code, C.CONTINUE)
    fatal = torch.where(
        is_etf,
        torch.where(etf_fatal, torch.full_like(cont, C.ERR_FAIL), cont),
        torch.where(cf_fatal, cf_fatal_code, cont),
    )

    m = mask
    state = state._replace(
        kk=torch.where(m, kk, state.kk),
        rr=torch.where(m, rr, state.rr),
        hh=torch.where(m, hh, state.hh),
        netf=netf,
        ncfn=ncfn,
    )
    return state, ncf, nef, fatal


@scope("step.begin")
def step_begin(state: IdaState, mask: torch.Tensor | None = None) -> IdaState:
    """First-step initialisation at the start of a fresh step
    (src/lib.rs:619-627), restricted to ``mask`` lanes."""
    first = state.nst == 0
    if mask is not None:
        first = first & mask
    return state._replace(
        kk=torch.where(first, 1, state.kk),
        kused=torch.where(first, 0, state.kused),
        hused=torch.where(first, torch.zeros_like(state.hused), state.hused),
        psi=torch.where(first & (kidx(state) == 0), state.hh, state.psi),
        cj=torch.where(first, 1.0 / smask_den(state.hh), state.cj),
        phase=torch.where(first, 0, state.phase),
        ns=torch.where(first, 0, state.ns),
    )


@scope("step.attempt")
def attempt_once(
    state: IdaState,
    problem,
    opts: IdaOptions,
    saved_t: torch.Tensor,
    ncf: torch.Tensor,
    nef: torch.Tensor,
    active: torch.Tensor | None = None,
):
    """One step attempt. Returns (state, success, fatal, ck, err_k, err_km1,
    ncf, nef). Lanes with active=False pass through bit for bit
    (success=False, fatal=CONTINUE, ncf/nef unchanged)."""
    if active is None:
        active = torch.ones(state.tn.shape, dtype=torch.bool, device=state.tn.device)
    if opts.debug_trace:
        # per-attempt state dump (reference src/lib.rs:635-639)
        trace_sink(**{f: getattr(state, f) for f in TRACE_FIELDS})

    st, ck = set_coeffs(state, mask=active, fast_math=opts.fast_math)

    # advance tn, clamping to tstop against roundoff (C semantics)
    tn = st.tn + st.hh
    past_tstop = st.tstop_set & ((tn - st.tstop) * st.hh > 0.0)
    tn = torch.where(past_tstop, st.tstop, tn)
    st = st._replace(tn=torch.where(active, tn, st.tn))

    st = predict(st, mask=active, fast_math=opts.fast_math)
    st, nl_status = nonlinear_solve(st, problem, opts, active=active)

    st, etr = error_test(st, problem, opts, ck, mask=active)
    nl_ok = nl_status == C.REC_NONE
    success = nl_ok & etr.converged & active
    kind = torch.where(nl_ok, C.ERROR_TEST_FAIL, nl_status)
    # error norms are only meaningful when the NLS succeeded
    err_k = torch.where(nl_ok, etr.err_k, torch.zeros_like(etr.err_k))
    err_km1 = torch.where(nl_ok, etr.err_km1, torch.zeros_like(etr.err_km1))

    # failure path: restore, adjust h/k, maybe reset (src/lib.rs:676-689);
    # each routine takes the failure mask, so no full-state select follows
    fail = ~success & active
    st = restore(st, saved_t, mask=fail, fast_math=opts.fast_math)
    st, ncf_f, nef_f, fatal = _handle_n_flag(st, opts, kind, err_k, err_km1, ncf, nef, mask=fail)
    st = reset(st, mask=fail & (fatal == C.CONTINUE) & (st.nst == 0))

    fatal = torch.where(fail, fatal, torch.full_like(fatal, C.CONTINUE))
    ncf = torch.where(fail, ncf_f, ncf)
    nef = torch.where(fail, nef_f, nef)
    return st, success, fatal, ck, err_k, err_km1, ncf, nef


def step(state: IdaState, problem, opts: IdaOptions) -> IdaState:
    """Take one internal step of every lane; a lane's fatal failure lands
    in its ``status`` (``ida_tpu/core/step.py::step``, reference
    src/lib.rs:613-711). Attempts repeat while a lane has neither succeeded
    nor failed fatally; the production solve loop calls
    :func:`attempt_once` directly instead."""
    saved_t = state.tn
    state = step_begin(state)

    def cond(c: _Attempt) -> torch.Tensor:
        return ~c.done & (c.fatal == C.CONTINUE)

    def body(c: _Attempt) -> _Attempt:
        st, success, fatal, ck, err_k, err_km1, ncf, nef = attempt_once(
            c.state, problem, opts, saved_t, c.ncf, c.nef)
        return _Attempt(
            state=st,
            ck=torch.where(success, ck, c.ck),
            err_k=torch.where(success, err_k, c.err_k),
            err_km1=torch.where(success, err_km1, c.err_km1),
            ncf=ncf, nef=nef, done=success, fatal=fatal,
        )

    z = torch.zeros_like(state.tn)
    zi = torch.zeros(state.tn.shape, dtype=torch.int32, device=state.tn.device)
    init = _Attempt(state=state, ck=z, err_k=z, err_km1=z, ncf=zi, nef=zi,
                    done=torch.zeros_like(zi, dtype=torch.bool),
                    fatal=torch.full_like(zi, C.CONTINUE))
    out = masked_while_loop(cond, body, init)

    # the success epilogue (src/lib.rs:697-708), under the success mask
    state = complete_step(out.state, problem, opts, out.err_k, out.err_km1, ck=out.ck,
                          mask=out.done)
    # fatal failures land in the status lane
    return state._replace(status=torch.where(out.done, state.status, out.fatal).to(torch.int32))
