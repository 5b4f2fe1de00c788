"""Nonlinear system solution for one step attempt (L3 layer).

Port of ``ida_tpu/core/nls.py`` for ``linear_solver`` "dense", "band" and
"spgmr" at ``ls_precision="full"`` (reference ``nonlinear_solve``
src/lib.rs:787-890, ``crates/nonlinear/src/newton.rs:51-167``,
``src/ida_nls.rs:105-266``, ``src/ida_ls.rs:232-455``). The outer (retry
with a fresh Jacobian) and inner (Newton iteration) loops are masked while
loops: every lane runs its own iteration count, finished lanes are frozen.
The dense LU factor and solve go through
``ops.dense_lu.lu_factor_auto``/``lu_solve_auto`` (the CUDA kernel on the
card up to N = 16), the band factor and solve through ``ops.banded``
(SUNDIALS ``bandGETRF``/``bandGETRS`` on a Jacobian of mu + ml + 1 colored
jvps); the Krylov path runs ``ops.spgmr.spgmr_solve`` on jvps of the
residual with the problem's preconditioner. After the Newton loops the
inequality-constraints block (C IDA ``IDANls``) checks the new iterate of
every lane whose ``constraints_set`` is on: a small violation is pulled
back inside, a large one fails the attempt with REC_CONSTRAINT and the
step ratio ``rr`` it asks for.

The mixed-precision modes (``IdaOptions.ls_precision``, ``ida_tpu``'s
``core/nls.py:123-316``): under "single" the dense and band Jacobians are
evaluated on float32 arguments (with a trailing cast, against a problem
whose captured float64 parameters promote), factored and solved in float32
(K1's float32 kernels on the card), and the Krylov iteration runs wholly in
float32; under "refined" the dense Jacobian is evaluated in the state's
dtype and factored in float32, and every solve takes one refinement step
against that Jacobian applied as a jvp of the residual at the saved lsetup
point. ``krylov_storage="bfloat16"`` stores the GMRES basis in bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.autograd import forward_ad

from .. import constants as C
from ..norms import wrms_norm_bnd
from ..ops.banded import BandLU, band_factor, band_solve, band_sys_jacobian
from ..ops.dense_lu import DenseLU, lu_factor_auto, lu_solve_auto
from ..ops.spgmr import spgmr_solve
from ..problem import IdaProblem, jacobian
from ..utils.ad_mode import is_safe_ad, smask_den, spow
from ..utils.numerics import sqrt_, sum0
from ..utils.profiling import scope
from ..utils.sharding import any_over, axis_size, min_over, state_axis
from ..utils.tree import masked_while_loop, tree_where
from .state import IdaOptions, IdaState

# internal Newton loop status
_CONTINUE = 0
_OK = 1
_CONV_RECVR = 2  # recoverable: retry with fresh Jacobian or fail the attempt
_LSETUP_RECVR = 3  # singular/non-finite Jacobian in lsetup
_RES_RECVR = 4  # non-finite residual (C IDA_RES_RECVR)
_LSOLVE_RECVR = 5  # failed linear solve (C IDA_LSOLVE_RECVR)


def _cast_floats(tree, dtype: torch.dtype):
    """``tree`` (a tensor, a tuple of them or None) with its floating
    tensors cast to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_floats(x, dtype) for x in tree)
    return tree


def _res_jvp(problem: IdaProblem, tn, cj, yy, yp, v) -> torch.Tensor:
    """J v = dF/dy v + cj dF/dy' v at (tn, yy, yp): one jvp of the residual
    with tangents (v, cj v), the refinement's matrix-free Jacobian. Inside
    an open forward-mode level (``forward_sensitivity``), where
    ``torch.func.jvp`` cannot open another, the two Jacobians come from the
    vmapped vjps that ``problem.jacobian`` takes there, and J v is their
    product with (v, cj v), the columns added left to right: the same
    matrix applied, whose own tangent then follows that level (the last
    bits of J v are the product's, not the jvp's)."""
    if forward_ad._current_level >= 0:
        d_yy = jacobian(lambda y: problem.res(tn, y, yp), yy)
        d_yp = jacobian(lambda ydot: problem.res(tn, yy, ydot), yp)
        terms = d_yy * v.unsqueeze(0) + d_yp * (cj * v).unsqueeze(0)
        return sum0(terms.movedim(1, 0))
    return torch.func.jvp(lambda y, ydot: problem.res(tn, y, ydot), (yy, yp), (v, cj * v))[1]


def _res_ok(r: torch.Tensor) -> torch.Tensor:
    """Per-lane recoverable-residual channel: a non-finite entry marks the
    lane's residual evaluation recoverably failed (across the shards of a
    state vector sharded over N)."""
    return ~any_over(~torch.isfinite(r), state_axis())


class _Lin(NamedTuple):
    """Linear-solver state threaded through the Newton loops."""

    lu: torch.Tensor
    piv: torch.Tensor
    pdata: object
    cjold: torch.Tensor
    cjratio: torch.Tensor
    nje: torch.Tensor
    nsetups: torch.Tensor
    # the lsetup linearization point (tn, cj, yy, yp) under "refined", ()
    # otherwise: the refinement applies the factored Jacobian as a jvp there
    ls_pt: object


class _Inner(NamedTuple):
    """Carry of the inner Newton iteration: only what it mutates. On the
    dense path yy/yp are ``predict + ycor`` and savres equals ``delta``, so
    they are rebuilt where needed and, with the Krylov counters, carry
    ``()``. Counters tally in local int32 lanes."""

    ycor: torch.Tensor
    delta: torch.Tensor
    yy: object  # () on the dense path
    yp: object  # () on the dense path
    savres: object  # () on the dense path (== delta there)
    oldnrm: torch.Tensor
    ss: torch.Tensor
    curiter: torch.Tensor  # int32 m
    istatus: torch.Tensor  # int32
    knni: torch.Tensor  # int32 Newton iterations this nonlinear_solve
    kre: torch.Tensor  # int32 residual evaluations this nonlinear_solve
    knli: object  # () on the dense path; int32 lanes under spgmr
    knps: object
    kncfl: object
    knjtsetup: object
    knjtimes: object


class _Outer(NamedTuple):
    inner: _Inner
    lin: _Lin
    ss: torch.Tensor
    call_lsetup: torch.Tensor  # bool
    jcur: torch.Tensor  # bool
    ostatus: torch.Tensor  # int32


@scope("lsetup")
def _lsetup(
    state: IdaState, problem: IdaProblem, opts: IdaOptions, lin: _Lin, yy, yp, savres
) -> Tuple[_Lin, torch.Tensor]:
    """idaNlsLSetup + idaLsSetup (reference src/ida_nls.rs:156-187,
    src/ida_ls.rs:232-290). Dense: J = dF/dy + cj*dF/dy' at the predictor,
    LU-factored. Band: the same J in band storage from mu + ml + 1 colored
    jvps, band-factored. SPGMR: refresh the preconditioner (the operator
    itself is matrix-free, always current)."""
    if opts.linear_solver in ("dense", "band"):
        tn, cj = state.tn, state.cj
        if opts.ls_precision == "single":
            # the Jacobian on float32 arguments; the trailing cast keeps it
            # float32 against captured float64 parameters that promote
            f32 = torch.float32
            tn, cj, yy, yp, savres = (x.to(f32) for x in (tn, cj, yy, yp, savres))
        if opts.linear_solver == "dense":
            j = problem.sys_jacobian(tn, cj, yy, yp, savres)
            if opts.ls_precision == "refined":
                lin = lin._replace(ls_pt=(tn, cj, yy, yp))
            if opts.ls_precision != "full":
                j = j.to(torch.float32)
            f = lu_factor_auto(j)
        else:
            j = band_sys_jacobian(problem, tn, cj, yy, yp, opts.band_mu, opts.band_ml)
            if opts.ls_precision == "single":
                j = j.to(torch.float32)
            f = band_factor(j, opts.band_mu, opts.band_ml)
        # singular (pivot == 0) OR non-finite Jacobian => recoverable lsetup
        # failure (a NaN pivot passes the == 0 test)
        fail = (f.fail_col > 0) | ~torch.isfinite(j).all(dim=0).all(dim=0)
        lin = lin._replace(lu=f.lu.to(lin.lu.dtype), piv=f.piv, nje=lin.nje + 1)
    else:
        if problem.prec_setup is not None:
            lin = lin._replace(pdata=problem.prec_setup(state.tn, state.cj, yy, yp, savres))
        fail = torch.zeros_like(state.cj, dtype=torch.bool)
    lin = lin._replace(
        nsetups=lin.nsetups + 1, cjold=state.cj, cjratio=torch.ones_like(state.cj),
    )
    return lin, fail


@scope("newton_iterate")
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
    # "dense" here means DIRECT (dense or band): both drop the
    # reconstructable carry and the Krylov counters
    dense = opts.linear_solver in ("dense", "band")
    dtype = cj.dtype
    if dense:
        # idaLsSolve's cj-change correction (reference src/ida_ls.rs:406-410)
        scale = torch.where(lin.cjratio != 1.0, 2.0 / (1.0 + lin.cjratio), torch.ones_like(cj))
        no_fail = torch.zeros(cj.shape, dtype=torch.int32, device=cj.device)
        if opts.linear_solver == "dense":
            factored = DenseLU(lin.lu, lin.piv, no_fail)

            def solve_stored(b):
                return lu_solve_auto(factored, b.to(lin.lu.dtype)).to(dtype)
        else:
            banded = BandLU(lin.lu, lin.piv, no_fail, opts.band_mu, opts.band_ml)

            def solve_stored(b):
                return band_solve(banded, b.to(lin.lu.dtype)).to(dtype)

        if opts.ls_precision == "refined":
            # one step of refinement against the lsetup Jacobian applied
            # matrix-free: x = x0 + LU32^-1 (b - J x0), J v the jvp of the
            # residual at the saved point with tangents (v, cj v), as
            # ida_tpu's jax.jvp (not the model's jtimes)
            s_tn, s_cj, s_yy, s_yp = lin.ls_pt

            def direct_solve(b):
                x0 = solve_stored(b)
                jx0 = _res_jvp(problem, s_tn, s_cj, s_yy, s_yp, x0)
                return x0 + solve_stored(b - jx0)
        else:
            direct_solve = solve_stored
    else:
        # "single": the whole Krylov iteration in float32 (its callbacks
        # must keep float32 in float32 out; the trailing casts guard the
        # carry against promoting closures)
        ldt = torch.float32 if opts.ls_precision == "single" else dtype
        tn_l, cj_l, ewt_l = tn.to(ldt), cj.to(ldt), ewt.to(ldt)
        storage = torch.bfloat16 if opts.krylov_storage == "bfloat16" else None
        # the Krylov tolerance sqrt(N) * eplifac * eps_newt (reference
        # ida_ls.rs:211, 337); N the global length of a sharded state
        n_all = problem.n * axis_size(state_axis())
        sqrt_n = sqrt_(torch.full((), n_all, dtype=dtype, device=cj.device))
        ltol = (sqrt_n * opts.eplifac * eps_newt).to(ldt)
        psolve = None
        if problem.prec_solve is not None:
            # pdata cast once a Newton loop (its values change only in an
            # lsetup); a cast to the same dtype returns the tensor itself
            pdata_l = _cast_floats(lin.pdata, ldt)

            def psolve(r):
                return problem.prec_solve(pdata_l, r, cj_l).to(ldt)

    def lsolve(c: _Inner, b, first):
        """idaLsSolve (reference src/ida_ls.rs:298-455). On the first Newton
        iteration of an attempt a Krylov solve that only reduced the
        residual (SUNLS_RES_REDUCED) is accepted."""
        if dense:
            return c, direct_solve(b) * scale, None
        yy, yp = c.yy, c.yp
        jdata = None
        if problem.jtimes_setup is not None:
            # C idaLsSolve calls the user jtsetup once per linear solve
            jdata = problem.jtimes_setup(tn, cj, yy, yp, c.savres)
            c = c._replace(knjtsetup=c.knjtsetup + 1)
        yy_l, yp_l, jdata_l = yy.to(ldt), yp.to(ldt), _cast_floats(jdata, ldt)

        def atimes(v):
            return problem.jtimes(tn_l, cj_l, yy_l, yp_l, v, jdata_l).to(ldt)

        res = spgmr_solve(
            atimes, b.to(ldt), ltol, psolve=psolve, s1=ewt_l, s2=ewt_l, maxl=opts.krylov_maxl,
            max_restarts=opts.krylov_max_restarts, storage_dtype=storage, gs=opts.krylov_gs,
            active=c.istatus == _CONTINUE,
        )
        res = res._replace(x=res.x.to(dtype))
        c = c._replace(
            knli=c.knli + res.nli, knps=c.knps + res.nps, knjtimes=c.knjtimes + res.natimes,
            # C idaLsSolve counts EVERY linear non-success, the reduced
            # solves the first iteration accepts included
            kncfl=c.kncfl + (~res.converged).to(torch.int32),
        )
        return c, res.x, res.converged | (first & res.reduced)

    def cond(c: _Inner) -> torch.Tensor:
        return c.istatus == _CONTINUE

    def body(c: _Inner) -> _Inner:
        m = c.curiter
        first = m == 0
        c, x, lok = lsolve(c, -c.delta, first)
        ycor = c.ycor + x

        # --- convergence test (idaNlsConvTest) ---
        delnrm = wrms_norm_bnd(x, ewt, problem.n, bnd, axis_name=state_axis())
        oldnrm = torch.where(first, delnrm, c.oldnrm)
        conv_direct = first & (delnrm <= 1.0e-4 * toldel)
        expo = 1.0 / m.clamp(min=1).to(cj.dtype)
        rate = torch.where(first, zero, spow(delnrm / smask_den(oldnrm), expo))
        diverged = ~first & (rate > C.RATEMAX)
        ss = torch.where(~first, rate / smask_den(1.0 - rate), c.ss)
        converged = conv_direct | (ss * delnrm <= eps_newt)

        curiter = m + 1
        continuing = torch.full_like(c.istatus, _CONTINUE)
        exhausted = curiter >= opts.maxnlsit
        istatus = torch.where(
            diverged,
            _CONV_RECVR,
            torch.where(converged, _OK, torch.where(exhausted, _CONV_RECVR, continuing)),
        )
        if lok is not None:
            # a failed linear solve is its own recoverable kind (C
            # IDA_LSOLVE_RECVR)
            istatus = torch.where(lok, istatus, _LSOLVE_RECVR)

        # re-evaluate the residual only if iterating again; a non-finite
        # result ends the Newton loop with the recoverable-residual kind
        keep = istatus == _CONTINUE
        yy = yypredict + ycor
        yp = yppredict + cj * ycor
        r = problem.res(tn, yy, yp)
        rbad = keep & ~_res_ok(r)
        istatus = torch.where(rbad, _RES_RECVR, istatus)
        keep_w = keep & ~rbad
        return c._replace(
            ycor=ycor,
            delta=torch.where(keep_w, r, c.delta),
            yy=() if dense else torch.where(keep_w, yy, c.yy),
            yp=() if dense else torch.where(keep_w, yp, c.yp),
            savres=() if dense else torch.where(keep_w, r, c.savres),
            oldnrm=oldnrm,
            ss=ss,
            curiter=curiter,
            istatus=istatus,
            knni=c.knni + 1,
            kre=c.kre + keep.to(torch.int32),
        )

    if opts.unroll_newton:
        c = inner0
        for _ in range(opts.maxnlsit):
            c = tree_where(cond(c), body(c), c)
        return c
    return masked_while_loop(cond, body, inner0)


@scope("nonlinear_solve")
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
    cjratio = state.cj / smask_den(cjold)
    lo = (1.0 - C.XRATE) / (1.0 + C.XRATE)
    call_lsetup = (first | (cjratio < lo) | (cjratio > 1.0 / lo)) & active
    ss = torch.where(state.cj != state.cjlast, torch.full_like(ss, 100.0), ss)

    lin0 = _Lin(
        lu=state.lu, piv=state.piv, pdata=state.pdata, cjold=cjold, cjratio=cjratio,
        nje=state.nje, nsetups=state.nsetups,
        ls_pt=((state.ls_tn, state.ls_cj, state.ls_yy, state.ls_yp)
               if opts.ls_precision == "refined" else ()),
    )
    zero_i = torch.zeros(bshape, dtype=torch.int32, device=dev)
    dense = opts.linear_solver in ("dense", "band")  # direct

    def fresh_inner(prev: _Inner | None, delta, yy, yp, ss, kre) -> _Inner:
        def krylov(name):
            return () if dense else (zero_i if prev is None else getattr(prev, name))

        return _Inner(
            ycor=torch.zeros_like(state.yy), delta=delta,
            yy=() if dense else yy, yp=() if dense else yp, savres=() if dense else delta,
            oldnrm=state.oldnrm, ss=ss, curiter=zero_i,
            istatus=torch.where(active, _CONTINUE, _OK).to(torch.int32),
            knni=zero_i if prev is None else prev.knni, kre=kre,
            knli=krylov("knli"), knps=krylov("knps"), kncfl=krylov("kncfl"),
            knjtsetup=krylov("knjtsetup"), knjtimes=krylov("knjtimes"),
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

        lin2, setup_fail = _lsetup(state, problem, opts, c.lin, yy, yp, r)
        do_setup = c.call_lsetup & ~res_bad
        lin = tree_where(do_setup, lin2, c.lin)
        # lsetup refreshes ss to 20 (src/ida_nls.rs:179)
        ss = torch.where(do_setup, torch.full_like(c.ss, 20.0), c.ss)
        setup_fail = do_setup & setup_fail
        jcur = c.jcur | do_setup

        inner0 = fresh_inner(c.inner, r, yy, yp, ss, kre)
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
        inner=fresh_inner(None, state.savres, state.yy, state.yp, ss, zero_i),
        lin=lin0,
        ss=ss,
        call_lsetup=call_lsetup,
        jcur=torch.zeros(bshape, dtype=torch.bool, device=dev),
        # inactive lanes start terminal so the Newton loops never touch them
        ostatus=torch.where(active, _CONTINUE, _OK).to(torch.int32),
    )
    if opts.unroll_newton:
        # the retry loop runs at most twice (one retry with a fresh
        # Jacobian sets jcur, so the second pass always ends it): two masked
        # passes are exact
        out = init
        for _ in range(2):
            out = tree_where(cond(out), body(out), out)
    else:
        out = masked_while_loop(cond, body, init)
    inner, lin = out.inner, out.lin

    # fold the loop-local pieces back into the state (inactive lanes keep
    # every field: their loops never ran)
    a = active
    cdt = state.nni.dtype  # widen the local int32 tallies
    if opts.ls_precision == "refined":
        state = state._replace(ls_tn=lin.ls_pt[0], ls_cj=lin.ls_pt[1], ls_yy=lin.ls_pt[2],
                               ls_yp=lin.ls_pt[3])
    state = state._replace(
        lu=lin.lu, piv=lin.piv, pdata=lin.pdata,
        cjold=torch.where(a, lin.cjold, state.cjold),
        cjratio=torch.where(a, lin.cjratio, state.cjratio),
        nje=lin.nje, nsetups=lin.nsetups,
        nni=state.nni + inner.knni.to(cdt),
        nre=state.nre + inner.kre.to(cdt),
        oldnrm=torch.where(a, inner.oldnrm, state.oldnrm),
        ss=torch.where(a, inner.ss, state.ss),
        savres=inner.delta if dense else inner.savres,
    )
    if not dense:
        state = state._replace(
            nli=state.nli + inner.knli.to(cdt),
            nps=state.nps + inner.knps.to(cdt),
            ncfl=state.ncfl + inner.kncfl.to(cdt),
            njtsetup=state.njtsetup + inner.knjtsetup.to(cdt),
            njtimes=state.njtimes + inner.knjtimes.to(cdt),
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
    if not opts.enable_constraints:
        # the block below is an identity for lanes without constraints set
        return state, nl_status
    return _constraints(state, problem, active, ee, yy, nl_status)


def _constraints(state: IdaState, problem: IdaProblem, active, ee, yy, nl_status):
    """The inequality-constraints block (C IDA ``IDANls``; ida_tpu's
    core/nls.py:628-681), every product in its order. Codes: 2 => y > 0,
    1 => y >= 0, -1 => y <= 0, -2 => y < 0, 0 => none. A lane whose
    constraints are set and whose Newton loop converged to a violating
    iterate either pulls the correction back inside (a violation vector
    within the Newton tolerance) or fails the attempt with REC_CONSTRAINT
    and rr = max(0.9 * min quotient(phi[0], phi[0] - y), 0.1). The
    ``any``, the norm and the min over N cross the shards of a state vector
    sharded over N."""
    dtype = state.dtype
    axis = state_axis()
    cvec = state.constraints
    viol = (
        ((cvec == 2.0) & (yy <= 0.0))
        | ((cvec == 1.0) & (yy < 0.0))
        | ((cvec == -1.0) & (yy > 0.0))
        | ((cvec == -2.0) & (yy >= 0.0))
    )
    check = state.constraints_set & (nl_status == C.REC_NONE) & active
    failed = check & any_over(viol, axis)

    mm = viol.to(dtype)
    strict = (cvec.abs() >= 1.5).to(dtype)
    v = mm * (yy - 0.1 * strict * cvec / state.ewt)
    vnorm = wrms_norm_bnd(v, state.ewt, problem.n, state.tn.dim(), axis_name=axis)
    small = vnorm <= state.eps_newt
    # a small violation: the correction pulled back inside (ee only; phi is
    # rebuilt from ee in complete_step)
    ee = torch.where(failed & small, ee - v, ee)

    # a large one: shrink h by the smallest quotient; torch.amin (min_over)
    # and torch.maximum propagate NaN as jnp.min and jnp.maximum do
    phi0 = state.phi[0]
    denom = mm * (phi0 - yy)
    # under safe_ad: guard the discarded 0-division and use a finite
    # no-quotient sentinel (SUNDIALS N_VMinQuotient's BIG_REAL): an inf
    # primal would make the backward 0 * inf = nan
    sentinel = torch.finfo(dtype).max if is_safe_ad() else float("inf")
    quot = torch.where(denom != 0.0, phi0 / smask_den(denom), torch.full_like(denom, sentinel))
    minq = min_over(quot, axis)
    rr_c = torch.maximum(0.9 * minq, torch.full_like(minq, 0.1))
    recvr = failed & ~small
    state = state._replace(ee=ee, rr=torch.where(recvr, rr_c, state.rr))
    return state, torch.where(recvr, C.REC_CONSTRAINT, nl_status).to(torch.int32)
