"""Rootfinding: event detection during integration (L4).

Port of ``ida_tpu/core/root.py`` (reference ``src/impl_r_check.rs``):
``r_check1`` (t0 handling, :32-99), ``r_check2`` (re-check at the last
root, :117-209), ``r_check3`` (search the last step, :221-271) and
``_root_find`` (:343-576), the Illinois modified-secant algorithm (Hiebert &
Shampine, SAND80-0180).

The reference's fold loops over root components are masked reductions over
axis 0 of the [R, *batch] root lanes; the bracketing loop is a host loop
with a hard iteration bound, one device-to-host read per pass
(``ILLINOIS_PASSES`` counts them). Every product and quotient keeps the
order of the JAX code: event times and ``nge`` are held bit for bit.
Roots start active at t0 (C IDA; see ``core/state.py``), and ``iroots`` is
+1 for a rising g, -1 for a falling one (C IDA).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..problem import IdaProblem
from ..utils.ad_mode import smask_den, smask_pos
from ..utils.profiling import scope
from ..utils.tree import bounded_fori_loop, bounded_while_loop, take1, tree_where
from .interp import _eps, interpolate
from .state import IdaOptions, IdaState

# passes of the Illinois loop since the last reset: each is one host read
ILLINOIS_PASSES = 0


def reset_pass_count() -> None:
    global ILLINOIS_PASSES
    ILLINOIS_PASSES = 0


def _eval_root(state: IdaState, problem: IdaProblem, t, yy, yp) -> Tuple[IdaState, torch.Tensor]:
    g = problem.root(t, yy, yp)
    return state._replace(nge=state.nge + 1), g


def _scan(gactive, rootdir, glo, gnew) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared sign-change scan (reference :347-381 and :486-519).

    Returns (zroot, sgnchg, imax): zroot = some active component is exactly
    zero at the far end; sgnchg = a sign change was found; imax = component
    with the largest |gnew/(gnew-glo)| fraction (the first one on a tie, 0
    when nothing changed sign). Reductions run over axis 0 of [R, *batch]."""
    dirok = rootdir.to(glo.dtype) * glo <= 0.0
    active = gactive & dirok
    zroot = (active & (gnew.abs() == 0.0)).any(dim=0)
    chg = active & (gnew.abs() != 0.0) & (glo * gnew < 0.0)
    # no-chg lanes may divide by zero; the where discards the quotient
    gfrac = torch.where(chg, (gnew / smask_den(gnew - glo)).abs(), torch.zeros_like(gnew))
    sgnchg = chg.any(dim=0)
    # first maximal index: strict > against the running maximum, written out
    # because torch.argmax promises no tie order on every backend
    best = gfrac[0]
    imax = torch.zeros(best.shape, dtype=torch.int32, device=best.device)
    for i in range(1, gfrac.shape[0]):
        better = gfrac[i] > best
        imax = torch.where(better, i, imax)
        best = torch.where(better, gfrac[i], best)
    return zroot, sgnchg, imax


@scope("r_check1")
def r_check1(state: IdaState, problem: IdaProblem) -> IdaState:
    """Initialization at t0: evaluate g, deactivate exact zeros, try to
    re-activate at t0 + smallh (reference :32-99)."""
    state = state._replace(
        iroots=torch.zeros_like(state.iroots),
        tlo=state.tn,
        ttol=(state.tn.abs() + state.hh.abs()) * _eps(state) * 100.0,
    )
    state, glo = _eval_root(state, problem, state.tlo, state.phi[0], state.phi[1])

    zero_at_t0 = glo.abs() == 0.0
    gactive = state.gactive & ~zero_at_t0
    any_zero = zero_at_t0.any(dim=0)

    # probe at t0 + smallh (reference :64-95)
    hratio = torch.maximum(state.ttol / state.hh.abs(), torch.full_like(state.ttol, 0.1))
    smallh = hratio * state.hh
    tplus = state.tlo + smallh
    yy_probe = state.phi[0] + smallh * state.phi[1]
    st2, ghi = _eval_root(state, problem, tplus, yy_probe, state.phi[1])
    reactivate = zero_at_t0 & (ghi.abs() != 0.0)
    gactive2 = gactive | reactivate
    glo2 = torch.where(reactivate, ghi, glo)

    return tree_where(
        any_zero,
        st2._replace(gactive=gactive2, glo=glo2),
        state._replace(gactive=gactive, glo=glo),
    )


class RootCheckResult(NamedTuple):
    state: IdaState
    found: torch.Tensor  # bool
    close_roots: torch.Tensor  # bool (r_check2 error condition)


@scope("r_check2")
def r_check2(state: IdaState, problem: IdaProblem) -> RootCheckResult:
    """Re-check for zeros at (and just past) the last root location
    (reference :117-209). Lanes whose last return was not a root
    (``~irfnd``) pass through unchanged, ``nge`` included."""
    start = state
    yy, yp = interpolate(state, state.tlo)
    state = state._replace(yy=yy, yp=yp)
    state, glo = _eval_root(state, problem, state.tlo, yy, yp)
    state = state._replace(glo=glo)

    zero_lo = state.gactive & (glo.abs() == 0.0)
    iroots = zero_lo.to(torch.int32)
    state = state._replace(iroots=iroots)
    any_zero = zero_lo.any(dim=0)

    # probe just past tlo (reference :148-172)
    ttol = (state.tn.abs() + state.hh.abs()) * _eps(state) * 100.0
    smallh = ttol * torch.sign(state.hh)
    tplus = state.tlo + smallh
    use_linear = (tplus - state.tn) * state.hh >= 0.0
    yy_lin = state.yy + (smallh / state.hh) * state.phi[1]
    yy_int, yp_int = interpolate(state, tplus)
    yy_p = torch.where(use_linear, yy_lin, yy_int)
    yp_p = torch.where(use_linear, state.yp, yp_int)
    st2 = state._replace(ttol=ttol, yy=yy_p, yp=yp_p)
    st2, ghi = _eval_root(st2, problem, tplus, yy_p, yp_p)

    # classify (reference :176-195)
    zero_hi = st2.gactive & (ghi.abs() == 0.0)
    close = (zero_hi & (iroots > 0)).any(dim=0)
    new_zero = zero_hi & (iroots == 0)
    iroots2 = torch.where(new_zero, 1, iroots)
    moved_off = st2.gactive & (ghi.abs() != 0.0) & (iroots > 0)
    glo2 = torch.where(moved_off, ghi, glo)
    st2 = st2._replace(iroots=iroots2, glo=glo2)

    state = tree_where(any_zero, st2, state)
    found = any_zero & new_zero.any(dim=0)
    close = any_zero & close

    ran = start.irfnd
    return RootCheckResult(
        state=tree_where(ran, state, start), found=ran & found, close_roots=ran & close
    )


class _Illinois(NamedTuple):
    state: IdaState
    alph: torch.Tensor
    side: torch.Tensor  # int32: 0 initial, 1 low, 2 high
    sideprev: torch.Tensor  # int32: -1 initial
    imax: torch.Tensor  # int32
    done: torch.Tensor  # bool


@scope("root_find")
def _root_find(
    state: IdaState, problem: IdaProblem, opts: IdaOptions
) -> Tuple[IdaState, torch.Tensor]:
    """Illinois modified-secant root location on (tlo, thi)
    (reference :343-576). Returns (state, found)."""
    dtype = state.dtype
    lane, dev = state.tn.shape, state.tn.device

    zroot, sgnchg, imax0 = _scan(state.gactive, state.rootdir, state.glo, state.ghi)

    # --- no sign change: maybe exact zeros at thi (reference :386-410) ---
    dirok = state.rootdir.to(dtype) * state.glo <= 0.0
    # C IDA sign convention: +1 for increasing g, -1 for decreasing (the
    # reference stores sign(glo), which is inverted; not replicated)
    cross_sign = torch.where(state.glo > 0.0, -1, 1).to(torch.int32)
    iroots_zero = torch.where(
        state.gactive & dirok & (state.ghi.abs() == 0.0), cross_sign, torch.zeros_like(cross_sign)
    )
    st_nochg = state._replace(
        trout=state.thi,
        grout=state.ghi,
        iroots=torch.where(zroot, iroots_zero, state.iroots),
    )

    # --- Illinois loop (reference :421-551) ---
    def cond(c: _Illinois) -> torch.Tensor:
        conv = (c.state.thi - c.state.tlo).abs() <= c.state.ttol
        return ~c.done & ~conv

    def body(c: _Illinois) -> _Illinois:
        global ILLINOIS_PASSES
        ILLINOIS_PASSES += 1
        st = c.state
        same_side = c.sideprev == c.side
        alph = torch.where(
            same_side,
            torch.where(c.side == 2, c.alph * 2.0, c.alph * 0.5),
            torch.ones_like(c.alph),
        )

        ghi_i = take1(st.ghi, c.imax)
        glo_i = take1(st.glo, c.imax)
        # done/converged lanes may divide by zero here; the loop's merge
        # discards what they compute
        tmid = st.thi - (st.thi - st.tlo) * ghi_i / smask_den(ghi_i - alph * glo_i)

        # inward nudges (reference :453-470); 0.5 / x is exact as
        # reciprocal(x) * 0.5
        fracint = (st.thi - st.tlo).abs() / st.ttol
        fracsub = torch.where(fracint > 5.0, torch.full_like(fracint, 0.1), 0.5 / smask_pos(fracint))
        tmid = torch.where(
            (tmid - st.tlo).abs() < 0.5 * st.ttol, st.tlo + fracsub * (st.thi - st.tlo), tmid
        )
        tmid = torch.where(
            (st.thi - tmid).abs() < 0.5 * st.ttol, st.thi - fracsub * (st.thi - st.tlo), tmid
        )

        yy, yp = interpolate(st, tmid)
        st = st._replace(yy=yy, yp=yp)
        st, grout = _eval_root(st, problem, tmid, yy, yp)
        st = st._replace(grout=grout)

        zroot, sgnchg, imax = _scan(st.gactive, st.rootdir, st.glo, grout)

        # bracket update (reference :522-551): a sign change in (tlo, tmid)
        # or g = 0 at tmid moves thi; else the change is in (tmid, thi)
        low = sgnchg | zroot
        st = st._replace(
            thi=torch.where(low, tmid, st.thi),
            ghi=torch.where(low, grout, st.ghi),
            tlo=torch.where(low, st.tlo, tmid),
            glo=torch.where(low, st.glo, grout),
        )
        side = torch.where(sgnchg, 1, torch.where(zroot, c.side, 2)).to(torch.int32)
        done = ~sgnchg & zroot
        imax = torch.where(sgnchg, imax, c.imax)
        return _Illinois(state=st, alph=alph, side=side, sideprev=c.side, imax=imax, done=done)

    init = _Illinois(
        state=state,
        alph=torch.full(lane, 1.0, dtype=dtype, device=dev),
        side=torch.full(lane, 0, dtype=torch.int32, device=dev),
        sideprev=torch.full(lane, -1, dtype=torch.int32, device=dev),
        imax=imax0,
        # no sign change => the loop must not run (reference returns early)
        done=~sgnchg,
    )
    # bounded: ttol convergence is guaranteed mathematically, not structurally
    loop = bounded_fori_loop if opts.unroll_roots else bounded_while_loop
    st = loop(cond, body, init, opts.max_root_iters).state

    # found-root epilogue (reference :554-575)
    dirok2 = st.rootdir.to(dtype) * st.glo <= 0.0
    hit = st.gactive & dirok2 & ((st.ghi.abs() == 0.0) | (st.glo * st.ghi < 0.0))
    st_found = st._replace(
        trout=st.thi,
        grout=st.ghi,
        iroots=torch.where(
            hit, torch.where(st.glo > 0.0, -1, 1).to(torch.int32), torch.zeros_like(st.iroots)
        ),
    )

    state = tree_where(sgnchg, st_found, st_nochg)
    return state, sgnchg | zroot


@scope("r_check3")
def r_check3(
    state: IdaState, problem: IdaProblem, opts: IdaOptions, task_normal: bool
) -> RootCheckResult:
    """Search (tlo, tn-or-tout) for roots after a successful step
    (reference :221-271)."""
    if task_normal:
        thi = torch.where((state.toutc - state.tn) * state.hh >= 0.0, state.tn, state.toutc)
    else:
        thi = state.tn
    state = state._replace(thi=thi)

    yy, yp = interpolate(state, thi)
    state = state._replace(yy=yy, yp=yp)
    state, ghi = _eval_root(state, problem, thi, yy, yp)
    state = state._replace(
        ghi=ghi, ttol=(state.tn.abs() + state.hh.abs()) * _eps(state) * 100.0
    )

    state, found = _root_find(state, problem, opts)

    # re-activate components that moved off zero (reference :254-260)
    gactive = state.gactive | (state.grout != 0.0)
    state = state._replace(gactive=gactive, tlo=state.trout, glo=state.grout)

    # interpolate to the root location (reference :266-269)
    yy, yp = interpolate(state, state.trout)
    state = state._replace(
        yy=torch.where(found, yy, state.yy), yp=torch.where(found, yp, state.yp)
    )
    return RootCheckResult(
        state=state, found=found, close_roots=torch.zeros_like(found)
    )
