"""Forward, adjoint and second-order sensitivities by AD through the solver.

Port of ``ida_tpu/sensitivity.py``. The C SUNDIALS family needs a separate
package (IDAS) for dy/dp and dL/dp; here the eager solver is plain torch, so:

- one forward-mode pass (``torch.autograd.forward_ad`` dual tensors) through
  ``core.solve`` gives FORWARD parameter sensitivities of the numerical
  solution (:func:`forward_sensitivity`); dual tensors rather than
  ``torch.func.jvp``, so the host reads of the attempt loop keep working;
- one backward pass through every step attempt gives the DISCRETE ADJOINT
  gradient of a loss of the solution (:func:`adjoint_gradient`), the IDAS
  "IDAA" role, consistent with the forward numerics by construction;
  :func:`batched_adjoint_gradient` does it for a whole ensemble in ONE
  batch-native solve and one backward (lanes are independent, so lane b's
  gradient of the sum of the lane losses is dL_b/dp_b);
- a backward pass through that backward (``create_graph=True``) gives
  Hessian-vector products (:func:`adjoint_hvp`);
- :func:`continuous_adjoint` integrates the adjoint DAE backwards from
  checkpoint-interpolated forward data instead (IDAAdjInit / IDASolveB /
  IDACalcICB / backward quadratures), at about two solves' cost.

On the card every Newton solve goes through the batched LU kernel (K1) and
its backward through the transposed-solve kernel ``small_lu_solve_t``
(``ops/dense_lu.py``'s Functions); the whole-solve kernels (K2-K5) are
forward-only and refuse inputs that carry a derivative, as ``ida_tpu``'s do.

Reverse mode needs the ``safe_ad()`` context (``utils/ad_mode.py``): the
self-masked lanes legitimately compute discarded inf/nan whose backward
``0 * inf`` products would poison real gradients; under it every such site
is guarded without changing the primal. The adjoint path also runs the
fixed-trip forms of the Newton and root loops (``_reverse_opts``), as
``ida_tpu``'s does: the same arithmetic in every lane, and no host read
inside them.

Layouts are ``ida_tpu``'s: one lane's ``params`` are what the factory takes
([P]); a batch is ``params`` [B, P], with ``yy0_of`` / ``yp0_of`` /
``loss_of`` per-lane maps applied over the lanes (``torch.func.vmap``), and
results ``vals[B]``, ``grads[B, P]``, ``istates[B]``. Inside, the solve runs
batch-native (the factory receives [P, B]). Entry points run on the current
CUDA device unless ``device`` names another (``device="cpu"``).

Caveat (inherent to differentiating adaptive solvers): the derivative is
that of the NUMERICAL solution, step-size and order control included,
which is piecewise smooth in the parameters; tighten rtol/atol for a tight
dy/dp as for y itself. Memory: reverse mode keeps every attempt's
intermediates (``IdaOptions(remat_attempts=True)`` keeps only the attempt
loop's carry and recomputes the rest).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.autograd import forward_ad

from . import constants as C
from .core.calc_ic import IC_CODES, IC_YA_YDP_INIT
from .core.calc_ic import calc_ic as core_calc_ic
from .core.quad import get_quad
from .core.solve import TASK_NORMAL, solve_dense
from .core.solve import solve as core_solve
from .core.state import IdaOptions, init_state
from .ops.dense_lu import _matvec, lu_factor_auto, lu_solve_auto, lu_solve_t_auto
from .parallel.batch import _native_shared_tol, to_native
from .problem import IdaProblem, jacobian
from .tol_control import TolControl
from .utils.ad_mode import safe_ad
from .utils.device import resolve_device
from .utils.tree import take_row


# --------------------------------------------------------------- helpers


def _native_state(problem: IdaProblem, yy0: torch.Tensor, yp0: torch.Tensor, dtype, opts):
    """A batch-native state from batch-native [N] or [N, B] initial values
    (differentiable in both)."""
    if yy0.dim() == 1:
        return init_state(problem, yy0, yp0, device=yy0.device, dtype=dtype, opts=opts)
    return to_native(init_state(problem, yy0.movedim(0, -1), yp0.movedim(0, -1),
                                device=yy0.device, dtype=dtype, opts=opts))


def _native_tol(tol: TolControl, state) -> TolControl:
    """``tol`` as the batch-native core takes it (shared by every lane)."""
    return tol if state.tn.dim() == 0 else _native_shared_tol(tol, state)


def _tangent_by_rows(fn: Callable, primals: tuple, tangents: tuple) -> torch.Tensor:
    """The tangent of a lane-separable ``fn(*primals) -> [N, *batch]`` along
    ``tangents``, from the N rows of its Jacobians (vmapped vjps of unit
    cotangents): forward mode cannot nest, and a Function's ``jvp`` runs
    inside the caller's forward-mode level."""
    out, pull = torch.func.vjp(fn, *primals)
    n = out.shape[0]
    units = torch.eye(n, dtype=out.dtype, device=out.device)
    units = units.reshape((n, n) + (1,) * (out.dim() - 1)).expand((n,) + tuple(out.shape))
    rows = torch.func.vmap(pull)(units)  # per input: [N, *input.shape]
    return sum((r * t.unsqueeze(0)).sum(dim=1) for r, t in zip(rows, tangents))


def _eye_like(v: torch.Tensor) -> torch.Tensor:
    """Per lane ``diag(v)``: [N, *batch] -> [N, N, *batch]."""
    n = v.shape[0]
    eye = torch.eye(n, dtype=v.dtype, device=v.device).reshape((n, n) + (1,) * (v.dim() - 1))
    return eye * v.unsqueeze(0)


def _params(params, dtype, device) -> torch.Tensor:
    return torch.as_tensor(params, dtype=dtype, device=resolve_device(device))


def _lanes(fn: Callable, batched: bool) -> Callable:
    """A per-lane map, over the lanes of a batch-leading argument when
    ``batched``."""
    return torch.func.vmap(fn) if batched else fn


# ------------------------------------------------------- forward mode


def solve_with_params(
    problem_factory: Callable[[Any], IdaProblem],
    params: Any,
    yy0_of: Callable[[Any], torch.Tensor],
    yp0_of: Callable[[Any], torch.Tensor],
    tol: TolControl,
    tout,
    opts: IdaOptions = IdaOptions(),
    dtype=torch.float64,
):
    """Differentiable map params -> y(tout) of one lane (the state's device
    is that of the params it is called with). Initial conditions may depend
    on the parameters through ``yy0_of``/``yp0_of``. ``params`` is unused,
    as in ``ida_tpu``: the returned function takes them."""

    def f(p):
        prob = problem_factory(p)
        st = init_state(prob, yy0_of(p), yp0_of(p), device=p.device, dtype=dtype, opts=opts)
        st, _, _ = core_solve(st, prob, opts, tol, tout, TASK_NORMAL)
        return st.yy

    return f


def forward_sensitivity(
    problem_factory,
    params,
    yy0_of,
    yp0_of,
    tol: TolControl,
    tout,
    tangent,
    opts: IdaOptions = IdaOptions(),
    *,
    dtype=torch.float64,
    device=None,
):
    """One forward-mode pass: returns (y(tout), dy/dp . tangent)."""
    p = _params(params, dtype, device)
    f = solve_with_params(problem_factory, p, yy0_of, yp0_of, tol, tout, opts, dtype)
    with forward_ad.dual_level():
        y = f(forward_ad.make_dual(p, torch.as_tensor(tangent, dtype=dtype, device=p.device)))
        primal, tan = forward_ad.unpack_dual(y)
    return primal, tan


# ------------------------------------------- consistent ICs, implicitly


def make_consistent_ic(
    problem_factory,
    icopt: str,
    tout1,
    tol: TolControl,
    opts: IdaOptions = IdaOptions(),
    dtype=torch.float64,
    t0=0.0,
):
    """Differentiable consistent-IC computation (the IDAS ``IDASensCalcIC``
    role), by implicit differentiation of the solved IC system.

    Returns ``cic(params, yy0, yp0) -> (yyc, ypc, ok)``: the primal is
    exactly ``core.calc_ic`` (``icopt`` "ya_ydp" or "y") and the derivative
    comes from the implicit function theorem at its solution. With unknowns
    ``u`` (algebraic y and differential y' for YA_YDP; all of y for Y_INIT)
    satisfying ``G(u, p) = F(t0, yy(u), yp(u)) = 0``,

        du/dp = -(dG/du)^{-1} dG/dp,

    one more factorization (through ``lu_factor_auto``: K1 on the card up to
    N = 16) instead of differentiating the damped Newton / line-search /
    h-retry iteration. ``ida_tpu`` gets the reverse rule by transposing its
    linear ``custom_jvp``; here both are written out in one
    ``torch.autograd.Function``: the tangent ``-(dG/du)^{-1} G'``, and the
    cotangent ``w = -(dG/du)^{-T} u_bar`` pulled back by one vjp of G in
    (p, yy0, yp0). Both are made of differentiable operations. ``ok`` (1.0
    or 0.0, no derivative) is 0 where the IC solve failed, where the
    implicit derivative means nothing.

    Shapes: ``params`` as the factory takes them, ``yy0``/``yp0`` [N] for
    one lane or batch-native [N, B]."""
    icopt_i = IC_CODES[icopt]

    def parts(p, yy0, yp0):
        prob = problem_factory(p)
        if icopt_i == IC_YA_YDP_INIT:
            if prob.id is None:
                raise ValueError("ya_ydp requires problem.id")
            dm = prob.id.to(device=yy0.device, dtype=dtype).reshape((-1,) + (1,) * (yy0.dim() - 1))
        else:
            dm = None
        tt = torch.full(yy0.shape[1:], t0, dtype=dtype, device=yy0.device)
        return prob, dm, tt

    def sel(dm, u, a, b):
        """(yy, yp) from the unknowns u and the fixed parts a, b."""
        if dm is None:
            return u, b
        return dm * a + (1.0 - dm) * u, dm * u + (1.0 - dm) * b

    def g_of(dm, tt):
        def G(u, p_, a, b):
            yy, yp = sel(dm, u, a, b)
            return problem_factory(p_).res(tt, yy, yp)
        return G

    def factored(dm, tt, u_star, p, yy0, yp0):
        G = g_of(dm, tt)
        return lu_factor_auto(jacobian(lambda u: G(u, p, yy0, yp0), u_star)), G

    class ConsistentIC(torch.autograd.Function):
        @staticmethod
        def forward(p, yy0, yp0):
            prob, _, tt = parts(p, yy0, yp0)
            st = _native_state(prob, yy0.detach(), yp0.detach(), dtype, opts)
            # the primal solve and the linearization at the SAME time t0
            st = st._replace(tn=tt)
            st2, ok = core_calc_ic(st, prob, opts, _native_tol(tol, st), icopt_i, tout1)
            return st2.yy, st2.yp, ok.to(dtype)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.mark_non_differentiable(output[2])
            ctx.save_for_backward(*inputs, output[0], output[1])
            ctx.save_for_forward(*inputs, output[0], output[1])

        @staticmethod
        def backward(ctx, g_yy, g_yp, g_ok):
            p, yy0, yp0, yyc, ypc = ctx.saved_tensors
            _, dm, tt = parts(p, yy0, yp0)
            u_star = yyc if dm is None else dm * ypc + (1.0 - dm) * yyc
            fact, G = factored(dm, tt, u_star, p, yy0, yp0)
            if dm is None:
                u_bar, yy0_bar, yp0_bar = g_yy, torch.zeros_like(yy0), g_yp
            else:
                u_bar = (1.0 - dm) * g_yy + dm * g_yp
                yy0_bar, yp0_bar = dm * g_yy, (1.0 - dm) * g_yp
            w = -lu_solve_t_auto(fact, u_bar)
            _, pull = torch.func.vjp(lambda p_, a, b: G(u_star, p_, a, b), p, yy0, yp0)
            p_bar, a_bar, b_bar = pull(w)
            return p_bar, yy0_bar + a_bar, yp0_bar + b_bar

        @staticmethod
        def jvp(ctx, t_p, t_yy0, t_yp0):
            p, yy0, yp0, yyc, ypc = ctx.saved_tensors
            t_p = torch.zeros_like(p) if t_p is None else t_p
            t_yy0 = torch.zeros_like(yy0) if t_yy0 is None else t_yy0
            t_yp0 = torch.zeros_like(yp0) if t_yp0 is None else t_yp0
            _, dm, tt = parts(p, yy0, yp0)
            u_star = yyc if dm is None else dm * ypc + (1.0 - dm) * yyc
            fact, G = factored(dm, tt, u_star, p, yy0, yp0)
            g_dot = _tangent_by_rows(lambda p_, a, b: G(u_star, p_, a, b),
                                     (p, yy0, yp0), (t_p, t_yy0, t_yp0))
            u_dot = -lu_solve_auto(fact, g_dot)
            if dm is None:
                return u_dot, t_yp0, None
            return dm * t_yy0 + (1.0 - dm) * u_dot, dm * u_dot + (1.0 - dm) * t_yp0, None

    def cic(p, yy0, yp0):
        return ConsistentIC.apply(p, yy0, yp0)

    return cic


# ------------------------------------------------------ discrete adjoint


def _reverse_opts(opts):
    """The fixed-trip forms of the Newton loop and the Illinois root loop,
    as ``ida_tpu``'s adjoint path forces them (arithmetic per lane
    unchanged; no host read inside either loop)."""
    if opts is None:
        opts = IdaOptions()
    if not (opts.unroll_newton and opts.unroll_roots):
        opts = dataclasses.replace(opts, unroll_newton=True, unroll_roots=True)
    return opts


def _make_loss_fn(
    problem_factory, yy0_of, yp0_of, tol, tout, loss_of, opts,
    max_attempts, dtype, loss_of_state, ic, batched,
):
    """``f(p) -> (loss, istate)``: one lane for ``p`` [P], every lane of a
    batch for ``p`` [B, P] when ``batched`` (one batch-native solve; the
    loss is then [B])."""
    cic = (make_consistent_ic(problem_factory, ic[0], ic[1], tol, opts=opts, dtype=dtype)
           if ic is not None else None)

    def f(p):
        pf = p.t() if batched else p  # what the factory takes: [P] or [P, B]
        yy0 = _lanes(yy0_of, batched)(p)
        yp0 = _lanes(yp0_of, batched)(p)
        yy0 = torch.as_tensor(yy0, dtype=dtype, device=p.device)
        yp0 = torch.as_tensor(yp0, dtype=dtype, device=p.device)
        if batched:  # [B, N] from the lanes -> batch-native [N, B]
            yy0, yp0 = yy0.t(), yp0.t()
        prob = problem_factory(pf)
        ic_ok = None
        if cic is not None:
            yy0, yp0, ic_ok = cic(pf, yy0, yp0)
        st = _native_state(prob, yy0, yp0, dtype, opts)
        out = core_solve(st, prob, opts, _native_tol(tol, st), tout, TASK_NORMAL,
                         max_attempts=max_attempts)
        istate = out[2]
        if ic_ok is not None:
            # a failed IC solve (whose implicit derivative means nothing)
            # surfaces as CONV_FAIL, C IDACalcIC's failure code
            istate = torch.where(ic_ok > 0.0, istate, torch.full_like(istate, C.CONV_FAIL))
        if loss_of_state is not None:
            return loss_of_state(out[0], out[1], prob), istate
        return _lanes(loss_of, batched)(out[0].yy.t() if batched else out[0].yy), istate

    return f


def _value_and_grad(f, p):
    """(loss, d sum(loss) / dp, istate) under safe_ad."""
    p = p.detach().requires_grad_()
    with safe_ad():
        val, istate = f(p)
        (grad,) = torch.autograd.grad(val.sum(), p, allow_unused=True, materialize_grads=True)
    return val.detach(), grad, istate


def adjoint_gradient(
    problem_factory,
    params,
    yy0_of,
    yp0_of,
    tol: TolControl,
    tout,
    loss_of,
    opts: IdaOptions | None = None,
    max_attempts: int = 500,
    dtype=torch.float64,
    loss_of_state=None,
    ic=None,
    *,
    device=None,
):
    """Reverse-mode (discrete-adjoint) gradient of ``loss_of(y(tout))``
    with respect to ``params``, the IDAS adjoint (IDAA) analogue.

    Returns ``(loss, grad, istate)``; ``istate`` is the solver's return
    code (0 = success), and the gradient means something only when the
    solve succeeded. ``max_attempts`` bounds the attempt loop: it must
    cover the whole integration, or ``istate`` stays CONTINUE.

    ``loss_of_state`` (optional, overrides ``loss_of``) receives ``(state,
    tret, problem)`` and returns a scalar: a loss on quadratures
    (``core.quad.get_quad(state, problem, tret)``), on the return time of a
    root, or on anything beyond y(tout).

    ``ic`` (optional): ``("ya_ydp" | "y", tout1)``: first make the
    (possibly inconsistent) ``yy0_of(p)``/``yp0_of(p)`` consistent with
    ``calc_ic``, differentiating THROUGH the IC solve implicitly
    (:func:`make_consistent_ic`), then integrate."""
    f = _make_loss_fn(problem_factory, yy0_of, yp0_of, tol, tout, loss_of, _reverse_opts(opts),
                      max_attempts, dtype, loss_of_state, ic, batched=False)
    return _value_and_grad(f, _params(params, dtype, device))


def batched_adjoint_gradient(
    problem_factory,
    params,
    yy0_of,
    yp0_of,
    tol: TolControl,
    tout,
    loss_of,
    opts: IdaOptions | None = None,
    max_attempts: int = 500,
    dtype=torch.float64,
    loss_of_state=None,
    ic=None,
    *,
    device=None,
):
    """Per-lane losses AND per-lane gradients of an ensemble, ``params``
    [B, P] (multi-start parameter estimation): ``ida_tpu``'s vmapped
    ``adjoint_gradient``, here batch-native: ONE solve over all lanes, then
    ONE backward of the sum of the lane losses (the lanes are independent,
    so lane b's gradient is dL_b/dp_b). ``yy0_of``/``yp0_of``/``loss_of``
    are per-lane maps, applied over the lanes. ``loss_of_state`` receives
    the batch-native state ([..., B]) and returns the [B] lane losses.
    Returns ``(vals[B], grads[B, P], istates[B])``."""
    f = _make_loss_fn(problem_factory, yy0_of, yp0_of, tol, tout, loss_of, _reverse_opts(opts),
                      max_attempts, dtype, loss_of_state, ic, batched=True)
    return _value_and_grad(f, _params(params, dtype, device))


def adjoint_hvp(
    problem_factory,
    params,
    yy0_of,
    yp0_of,
    tol: TolControl,
    tout,
    loss_of,
    tangent,
    opts: IdaOptions | None = None,
    max_attempts: int = 500,
    dtype=torch.float64,
    loss_of_state=None,
    ic=None,
    *,
    device=None,
):
    """Second-order sensitivity: the Hessian-vector product ``(d2L/dp2) .
    tangent`` of a scalar loss of the solution. ``ida_tpu`` takes a jvp of
    its adjoint gradient (forward over reverse); here a second backward
    through the first (reverse over reverse, ``create_graph=True``) gives
    the same product. Returns ``(grad, hvp, istate)``."""
    f = _make_loss_fn(problem_factory, yy0_of, yp0_of, tol, tout, loss_of, _reverse_opts(opts),
                      max_attempts, dtype, loss_of_state, ic, batched=False)
    p = _params(params, dtype, device).detach().requires_grad_()
    v = torch.as_tensor(tangent, dtype=dtype, device=p.device)
    with safe_ad():
        val, istate = f(p)
        (grad,) = torch.autograd.grad(val, p, create_graph=True)
        (hvp,) = torch.autograd.grad(grad, p, grad_outputs=v, allow_unused=True,
                                     materialize_grads=True)
    return grad.detach(), hvp, istate


# ----------------------------------------------------- continuous adjoint


def _hermite_interp(knots_t, knots_y, knots_yp, t):
    """Cubic-Hermite interpolation of the forward solution between
    checkpoints (IDAS's checkpoint interpolation, IDAADJ_HERMITE).
    ``knots_t`` [K]; ``knots_y``/``knots_yp`` [K, N, *batch]; ``t``
    [*batch]. Returns (y(t), yp(t)), each [N, *batch]."""
    k = knots_t.shape[0]
    i = (torch.searchsorted(knots_t, t, right=True) - 1).clamp(0, k - 2)
    t0 = knots_t[i]
    t1 = knots_t[i + 1]
    y0, y1 = take_row(knots_y, i), take_row(knots_y, i + 1)
    d0, d1 = take_row(knots_yp, i), take_row(knots_yp, i + 1)
    h = t1 - t0
    s = (t - t0) / h
    s2, s3 = s * s, s * s * s
    y = (
        (2 * s3 - 3 * s2 + 1) * y0
        + (s3 - 2 * s2 + s) * h * d0
        + (-2 * s3 + 3 * s2) * y1
        + (s3 - s2) * h * d1
    )
    yp = (
        (6 * s2 - 6 * s) / h * y0
        + (3 * s2 - 4 * s + 1) * d0
        + (-6 * s2 + 6 * s) / h * y1
        + (3 * s2 - 2 * s) * d1
    )
    return y, yp


def _continuous_native(problem_factory, p, yy0, yp0, tol, tout, g_lanes, grad_g,
                       grid, opts, tol_b, lamT, dtype):
    """:func:`continuous_adjoint` for one lane ([N]) or batch-native lanes
    ([N, B], the factory taking [P, B]): ``g_lanes(y) -> [*batch]`` and
    ``grad_g(y) -> [N, *batch]`` act on batch-native y."""
    opts = opts or IdaOptions()
    tol_b = tol_b or tol
    dev = yy0.device
    bshape = tuple(yy0.shape[1:])
    prob = problem_factory(p)
    if prob.nroots != 0:
        raise ValueError("continuous_adjoint: rootfinding is not supported")
    tdt = torch.full(bshape, float(tout), dtype=dtype, device=dev)
    t0 = torch.zeros(bshape, dtype=dtype, device=dev)
    if grid is None:
        grid = torch.linspace(0.0, float(tout), 129, dtype=dtype)[1:]
    grid = torch.as_tensor(grid, dtype=dtype, device=dev)
    n = prob.n

    # --- 1. forward pass with dense checkpoints
    st = _native_state(prob, yy0, yp0, dtype, opts)
    _, _, out_ist, out_yy, out_yp, _ = solve_dense(st, prob, opts, _native_tol(tol, st), grid)
    ist_f = out_ist.abs().amax(dim=0)  # 0 iff every row succeeded
    loss = g_lanes(out_yy[-1])
    knots_t = torch.cat([torch.zeros(1, dtype=dtype, device=dev), grid])
    knots_y = torch.cat([yy0.unsqueeze(0), out_yy])
    knots_yp = torch.cat([yp0.unsqueeze(0), out_yp])

    def interp(t):
        return _hermite_interp(knots_t, knots_y, knots_yp, t)

    # --- 2. terminal conditions
    y_end, yp_end = out_yy[-1], out_yp[-1]
    m_t = jacobian(lambda v: prob.res(tdt, y_end, v), yp_end)  # dF/dy'
    j_t = jacobian(lambda v: prob.res(tdt, v, yp_end), y_end)  # dF/dy
    m_alg = (m_t.abs().amax(dim=0) == 0.0).to(dtype)  # zero columns of M: [N, *batch]
    if lamT is None:
        # [M^T, -J^T diag(m); diag(m) J^T, diag(1 - m)] [lam; mu] = [-g_y; 0]
        jt, mt = j_t.transpose(0, 1), m_t.transpose(0, 1)
        kkt = torch.cat([
            torch.cat([mt, -jt * m_alg.unsqueeze(0)], dim=1),
            torch.cat([m_alg.unsqueeze(1) * jt, _eye_like(1.0 - m_alg)], dim=1),
        ])
        rhs = torch.cat([-grad_g(y_end), torch.zeros_like(y_end)])
        lam_t = lu_solve_auto(lu_factor_auto(kkt), rhs)[:n]
    else:
        lam_t = torch.as_tensor(lamT, dtype=dtype, device=dev)
    # consistent lambda'(T): M^T lam' = J^T lam on the differential rows
    rhsd = (1.0 - m_alg) * _matvec(j_t.transpose(0, 1), lam_t)
    lamp_t = lu_solve_auto(lu_factor_auto(m_t.transpose(0, 1) + _eye_like(m_alg)),
                           rhsd) * (1.0 - m_alg)

    # --- 3. backward problem: R = M^T lam' - J^T lam, quad = F_p^T lam
    def res_b(t, lam, lamp):
        y_t, yp_t = interp(t)
        _, pull = torch.func.vjp(lambda yy, yp: prob.res(t, yy, yp), y_t, yp_t)
        jty_lam, _ = pull(lam)  # J^T lam
        _, mty_lamp = pull(lamp)  # M^T lam'
        return mty_lamp - jty_lam

    # the parameters as one axis of quadratures (a scalar parameter is one)
    n_p = p.shape[0] if p.dim() else 1

    def quad_b(t, lam, lamp):
        y_t, yp_t = interp(t)
        _, pull = torch.func.vjp(lambda p_: problem_factory(p_).res(t, y_t, yp_t), p)
        return pull(lam)[0].reshape((n_p,) + tuple(lam.shape[1:]))  # F_p^T lam

    # one differential/algebraic split for every lane (the problem's id is [N])
    id_b = m_alg.reshape(n, -1)
    if not bool((id_b == id_b[:, :1]).all()):
        raise ValueError("continuous_adjoint: the lanes' algebraic components differ")
    prob_b = IdaProblem(n=n, res=res_b, id=id_b[:, 0] == 0.0, quad=quad_b, nquad=n_p)
    opts_b = dataclasses.replace(opts, suppressalg=True)
    st_b = _native_state(prob_b, lam_t, lamp_t, dtype, opts_b)
    st_b = st_b._replace(tn=tdt, tlo=tdt)
    st_b, tret_b, ist_b = core_solve(st_b, prob_b, opts_b, _native_tol(tol_b, st_b), t0,
                                     TASK_NORMAL)

    # --- 4. gradients: yQ integrated T -> t0 holds -(int_t0^T lam^T F_p dt);
    # get_quad trims the part of the last step that overshot past t0
    grad_p = -get_quad(st_b, prob_b, tret_b).reshape(p.shape)
    m_0 = jacobian(lambda v: prob.res(t0, yy0, v), yp0)
    grad_y0 = -_matvec(m_0.transpose(0, 1), st_b.yy)
    return loss, grad_p, grad_y0, ist_f, ist_b


def continuous_adjoint(
    problem_factory,
    params,
    yy0,
    yp0,
    tol: TolControl,
    tout,
    g_of,
    *,
    grid=None,
    opts: IdaOptions | None = None,
    tol_b: TolControl | None = None,
    lamT=None,
    dtype=torch.float64,
    device=None,
):
    """Continuous-adjoint gradient of ``g_of(y(tout))`` (the IDAS adjoint
    MODULE: IDAAdjInit + IDASolveB + IDACalcICB + backward quadratures), as
    opposed to :func:`adjoint_gradient`'s backward pass through the solver.

    Method (Cao-Li-Petzold adjoint for F(t, y, y', p) = 0):

    1. FORWARD: one ``core.solve.solve_dense`` pass records (t_k, y_k,
       y'_k) on ``grid``; between checkpoints the trajectory is
       cubic-Hermite interpolated.
    2. TERMINAL CONDITIONS at T: lambda(T) solves the square KKT system
       ``[M^T, -J^T diag(m); diag(m) J^T, diag(1-m)] [lambda; mu] = [-g_y^T;
       0]`` with M = dF/dy', J = dF/dy at T and m the algebraic mask (zero
       columns of M), through ``lu_factor_auto`` (K1 on the card at 2N <=
       16). For a pure ODE it is M^T lambda = -g_y^T. ``lamT`` overrides it.
    3. BACKWARD: the adjoint DAE ``d/dt(M^T lambda) = J^T lambda``,
       integrated from T down to t0 by the same solver (negative steps),
       residual ``M^T lambda' - J^T lambda`` from vjps of the residual at
       the interpolated forward solution (dM/dt = 0 is assumed along
       trajectories: exact for F = M y' + phi(t, y, p) with constant M).
       The gradient integrand rides the quadratures (``core/quad.py``).
    4. GRADIENTS: dG/dp = int lambda^T F_p dt, dG/dy0 = -M(t0)^T
       lambda(t0).

    Cost: about two solves and O(grid) checkpoint memory. ``grid``:
    increasing checkpoint times in (t0, tout], the last one tout (default
    128 uniform points; take a log-spaced grid for multi-decade stiff
    horizons). Returns ``(loss, grad_p, grad_y0, ist_fwd, ist_bwd)``; the
    gradients mean something only when both codes are 0."""
    p = _params(params, dtype, device)
    yy0 = torch.as_tensor(yy0, dtype=dtype, device=p.device)
    yp0 = torch.as_tensor(yp0, dtype=dtype, device=p.device)
    return _continuous_native(problem_factory, p, yy0, yp0, tol, tout, g_of,
                              torch.func.grad(g_of), grid, opts, tol_b, lamT, dtype)


def batched_continuous_adjoint(
    problem_factory,
    params,
    yy0,
    yp0,
    tol: TolControl,
    tout,
    g_of,
    *,
    grid=None,
    opts: IdaOptions | None = None,
    tol_b: TolControl | None = None,
    dtype=torch.float64,
    device=None,
):
    """:func:`continuous_adjoint` over an ensemble, ``params`` [B, P],
    ``yy0``/``yp0`` [B, N] (``bench.py``'s vmapped form, here one
    batch-native forward solve and one backward solve); ``g_of`` is a
    per-lane map. Returns ``(loss[B], grad_p[B, P], grad_y0[B, N],
    ist_fwd[B], ist_bwd[B])``."""
    p = _params(params, dtype, device)
    bsz = p.shape[0]
    yy0 = torch.as_tensor(yy0, dtype=dtype, device=p.device).expand(bsz, -1).t()
    yp0 = torch.as_tensor(yp0, dtype=dtype, device=p.device).expand(bsz, -1).t()
    out = _continuous_native(
        problem_factory, p.t(), yy0, yp0, tol, tout,
        lambda y: torch.func.vmap(g_of)(y.t()),
        lambda y: torch.func.vmap(torch.func.grad(g_of))(y.t()).t(),
        grid, opts, tol_b, None, dtype)
    loss, grad_p, grad_y0, ist_f, ist_b = out
    return loss, grad_p.t(), grad_y0.t(), ist_f, ist_b


# ``ida_tpu``'s routing window between the two adjoint strategies, in step
# ATTEMPTS of the forward solve, kept as its constants
# (ida_tpu/sensitivity.py:573-574) so that both packages route alike. The
# discrete adjoint back-propagates through every attempt (cost and memory
# linear in attempts), the continuous adjoint costs about two solves and a
# checkpoint pass whatever the horizon; its gradient is limited by the
# cubic-Hermite interpolation, so long multi-decade stiff horizons stay on
# the discrete tape. The card's own ratio of the two is measured by
# chip_smoke.py (PERF.md).
ADJOINT_CROSSOVER_ATTEMPTS = 48
ADJOINT_CONTINUOUS_MAX_ATTEMPTS = 160


def adjoint_gradient_auto(
    problem_factory,
    params,
    yy0,
    yp0,
    tol: TolControl,
    tout,
    loss_of,
    *,
    opts: IdaOptions | None = None,
    max_attempts: int = 500,
    dtype=torch.float64,
    grid=None,
    crossover: int = ADJOINT_CROSSOVER_ATTEMPTS,
    continuous_max: int = ADJOINT_CONTINUOUS_MAX_ATTEMPTS,
    device=None,
):
    """Gradient of ``loss_of(y(tout))`` w.r.t. ``params``, routed between
    the discrete adjoint (:func:`adjoint_gradient`) and the continuous one
    (:func:`continuous_adjoint`) by the expected horizon: continuous when
    the problem has no roots and ``crossover <= max_attempts <=
    continuous_max``, discrete otherwise. ``yy0``/``yp0`` are fixed
    tensors (the continuous path does not follow parameter-dependent
    initial conditions). Returns ``(loss, grad, istate)``; ``istate`` is 0
    on success (on the continuous route, nonzero if either integration
    failed)."""
    p = _params(params, dtype, device)
    yy0 = torch.as_tensor(yy0, dtype=dtype, device=p.device)
    yp0 = torch.as_tensor(yp0, dtype=dtype, device=p.device)
    if problem_factory(p).nroots == 0 and crossover <= max_attempts <= continuous_max:
        loss, grad_p, _, ist_f, ist_b = continuous_adjoint(
            problem_factory, p, yy0, yp0, tol, tout, loss_of, grid=grid, opts=opts,
            dtype=dtype, device=p.device)
        return loss, grad_p, torch.where(ist_f != 0, ist_f, ist_b).to(torch.int32)
    return adjoint_gradient(
        problem_factory, p, lambda _: yy0, lambda _: yp0, tol, tout, loss_of, opts=opts,
        max_attempts=max_attempts, dtype=dtype, device=p.device)
