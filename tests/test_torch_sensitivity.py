"""Derivatives through the port's eager solve, against ``ida_tpu``: the safe-AD
helpers, the differentiable ``sqrt_``/``pow_`` and LU, forward sensitivities
and the consistent-IC Function.

The JAX side is small (Roberts to tout 0.4, one lane) and jitted, so its
last bits may differ from the port's (XLA:CPU contracts multiply-adds; the
port's LU derivative is the implicit formula, ``ida_tpu``'s the jnp
arithmetic of its solve differentiated): derivatives are held to rtol 1e-6
on runs whose step counts equal, primal values where stated bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import ida_tpu.sensitivity as jsens
from ida_tpu.models import roberts_factory as jax_roberts_factory
from ida_tpu.ops import dense_lu as jax_dense_lu
from ida_tpu.problem import IdaProblem as JaxProblem
from ida_tpu.tol_control import tol_sv as jax_tol_sv
from ida_tpu.utils import ad_mode as jax_ad_mode
from ida_tpu_torch import sensitivity as S
from ida_tpu_torch.core.solve import solve as core_solve
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.ops import dense_lu, make_fused_solve
from ida_tpu_torch.parallel import ensemble_init
from ida_tpu_torch.problem import IdaProblem
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils import ad_mode
from ida_tpu_torch.utils.numerics import pow_, sqrt_
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

ATOL = [1e-8, 1e-6, 1e-6]
TOUT = 0.4  # decade 1 of the canonical run: 29 steps
W = [1.0, 2.0, 3.0]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


# ------------------------------------------------------------ ad_mode


@pytest.mark.parametrize("inside", [False, True], ids=["outside", "inside"])
def test_ad_mode_helpers_match_ida_tpu(inside):
    rng = np.random.default_rng(11)
    x = np.concatenate([[0.0, -1.0, 2.0, -0.0], rng.normal(size=12)])
    base = np.abs(x)
    port_ctx = ad_mode.safe_ad() if inside else _null()
    jax_ctx = jax_ad_mode.safe_ad() if inside else _null()
    with port_ctx, jax_ctx:
        assert ad_mode.is_safe_ad() is inside and jax_ad_mode.is_safe_ad() is inside
        got = {
            "smask_den": ad_mode.smask_den(_t(x)).numpy(),
            "smask_pos": ad_mode.smask_pos(_t(x)).numpy(),
            "ssqrt": ad_mode.ssqrt(_t(base)).numpy(),
            "spow": ad_mode.spow(_t(base), _t(-0.5)).numpy(),
        }
        want = {
            "smask_den": jax_ad_mode.smask_den(jnp.asarray(x)),
            "smask_pos": jax_ad_mode.smask_pos(jnp.asarray(x)),
            "ssqrt": jax_ad_mode.ssqrt(jnp.asarray(base)),
            "spow": jax_ad_mode.spow(jnp.asarray(base), -0.5),
        }
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    if not inside:
        t = _t(x)
        assert ad_mode.smask_den(t) is t and ad_mode.smask_pos(t) is t


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_safe_ad_gradient_is_finite_where_the_plain_one_is_not():
    """The double-where trick: d ssqrt(x)/dx and d spow(x, -1/2)/dx at x = 0
    are 0 under safe_ad, inf/nan outside; the primal is the same."""
    x = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    with ad_mode.safe_ad():
        (g,) = torch.autograd.grad(ad_mode.ssqrt(x).sum() + ad_mode.spow(x, -0.5).sum(), x)
    assert torch.equal(g, torch.zeros(2, dtype=torch.float64))
    (g,) = torch.autograd.grad(ad_mode.ssqrt(x).sum(), x)
    assert not bool(torch.isfinite(g).all())


# ------------------------------------------------ sqrt_ and pow_ (repair)


def _ulps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b))))


def test_sqrt_and_pow_keep_their_bits_and_differentiate_like_torch():
    rng = np.random.default_rng(5)
    xs = rng.uniform(1e-3, 1e3, 200)
    es = rng.uniform(-2.0, 2.0, 200)
    x = _t(xs).requires_grad_()
    e = _t(es).requires_grad_()

    # primal bits: numpy's sqrt, the C library's pow
    np.testing.assert_array_equal(sqrt_(x).detach().numpy(), np.sqrt(xs))
    np.testing.assert_array_equal(pow_(x, e).detach().numpy(),
                                  np.array([math.pow(a, b) for a, b in zip(xs, es)]))

    for ours, ref, args in [(sqrt_, torch.sqrt, (x,)), (pow_, torch.pow, (x, e))]:
        g = torch.autograd.grad(ours(*args).sum(), args, create_graph=True)
        g_ref = torch.autograd.grad(ref(*args).sum(), args, create_graph=True)
        for a, b in zip(g, g_ref):
            assert _ulps(a.detach(), b.detach()) <= 1.0
        # double backward (the Hessian-vector product needs it); torch's own
        # second derivative is another formula, so a few ulps apart
        h = torch.autograd.grad(g[0].sum(), args[0])[0]
        h_ref = torch.autograd.grad(g_ref[0].sum(), args[0])[0]
        np.testing.assert_allclose(h.numpy(), h_ref.numpy(), rtol=1e-14)
        # forward mode: a unit tangent gives the partials themselves (to 1
        # ulp); a general one rounds once more (t * (0.5 / y) against
        # torch's t / (2 y)), so to 2
        for tangent, ulps in ((torch.ones(200, dtype=torch.float64), 1.0),
                              (_t(rng.normal(size=200)), 2.0)):
            with forward_ad.dual_level():
                duals = [forward_ad.make_dual(a.detach(), tangent) for a in args]
                t = forward_ad.unpack_dual(ours(*duals)).tangent
                t_ref = forward_ad.unpack_dual(ref(*duals)).tangent
            assert _ulps(t, t_ref) <= ulps


def _reproduction():
    p = _t(ROBERTS_PARAMS).requires_grad_()
    prob = roberts_factory(p)
    st = init_state(prob, _t(ROBERTS_YY0), p[0] * _t([-1.0, 1.0, 0.0]), device="cpu")
    st, _, istate = core_solve(st, prob, IdaOptions(), tol_sv(1e-4, ATOL, device="cpu"), TOUT)
    (g,) = torch.autograd.grad((st.yy * _t(W)).sum(), p)
    return g, istate


def test_cpu_solve_under_autograd_no_longer_raises():
    """The reproduction: a Roberts lane with ``params.requires_grad_()`` on
    the CPU raised in ``sqrt_`` (``x.numpy()``) before the repair. Now it
    returns a gradient; outside safe_ad the discarded branches' inf
    partials make it nan (``ida_tpu``'s jax.grad does the same), under it
    the gradient is finite (held against ``ida_tpu`` in
    tests/test_torch_adjoint.py)."""
    g, istate = _reproduction()
    assert int(istate) == 0 and g.shape == (3,)
    with ad_mode.safe_ad():
        g, istate = _reproduction()
    assert int(istate) == 0 and bool(torch.isfinite(g).all()) and float(g[0]) > 0.0


# ------------------------------------------------------- LU Functions


def _lu_system(n, bsz=5, seed=0):
    rng = np.random.default_rng(seed + n)
    a = _t(rng.normal(size=(n, n, bsz)) + 3.0 * np.eye(n)[:, :, None]).requires_grad_()
    b = _t(rng.normal(size=(n, bsz))).requires_grad_()
    return a, b


@pytest.mark.parametrize("n", [2, 3, 6])
def test_plain_transposed_solve_matches_jax_vjp_of_the_solve(n):
    """No TPU kernel has a backward: ``ida_tpu`` differentiates the jnp
    arithmetic of ``lu_solve_unrolled``. Its vjp in b, per lane, against
    the port's ``lu_solve_unrolled_t`` from the same factors."""
    rng = np.random.default_rng(30 + n)
    a = rng.normal(size=(n, n, 4)) + 2.0 * np.eye(n)[:, :, None]
    g = rng.normal(size=(n, 4))
    f = dense_lu.lu_factor_unrolled(_t(a))
    lam = dense_lu.lu_solve_unrolled_t(f, _t(g)).numpy()
    for lane in range(4):
        jf = jax_dense_lu.lu_factor_unrolled(jnp.asarray(a[:, :, lane]))
        _, pull = jax.vjp(lambda b: jax_dense_lu.lu_solve_unrolled(jf, b), jnp.zeros(n))
        np.testing.assert_allclose(lam[:, lane], np.asarray(pull(jnp.asarray(g[:, lane]))[0]),
                                   rtol=1e-13, atol=1e-15)


def test_safe_ad_reads_a_zero_pivot_as_one():
    """A never-factored (all-zero) lane: without the guard its cotangent is
    nan; under safe_ad it is finite, and the other lanes are untouched."""
    a, b = _lu_system(3, bsz=3)
    a0 = a.detach().clone()
    a0[:, :, 1] = 0.0
    a0.requires_grad_()
    g = _t(np.array([[1.0, 0.0, 1.0]] * 3))  # lane 1's cotangent is 0

    def grads():
        x = dense_lu.lu_solve_auto(dense_lu.lu_factor_auto(a0), b)
        return torch.autograd.grad(x, (a0, b), grad_outputs=g)

    plain = grads()
    with ad_mode.safe_ad():
        guarded = grads()
    assert not bool(torch.isfinite(plain[1][:, 1]).all())
    assert all(bool(torch.isfinite(t).all()) for t in guarded)
    for p_, g_ in zip(plain, guarded):
        assert torch.equal(p_[..., 0], g_[..., 0]) and torch.equal(p_[..., 2], g_[..., 2])


# ------------------------------------------- the fused kernel refuses


def test_make_fused_solve_refuses_inputs_that_carry_a_derivative():
    """K2-K5 are forward-only (as the TPU kernels): the entry raises, on the
    CPU route too, naming the way to a gradient, and never detaches."""
    params = np.outer([0.9, 1.1], ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (2, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    states = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu")
    fn = make_fused_solve(roberts_factory, tol_sv(1e-4, ATOL, device="cpu"))
    p = _t(params).requires_grad_()
    with pytest.raises(ValueError, match="adjoint_gradient"):
        fn(states, p, TOUT)
    st_grad = states._replace(yy=states.yy.clone().requires_grad_())
    with pytest.raises(ValueError, match="state.yy"):
        fn(st_grad, params, TOUT)
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(_t(params), torch.ones(2, 3, dtype=torch.float64))
        with pytest.raises(ValueError, match="forward-only"):
            fn(states, dual, TOUT)
    # without derivatives it still solves
    _, tret, istate = fn(states, params, TOUT)
    assert bool((istate == 0).all())


# ------------------------------------------------- safe_ad, unrolled loops


def _solve_fields(opts, factory=roberts_factory, tout=4.0e4):
    p = _t(ROBERTS_PARAMS)
    prob = factory(p)
    st = init_state(prob, _t(ROBERTS_YY0), p[0] * _t([-1.0, 1.0, 0.0]), device="cpu", opts=opts)
    st, tret, istate, _ = core_solve(st, prob, opts, tol_sv(1e-4, ATOL, device="cpu"), tout,
                                     max_attempts=200)
    return st, tret, istate


def _same_state(a, b):
    for f, x, y in zip(a[0]._fields, a[0], b[0]):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


# ------------------------------------------------- forward sensitivities


def _jax_setup():
    tol = jax_tol_sv(1e-4, jnp.asarray(ATOL))
    return tol, (lambda p: jnp.asarray(ROBERTS_YY0)), (lambda p: p[0] * jnp.asarray([-1.0, 1.0, 0.0]))


def _port_setup():
    tol = tol_sv(1e-4, ATOL, device="cpu")
    return tol, (lambda p: _t(ROBERTS_YY0)), (lambda p: p[0] * _t([-1.0, 1.0, 0.0]))


FWD_V = np.array([1.0, 0.0, 0.0])


def _jax_forward():
    """``ida_tpu``'s forward sensitivity along FWD_V (jitted, ~20 s)."""
    jtol, jyy0, jyp0 = _jax_setup()
    jy, jdy = jsens.forward_sensitivity(jax_roberts_factory, jnp.asarray(ROBERTS_PARAMS), jyy0,
                                        jyp0, jtol, TOUT, jnp.asarray(FWD_V))
    return {"y": np.asarray(jy), "dy": np.asarray(jdy)}


def _jax_consistent_ic(icopt):
    """``ida_tpu``'s consistent-IC Function on CIC_CASES[icopt]: values, the
    gradient of the loss on both outputs and the tangent along the seeded
    directions (:func:`_cic_dirs`)."""
    yy0, yp0 = (np.array(x) for x in CIC_CASES[icopt])
    jtol = _jax_setup()[0]
    w = np.array(W)
    jcic = jsens.make_consistent_ic(jax_roberts_factory, icopt, 0.4, jtol)

    def jloss(p, a, b):
        yyc, ypc, _ = jcic(p, a, b)
        return jnp.sum(yyc * w) + jnp.sum(ypc * w[::-1])

    jargs = (jnp.asarray(ROBERTS_PARAMS), jnp.asarray(yy0), jnp.asarray(yp0))
    jyyc, jypc, jok = jcic(*jargs)
    jgrad = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    _, jtan = jax.jvp(lambda *a: jcic(*a)[:2], jargs, tuple(jnp.asarray(d) for d in _cic_dirs()))
    return {"yyc": np.asarray(jyyc), "ypc": np.asarray(jypc), "ok": float(jok),
            "grad": [np.asarray(g) for g in jgrad], "tan": [np.asarray(t) for t in jtan]}


def _cic_dirs():
    rng = np.random.default_rng(7)
    return [rng.normal(size=3) * ROBERTS_PARAMS * 1e-2, rng.normal(size=3), rng.normal(size=3)]


CIC_CASES = {
    "ya_ydp": ([1.0, 0.0, 0.3], [0.0, 0.0, 0.0]),
    "y": ([1.0, 1e-5, 0.05], [-0.05, 0.04, 0.0]),
}
# what the pinned JAX runs (jax_sensitivity_live) are computed from
REF_INPUTS = {"params": ROBERTS_PARAMS, "yy0": ROBERTS_YY0, "atol": ATOL, "tout": TOUT,
              "tangent": FWD_V, "cic_cases": CIC_CASES, "w": W, "cic_dirs": _cic_dirs()}


def jax_sensitivity_live():
    return {"forward": _jax_forward(),
            "consistent_ic": {icopt: _jax_consistent_ic(icopt) for icopt in CIC_CASES}}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX runs, pinned (tests/make_torch_refs.py, ``sensitivity_jax``)."""
    return load("sensitivity_jax", REF_INPUTS)


def test_forward_sensitivity_matches_ida_tpu_and_differences(jax_refs):
    v = FWD_V
    tol, yy0_of, yp0_of = _port_setup()
    y, dy = S.forward_sensitivity(roberts_factory, ROBERTS_PARAMS, yy0_of, yp0_of, tol, TOUT, v,
                                  device="cpu")
    np.testing.assert_allclose(y.numpy(), jax_refs["forward"]["y"], rtol=1e-10)
    np.testing.assert_allclose(dy.numpy(), jax_refs["forward"]["dy"], rtol=1e-6)
    # central differences of the port (tests/test_sensitivity.py:20-32)
    f = S.solve_with_params(roberts_factory, None, yy0_of, yp0_of, tol, TOUT)
    eps = 1e-7
    p0 = _t(ROBERTS_PARAMS)
    fd = (f(p0 + eps * _t(v)) - f(p0 - eps * _t(v))) / (2 * eps)
    np.testing.assert_allclose(dy.numpy(), fd.numpy(), rtol=1e-5)
    assert abs(float(dy.sum())) < 1e-6 * float(dy.abs().max())


# ------------------------------------------------- consistent ICs


@pytest.mark.parametrize("icopt", ["ya_ydp", "y"])
def test_make_consistent_ic_matches_ida_tpu(icopt, jax_refs):
    """Values, the gradient of a loss on both outputs in (p, yy0, yp0), and
    the tangent along a seeded direction, against ``ida_tpu``'s Function
    (jax.grad through its custom_jvp) on the same inputs (pinned)."""
    yy0, yp0 = (np.array(x) for x in CIC_CASES[icopt])
    w = np.array(W)
    dirs = _cic_dirs()
    ref = jax_refs["consistent_ic"][icopt]
    jyyc, jypc, jok, jgrad, jtan = ref["yyc"], ref["ypc"], ref["ok"], ref["grad"], ref["tan"]

    cic = S.make_consistent_ic(roberts_factory, icopt, 0.4, tol_sv(1e-4, ATOL, device="cpu"))
    args = tuple(_t(x).requires_grad_() for x in (ROBERTS_PARAMS, yy0, yp0))
    yyc, ypc, ok = cic(*args)
    loss = (yyc * _t(w)).sum() + (ypc * _t(w[::-1].copy())).sum()
    grad = torch.autograd.grad(loss, args)
    assert float(ok) == float(jok) == 1.0
    np.testing.assert_allclose(yyc.detach().numpy(), np.asarray(jyyc), rtol=1e-10, atol=1e-15)
    np.testing.assert_allclose(ypc.detach().numpy(), np.asarray(jypc), rtol=1e-10, atol=1e-15)
    for g, jg in zip(grad, jgrad):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-12)
    with forward_ad.dual_level():
        duals = [forward_ad.make_dual(a.detach(), _t(d)) for a, d in zip(args, dirs)]
        out = cic(*duals)
        tans = [forward_ad.unpack_dual(o).tangent for o in out[:2]]
    for t, jt in zip(tans, jtan):
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-12)


N20 = 20


def _chain_port(p):
    """A 20-unknown DAE (19 differential links of a decay chain, one
    algebraic sum), past the kernel's N = 16: the looped LU."""

    def res(t, yy, yp):
        rows = [yp[0] + p[0] * yy[0]]
        for i in range(1, N20 - 1):
            rows.append(yp[i] + p[0] * yy[i] - p[1] * yy[i - 1])
        rows.append(yy[N20 - 1] - p[2] * sum(yy[i] for i in range(N20 - 1)))
        return torch.stack(rows)

    return IdaProblem(n=N20, res=res, id=torch.tensor([True] * (N20 - 1) + [False]))


def _chain_jax(p):
    def res(t, yy, yp):
        rows = [yp[0] + p[0] * yy[0]]
        for i in range(1, N20 - 1):
            rows.append(yp[i] + p[0] * yy[i] - p[1] * yy[i - 1])
        rows.append(yy[N20 - 1] - p[2] * sum(yy[i] for i in range(N20 - 1)))
        return jnp.stack(rows)

    return JaxProblem(n=N20, res=res, id=jnp.asarray([1.0] * (N20 - 1) + [0.0]))
