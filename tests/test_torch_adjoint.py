"""The discrete adjoint through the port's eager solve
(``ida_tpu_torch.sensitivity.adjoint_gradient``), against ``ida_tpu``.

One JAX reference, module-scoped: ``ida_tpu``'s ``adjoint_gradient`` on the
nominal Roberts lane to tout 0.4 (decade 1: 29 steps; 48 attempts), with
the step counts of its forward solve. The port's forward counters equal
those, and its gradient is held to rtol 1e-6 (the jitted JAX run contracts
multiply-adds, and ``ida_tpu`` differentiates its LU's arithmetic where the
port applies the implicit formula). The rest is checked on the port by
central differences, as ``ida_tpu``'s own tests/test_adjoint.py and
tests/test_ic_sensitivity.py do; the adjoint of an event time in
``test_torch_adjoint_event_time.py``, a file of one test, which queues last.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu.sensitivity as jsens
from ida_tpu.core.solve import solve as jax_core_solve
from ida_tpu.core.state import init_state as jax_init_state
from ida_tpu.models import roberts_factory as jax_roberts_factory
from ida_tpu.tol_control import tol_sv as jax_tol_sv
from ida_tpu_torch import constants as C
from ida_tpu_torch import sensitivity as S
from ida_tpu_torch.core.solve import solve as core_solve
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils.ad_mode import safe_ad
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

RTOL = 1e-4
ATOL = [1e-8, 1e-6, 1e-6]
TOUT = 0.4
ATTEMPTS = 48
W = np.array([1.0, 2.0, 3.0])
# what the pinned reference (jax_ref_live) is computed from
REF_INPUTS = {"params": ROBERTS_PARAMS, "yy0": ROBERTS_YY0, "rtol": RTOL, "atol": ATOL,
              "tout": TOUT, "max_attempts": ATTEMPTS, "w": W}


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


TOL = tol_sv(RTOL, ATOL, device="cpu")


def yy0_of(p):
    return _t(ROBERTS_YY0)


def yp0_of(p):
    return p[0] * _t([-1.0, 1.0, 0.0])


def loss_of(y):
    return (y * _t(W)).sum()


@pytest.fixture(scope="module")
def jax_ref():
    """:func:`jax_ref_live`, pinned by tests/make_torch_refs.py."""
    return load("adjoint", REF_INPUTS)


def jax_ref_live():
    """``ida_tpu``'s adjoint gradient of the nominal lane to 0.4, and the
    counters of its forward solve."""
    jtol = jax_tol_sv(RTOL, jnp.asarray(ATOL))
    p0 = jnp.asarray(ROBERTS_PARAMS)
    jyy0 = lambda p: jnp.asarray(ROBERTS_YY0)  # noqa: E731
    jyp0 = lambda p: p[0] * jnp.asarray([-1.0, 1.0, 0.0])  # noqa: E731
    val, grad, ist = jsens.adjoint_gradient(
        jax_roberts_factory, p0, jyy0, jyp0, jtol, TOUT, lambda y: jnp.sum(y * W),
        max_attempts=ATTEMPTS)
    prob = jax_roberts_factory(p0)
    st = jax_init_state(prob, jyy0(p0), jyp0(p0))
    st, _, _ = jax_core_solve(st, prob, jsens.IdaOptions(), jtol, jnp.asarray(TOUT), 0)
    return {"val": float(val), "grad": np.asarray(grad), "istate": int(ist),
            "nst": int(st.nst), "nre": int(st.nre)}


def _forward_counts(opts=IdaOptions()):
    p = _t(ROBERTS_PARAMS)
    prob = roberts_factory(p)
    st = init_state(prob, yy0_of(p), yp0_of(p), device="cpu", opts=opts)
    st, _, _ = core_solve(st, prob, opts, TOL, TOUT)
    return int(st.nst), int(st.nre)


def test_cpu_reproduction_now_returns_ida_tpus_gradient(jax_ref):
    """The reproduction of the repaired fault (params.requires_grad_(),
    ``init_state(..., device="cpu")``, ``core.solve.solve`` to 0.4), under
    safe_ad, returns ``ida_tpu``'s adjoint gradient."""
    p = _t(ROBERTS_PARAMS).requires_grad_()
    with safe_ad():
        prob = roberts_factory(p)
        st = init_state(prob, yy0_of(p), yp0_of(p), device="cpu")
        st, _, istate = core_solve(st, prob, IdaOptions(), TOL, TOUT)
        (g,) = torch.autograd.grad(loss_of(st.yy), p)
    assert int(istate) == 0 == jax_ref["istate"]
    assert _forward_counts() == (jax_ref["nst"], jax_ref["nre"]) == (29, jax_ref["nre"])
    np.testing.assert_allclose(g.numpy(), jax_ref["grad"], rtol=1e-6)


def test_adjoint_gradient_matches_ida_tpu_and_differences(jax_ref):
    val, grad, istate = S.adjoint_gradient(roberts_factory, ROBERTS_PARAMS, yy0_of, yp0_of, TOL,
                                           TOUT, loss_of, max_attempts=ATTEMPTS, device="cpu")
    assert int(istate) == 0
    assert _forward_counts(IdaOptions(unroll_newton=True)) == (jax_ref["nst"], jax_ref["nre"])
    np.testing.assert_allclose(float(val), jax_ref["val"], rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), jax_ref["grad"], rtol=1e-6)
    # central differences of the same (unrolled-Newton) primal
    # (tests/test_adjoint.py:44-50)
    opts = IdaOptions(unroll_newton=True)
    f = S.solve_with_params(roberts_factory, None, yy0_of, yp0_of, TOL, TOUT, opts)
    p0 = _t(ROBERTS_PARAMS)
    for i in range(3):
        v = torch.zeros(3, dtype=torch.float64)
        v[i] = 1.0
        eps = 1e-6 * float(p0[i])
        fd = float(loss_of(f(p0 + eps * v)) - loss_of(f(p0 - eps * v))) / (2 * eps)
        assert abs(float(grad[i]) - fd) / max(abs(fd), 1e-12) < 5e-4, (i, grad[i], fd)


def test_conserved_loss_has_zero_gradient():
    """sum(y) is conserved exactly (the algebraic equation), so its
    gradient in k1 vanishes to solver accuracy (tests/test_adjoint.py:54)."""
    val, grad, istate = S.adjoint_gradient(roberts_factory, ROBERTS_PARAMS, yy0_of, yp0_of, TOL,
                                           TOUT, lambda y: y.sum(), max_attempts=ATTEMPTS,
                                           device="cpu")
    assert int(istate) == 0
    assert abs(float(val) - 1.0) < 1e-10
    assert abs(float(grad[0])) < 1e-8


def test_remat_attempts_gives_the_same_gradient():
    """``IdaOptions(remat_attempts=True)`` recomputes every attempt in the
    backward pass: the same arithmetic (rtol 1e-12, tests/test_adjoint.py:90)."""
    kw = dict(max_attempts=ATTEMPTS, device="cpu")
    v0, g0, i0 = S.adjoint_gradient(roberts_factory, ROBERTS_PARAMS, yy0_of, yp0_of, TOL, TOUT,
                                    loss_of, **kw)
    vr, gr, ir = S.adjoint_gradient(roberts_factory, ROBERTS_PARAMS, yy0_of, yp0_of, TOL, TOUT,
                                    loss_of, opts=IdaOptions(remat_attempts=True), **kw)
    assert int(i0) == 0 and int(ir) == 0
    assert float(v0) == float(vr)
    np.testing.assert_allclose(gr.numpy(), g0.numpy(), rtol=1e-12)


def test_adjoint_through_calc_ic_matches_differences():
    """``ic=("ya_ydp", 0.4)``: the gradient through the IC solve and the
    integration, against central differences of the whole primal
    (tests/test_ic_sensitivity.py:75-110)."""
    yy_bad, yp_bad = _t([1.0, 0.0, 0.3]), _t([0.0, 0.0, 0.0])
    val, grad, istate = S.adjoint_gradient(
        roberts_factory, ROBERTS_PARAMS, lambda p: yy_bad, lambda p: yp_bad, TOL, TOUT, loss_of,
        max_attempts=ATTEMPTS, ic=("ya_ydp", 0.4), device="cpu")
    assert int(istate) == 0 and bool(torch.isfinite(grad).all())

    opts = IdaOptions(unroll_newton=True)
    cic = S.make_consistent_ic(roberts_factory, "ya_ydp", 0.4, TOL, opts=opts)

    def primal(p):
        yyc, ypc, ok = cic(p, yy_bad, yp_bad)
        prob = roberts_factory(p)
        st = init_state(prob, yyc, ypc, device="cpu", opts=opts)
        st, _, _, _ = core_solve(st, prob, opts, TOL, TOUT, max_attempts=ATTEMPTS)
        return float(loss_of(st.yy))

    p0 = _t(ROBERTS_PARAMS)
    for i in range(3):
        v = torch.zeros(3, dtype=torch.float64)
        v[i] = 1.0
        eps = 1e-6 * float(p0[i])
        fd = (primal(p0 + eps * v) - primal(p0 - eps * v)) / (2 * eps)
        assert abs(float(grad[i]) - fd) / max(abs(fd), 1e-12) < 5e-4, (i, grad[i], fd)
