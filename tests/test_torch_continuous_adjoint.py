"""The continuous adjoint (``ida_tpu_torch.sensitivity.continuous_adjoint``:
forward dense-output checkpoints, the adjoint DAE integrated from T down to
t0, gradients by backward quadratures) and the routing between the two
adjoints (``adjoint_gradient_auto``), against ``ida_tpu``.

Checked three ways: analytically (exponential decay,
tests/test_continuous_adjoint.py:29-40), against ``ida_tpu``'s
``continuous_adjoint`` on one Roberts lane (module-scoped, a 16-point
log-spaced grid to tout 0.4; held to rtol 1e-6, since the jitted JAX run
contracts multiply-adds), and the batch-native form lane by lane against
the single lane. The backward integration itself is held to
tests/test_direction.py's gate. The two slowest tests, the routing and the
batch-native form, are ``test_torch_continuous_adjoint_auto.py`` and
``_lanes.py``: files of one test queue last (pytest-xdist hands out the
files with the most tests first).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu.sensitivity as jsens
from ida_tpu.core.state import IdaOptions as JaxOptions
from ida_tpu.models import roberts_factory as jax_roberts_factory
from ida_tpu.tol_control import tol_sv as jax_tol_sv
from ida_tpu_torch import IDA, IdaSolveStatus
from ida_tpu_torch import sensitivity as S
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.problem import IdaProblem
from ida_tpu_torch.tol_control import tol_ss, tol_sv
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

RTOL = 1e-4
ATOL = [1e-8, 1e-6, 1e-6]
TOUT = 0.4
W = np.array([1.0, 2.0, 3.0])
GRID = np.logspace(-4, np.log10(TOUT), 16)
OPTS = IdaOptions(mxstep=20000)
TOL = tol_sv(RTOL, ATOL, device="cpu")
# what the pinned reference (jax_continuous_live) is computed from
REF_INPUTS = {"params": ROBERTS_PARAMS, "yy0": ROBERTS_YY0, "rtol": RTOL, "atol": ATOL,
              "tout": TOUT, "w": W, "grid": GRID, "mxstep": OPTS.mxstep}


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def loss_of(y):
    return (y * _t(W)).sum()


def _yp0(p):
    return _t(p)[:1] * _t([-1.0, 1.0, 0.0])


def _decay_factory(p):
    def res(t, y, yp):
        return yp + p * y

    return IdaProblem(n=1, res=res)


def test_backward_integration_as_ida_tpu_gates_it():
    """tests/test_direction.py:20-28 on the port: from t0 = 0 down to -2,
    negative steps throughout, y(-2) = y0 exp(2)."""

    def res(t, yy, yp):
        return yp + yy

    y0 = np.array([1.0, 2.0])
    ida = IDA(IdaProblem(n=2, res=res), y0, -y0, tol_ss(1e-8, 1e-10, device="cpu"),
              device="cpu")
    tret, status = ida.solve(-2.0)
    assert status == IdaSolveStatus.Success and tret == -2.0
    assert ida.get_last_step() < 0
    np.testing.assert_allclose(np.asarray(ida.get_yy()), y0 * np.exp(2.0), rtol=1e-5)


def test_exponential_decay_analytic():
    T = 2.0
    loss, gp, gy0, istf, istb = S.continuous_adjoint(
        _decay_factory, 0.7, _t([1.0]), _t([-0.7]), tol_ss(1e-10, 1e-12, device="cpu"), T,
        lambda y: y[0], device="cpu")
    assert int(istf) == 0 and int(istb) == 0
    ref = np.exp(-0.7 * T)
    np.testing.assert_allclose(float(loss), ref, rtol=1e-8)
    np.testing.assert_allclose(float(gp), -T * ref, rtol=1e-7)
    np.testing.assert_allclose(gy0.numpy(), [ref], rtol=1e-7)


@pytest.fixture(scope="module")
def jax_continuous():
    """:func:`jax_continuous_live`, pinned by tests/make_torch_refs.py."""
    return load("continuous_adjoint", REF_INPUTS)


def jax_continuous_live():
    """``ida_tpu``'s continuous adjoint of the nominal lane: (loss, the
    parameter gradient, the initial-value gradient, forward and backward
    istate)."""
    p0 = jnp.asarray(ROBERTS_PARAMS)
    out = jsens.continuous_adjoint(
        jax_roberts_factory, p0, jnp.asarray(ROBERTS_YY0), p0[:1] * jnp.asarray([-1.0, 1.0, 0.0]),
        jax_tol_sv(RTOL, jnp.asarray(ATOL)), TOUT, lambda y: jnp.sum(y * W),
        grid=jnp.asarray(GRID), opts=JaxOptions(mxstep=OPTS.mxstep))
    return [np.asarray(x) for x in out]


def _port_lane(p):
    return S.continuous_adjoint(roberts_factory, p, ROBERTS_YY0, _yp0(p), TOL, TOUT, loss_of,
                                grid=GRID, opts=OPTS, device="cpu")


def test_roberts_lane_matches_ida_tpu(jax_continuous):
    loss, gp, gy0, istf, istb = _port_lane(ROBERTS_PARAMS)
    jloss, jgp, jgy0, jistf, jistb = jax_continuous
    assert int(istf) == int(jistf) == 0 and int(istb) == int(jistb) == 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-10)
    np.testing.assert_allclose(gp.numpy(), jgp, rtol=1e-6)
    np.testing.assert_allclose(gy0.numpy(), jgy0, rtol=1e-6, atol=1e-12)
