"""Per-lane gradients of an ensemble in one batch-native solve
(``ida_tpu_torch.sensitivity.batched_adjoint_gradient``), against
``ida_tpu``'s vmapped adjoint and against the port's single-lane runs, and
Hessian-vector products (``adjoint_hvp``) against differences of
``ida_tpu``'s gradients and of the port's.

The JAX reference (module-scoped) is ``ida_tpu``'s
``batched_adjoint_gradient`` over six Roberts lanes to tout 0.4: four
spread lanes, and the nominal lane moved by +-eps along k1, whose central
difference is ``ida_tpu``'s Hessian-vector product to finite-difference
accuracy (``ida_tpu``'s own ``adjoint_hvp`` compiles for minutes on one
core, so its tests/test_second_order.py check, differences of the
gradient, stands in for it). The port is held to the reference at rtol
1e-6 (jitted JAX contracts multiply-adds, and differentiates its LU's
arithmetic where the port applies the implicit formula). Each lane of the
port's batch is held to its own single-lane run as
tests/test_ic_sensitivity.py:141-143 holds ``ida_tpu``'s: values to rtol
1e-10, gradients to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu.sensitivity as jsens
from ida_tpu.models import roberts_factory as jax_roberts_factory
from ida_tpu.tol_control import tol_sv as jax_tol_sv
from ida_tpu_torch import sensitivity as S
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.tol_control import tol_sv
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

RTOL = 1e-4
ATOL = [1e-8, 1e-6, 1e-6]
TOUT = 0.4
ATTEMPTS = 48
W = np.array([1.0, 2.0, 3.0])
SCALES = np.array([0.98, 1.0, 1.02, 1.05])
TOL = tol_sv(RTOL, ATOL, device="cpu")
# the Hessian-vector product's direction (k1, the O(1) parameter: the k2/k3
# rows are ~1e-10 and below what differences resolve) and step
# (tests/test_second_order.py)
V = np.array([1.0, 0.0, 0.0])
EPS = 4e-7 * ROBERTS_PARAMS[0]
FD_PARAMS = np.stack([ROBERTS_PARAMS + EPS * V, ROBERTS_PARAMS - EPS * V])
# what the pinned reference (jax_batched_live) is computed from
REF_INPUTS = {"params": ROBERTS_PARAMS, "scales": SCALES, "fd_params": FD_PARAMS,
              "yy0": ROBERTS_YY0, "rtol": RTOL, "atol": ATOL, "tout": TOUT,
              "max_attempts": ATTEMPTS, "w": W}


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def yy0_of(p):
    return _t(ROBERTS_YY0)


def yp0_of(p):
    return p[0] * _t([-1.0, 1.0, 0.0])


def loss_of(y):
    return (y * _t(W)).sum()


def _single(p):
    return S.adjoint_gradient(roberts_factory, p, yy0_of, yp0_of, TOL, TOUT, loss_of,
                              max_attempts=ATTEMPTS, device="cpu")


@pytest.fixture(scope="module")
def jax_batched():
    """:func:`jax_batched_live`, pinned by tests/make_torch_refs.py."""
    return load("adjoint_batched", REF_INPUTS)


def jax_batched_live():
    """``ida_tpu``'s lanes: the four SCALES lanes, then FD_PARAMS."""
    jtol = jax_tol_sv(RTOL, jnp.asarray(ATOL))
    params = np.concatenate([np.outer(SCALES, ROBERTS_PARAMS), FD_PARAMS])
    vals, grads, ist = jsens.batched_adjoint_gradient(
        jax_roberts_factory, jnp.asarray(params),
        lambda p: jnp.asarray(ROBERTS_YY0), lambda p: p[0] * jnp.asarray([-1.0, 1.0, 0.0]),
        jtol, TOUT, lambda y: jnp.sum(y * W), max_attempts=ATTEMPTS)
    return np.asarray(vals), np.asarray(grads), np.asarray(ist)


def test_batched_adjoint_matches_ida_tpu_and_single_lanes(jax_batched):
    params = np.outer(SCALES, ROBERTS_PARAMS)
    vals, grads, istates = S.batched_adjoint_gradient(
        roberts_factory, params, yy0_of, yp0_of, TOL, TOUT, loss_of, max_attempts=ATTEMPTS,
        device="cpu")
    assert vals.shape == (4,) and grads.shape == (4, 3) and istates.shape == (4,)
    assert np.all(istates.numpy() == 0) and np.all(jax_batched[2] == 0)
    np.testing.assert_allclose(vals.numpy(), jax_batched[0][:4], rtol=1e-12)
    np.testing.assert_allclose(grads.numpy(), jax_batched[1][:4], rtol=1e-6)
    for b in range(4):
        v1, g1, i1 = _single(params[b])
        assert int(i1) == 0
        np.testing.assert_allclose(float(vals[b]), float(v1), rtol=1e-10)
        np.testing.assert_allclose(grads[b].numpy(), g1.numpy(), rtol=1e-8)


def test_masked_lanes_give_finite_gradients_equal_to_their_single_runs():
    """A lane that is done after 11 steps rides along, masked, while the
    others take up to 43: without the safe_ad guards its discarded
    branches' inf partials turn the gradients into nan. Each lane's value
    and gradient are its single-lane run's."""
    params = np.outer([1e-4, 1.0, 10.0], ROBERTS_PARAMS)
    vals, grads, istates = S.batched_adjoint_gradient(
        roberts_factory, params, yy0_of, yp0_of, TOL, TOUT, loss_of, max_attempts=ATTEMPTS,
        device="cpu")
    assert np.all(istates.numpy() == 0)
    assert bool(torch.isfinite(grads).all())
    for b in range(3):
        v1, g1, i1 = _single(params[b])
        assert int(i1) == 0
        np.testing.assert_allclose(float(vals[b]), float(v1), rtol=1e-10)
        np.testing.assert_allclose(grads[b].numpy(), g1.numpy(), rtol=1e-8)


def test_batched_adjoint_with_per_lane_initial_values_and_ic():
    """Per-lane maps that use the lane's params, and ``ic`` through the
    batch-native consistent-IC Function: each lane is its single-lane run."""
    params = np.outer([0.9, 1.1], ROBERTS_PARAMS)

    def yy_bad(p):
        return torch.stack([1.0 + 0.0 * p[0], 0.0 * p[0], 0.3 + p[0]])

    def yp_bad(p):
        return 0.0 * p

    kw = dict(max_attempts=ATTEMPTS, ic=("ya_ydp", 0.4), device="cpu")
    vals, grads, istates = S.batched_adjoint_gradient(roberts_factory, params, yy_bad, yp_bad,
                                                      TOL, TOUT, loss_of, **kw)
    assert np.all(istates.numpy() == 0)
    for b in range(2):
        v1, g1, i1 = S.adjoint_gradient(roberts_factory, params[b], yy_bad, yp_bad, TOL, TOUT,
                                        loss_of, **kw)
        assert int(i1) == 0
        np.testing.assert_allclose(float(vals[b]), float(v1), rtol=1e-10)
        np.testing.assert_allclose(grads[b].numpy(), g1.numpy(), rtol=1e-8)


def test_hvp_matches_differences_of_ida_tpus_gradients_and_the_ports(jax_batched):
    """``adjoint_hvp`` (a backward through the adjoint's backward) along k1
    against the central difference of ``ida_tpu``'s gradients and of the
    port's, to tests/test_second_order.py's 5e-3; its first backward is
    the adjoint gradient itself (rtol 1e-12) and ``ida_tpu``'s (1e-6)."""
    grad, hvp, istate = S.adjoint_hvp(roberts_factory, ROBERTS_PARAMS, yy0_of, yp0_of, TOL, TOUT,
                                      loss_of, V, max_attempts=ATTEMPTS, device="cpu")
    assert int(istate) == 0 and bool(torch.isfinite(hvp).all())
    np.testing.assert_allclose(grad.numpy(), _single(ROBERTS_PARAMS)[1].numpy(), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), jax_batched[1][1], rtol=1e-6)  # SCALES[1] = 1.0
    jax_fd = (jax_batched[1][4] - jax_batched[1][5]) / (2 * EPS)
    _, g_fd, ist_fd = S.batched_adjoint_gradient(roberts_factory, FD_PARAMS, yy0_of, yp0_of, TOL,
                                                 TOUT, loss_of, max_attempts=ATTEMPTS,
                                                 device="cpu")
    assert np.all(ist_fd.numpy() == 0)
    port_fd = (g_fd[0] - g_fd[1]).numpy() / (2 * EPS)
    for fd in (jax_fd, port_fd):
        assert abs(float(hvp[0]) - fd[0]) / max(abs(fd[0]), 1e-10) < 5e-3, (hvp, fd)
