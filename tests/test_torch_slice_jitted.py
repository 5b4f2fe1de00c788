"""The port's ensemble solve against ``ida_tpu``'s jitted solves, on the
CPU (``tests/test_torch_slice.py`` has the setting; a file of few
tests, so that the jitted references queue after the suite's files with
the most tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import (_assert_exact, _inputs, _jax_native, _port_solve, B, IdaOptions,
                              JOptions, jsolve, params_from_numpy, state_from_numpy, TASK_NORMAL,
                              TASK_ONE_STEP, tol_from_numpy, troberts, tsolve)

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_native():
    return _jax_native()


@pytest.fixture(scope="module")
def jax_normal_solve(jax_native):
    """The jitted TASK_NORMAL solve, compiled once for the module's tests."""
    _, prob, tol = jax_native
    return jax.jit(lambda s, t: jsolve(s, prob, JOptions(), tol, t, TASK_NORMAL))


@pytest.mark.parametrize("tout", [0.4, 400.0])
def test_ensemble_counters_match_jitted_reference(jax_native, jax_normal_solve, tout):
    st, prob, tol = jax_native
    ref = jax_normal_solve(st, jnp.full((B,), tout))
    _assert_exact(ref, _port_solve(tout))


def test_one_step_task_matches_jitted_reference(jax_native):
    # ONE_STEP returns tret = tn, which carries the jitted run's FMA rounding
    st, prob, tol = jax_native
    one = jax.jit(lambda s: jsolve(s, prob, JOptions(), tol, jnp.full((B,), 400.0), TASK_ONE_STEP))
    for _ in range(5):
        st, tret, ist = one(st)
    _assert_exact((st, tret, ist), _port_solve(400.0, itask=TASK_ONE_STEP, steps=5), tret_rtol=1e-13)


def test_core_solve_on_inputs_converted_from_jax(jax_native, jax_normal_solve):
    # the JAX package's own batch-native state, params and tolerances,
    # carried over field by field, through the port's core solve
    st, prob, tol = jax_native
    ref = jax_normal_solve(st, jnp.full((B,), 4.0))
    params, _, _ = _inputs(B)
    got = tsolve(
        state_from_numpy({f: np.asarray(getattr(st, f)) for f in st._fields}, device="cpu", batch="trailing"),
        troberts(params_from_numpy(params, device="cpu", batch="leading")),
        IdaOptions(),
        tol_from_numpy({f: np.asarray(getattr(tol, f)) for f in tol._fields}, device="cpu", batch="trailing"),
        4.0,
    )
    assert got[0].phi.shape == st.phi.shape
    _assert_exact(ref, got)
