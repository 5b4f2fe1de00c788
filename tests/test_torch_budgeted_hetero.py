"""Heterogeneous lanes under an attempt budget against ``ida_tpu``'s
jitted run, on the CPU (``tests/test_torch_budgeted_solve.py`` has the
setting; a file of its own, so that the slow test runs at the end of the
suite's queue).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_budgeted_solve import (_hetero_inputs, _hetero_port, _jax_budgeted, ATOL, COUNTERS,
                                       jensemble_init, JOptions, jroberts, jsolve, jtol_sv)

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hetero_jitted():
    """The JAX vmapped budgeted solve, budget 5, tout 0.4 (as
    tests/test_budgeted_solve.py::test_budgeted_resume_vmapped_heterogeneous)."""
    params, yy0, yp0 = (jnp.asarray(a) for a in _hetero_inputs())
    states = jensemble_init(jroberts, params, yy0, yp0)
    tol = jtol_sv(1e-4, jnp.asarray(ATOL))
    tout = jnp.asarray(0.4)

    def first(s, p):
        return jsolve(s, jroberts(p), JOptions(), tol, tout, max_attempts=5)

    def again(s, p, carry):
        return jsolve(s, jroberts(p), JOptions(), tol, tout, max_attempts=5, resume_carry=carry)

    f, a = jax.jit(jax.vmap(first)), jax.jit(jax.vmap(again))
    return _jax_budgeted(lambda s: f(s, params), lambda s, c: a(s, params, c), states)


def test_heterogeneous_lanes_budget_matches_jitted_reference(hetero_jitted):
    jst, jtret, jist, jcalls = hetero_jitted
    st, tret, ist, calls = _hetero_port(5)
    assert calls == jcalls > 1
    np.testing.assert_array_equal(ist.numpy(), np.asarray(jist))
    np.testing.assert_allclose(tret.numpy(), np.asarray(jtret), rtol=1e-13, atol=0)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)
