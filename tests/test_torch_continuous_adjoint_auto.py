"""The continuous adjoint's automatic routing against ``ida_tpu``'s, on the CPU
(``tests/test_torch_continuous_adjoint.py`` has the setting; a file of
its own, so that the slow test runs at the end of the suite's queue).
"""

from functools import partial

import numpy as np
import pytest
import torch

from test_torch_continuous_adjoint import (_t, _yp0, GRID, jax_continuous, loss_of, OPTS,
                                           roberts_factory, ROBERTS_PARAMS, ROBERTS_YY0, S, TOL,
                                           TOUT)  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_adjoint_gradient_auto_routes_as_ida_tpu(jax_continuous):
    """Forced continuous (crossover 0) is ``continuous_adjoint``, forced
    discrete is ``adjoint_gradient``; the default window picks continuous
    at 120 attempts; a problem with roots always takes the discrete tape
    (tests/test_adjoint.py:166-220)."""
    args = (roberts_factory, ROBERTS_PARAMS, ROBERTS_YY0, _yp0(ROBERTS_PARAMS), TOL, TOUT, loss_of)
    lc, gc, ic_ = S.adjoint_gradient_auto(*args, max_attempts=120, crossover=0, grid=GRID,
                                          opts=OPTS, device="cpu")
    ld, gd, id_ = S.adjoint_gradient_auto(*args, max_attempts=120, crossover=10**9,
                                          device="cpu")
    assert int(ic_) == 0 and int(id_) == 0
    np.testing.assert_allclose(gc.numpy(), jax_continuous[1], rtol=1e-6)
    _, g_disc, _ = S.adjoint_gradient(roberts_factory, ROBERTS_PARAMS,
                                      lambda p: _t(ROBERTS_YY0), lambda p: _yp0(ROBERTS_PARAMS),
                                      TOL, TOUT, loss_of, max_attempts=120, device="cpu")
    assert torch.equal(gd, g_disc)
    np.testing.assert_allclose(float(lc), float(ld), rtol=5e-4)
    np.testing.assert_allclose(gc.numpy(), gd.numpy(), rtol=2e-2)
    la, ga, ia = S.adjoint_gradient_auto(*args, max_attempts=120, grid=GRID, opts=OPTS,
                                         device="cpu")
    assert int(ia) == 0 and torch.equal(ga, gc)

    rooted = partial(roberts_factory, with_roots=True)
    lr, gr, ir = S.adjoint_gradient_auto(rooted, *args[1:], max_attempts=120, crossover=0,
                                         device="cpu")
    assert int(ir) == 2  # ROOT_RETURN: the discrete tape ran (continuous refuses roots)
    with pytest.raises(ValueError, match="rootfinding"):
        S.continuous_adjoint(rooted, *args[1:], device="cpu")
