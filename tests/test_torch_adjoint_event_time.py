"""The adjoint of an event time, on the CPU (``tests/test_torch_adjoint.py``
has the setting; a file of its own, so that the slow test runs at the end
of the suite's queue).
"""

from functools import partial

import torch

from test_torch_adjoint import (_t, C, core_solve, IdaOptions, init_state, roberts_factory,
                                ROBERTS_PARAMS, S, TOL, yp0_of, yy0_of)

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_adjoint_of_an_event_time():
    """The gradient of a ROOT_RETURN time through the fixed-trip Illinois
    loop and the interpolation to tlo (tests/test_adjoint.py:96-134)."""
    factory = partial(roberts_factory, with_roots=True)
    val, grad, istate = S.adjoint_gradient(
        factory, ROBERTS_PARAMS, yy0_of, yp0_of, TOL, 4.0, None, max_attempts=120,
        loss_of_state=lambda st, tret, prob: tret, device="cpu")
    assert int(istate) == C.ROOT_RETURN
    assert float(grad[0]) < 0.0  # faster decay, earlier crossing

    opts = IdaOptions(unroll_newton=True)

    def troot(p):
        prob = factory(p)
        st = init_state(prob, yy0_of(p), yp0_of(p), device="cpu", opts=opts)
        return float(core_solve(st, prob, opts, TOL, 4.0, max_attempts=120)[1])

    p0 = _t(ROBERTS_PARAMS)
    for i in range(3):
        v = torch.zeros(3, dtype=torch.float64)
        v[i] = 1.0
        eps = 1e-6 * float(p0[i])
        fd = (troot(p0 + eps * v) - troot(p0 - eps * v)) / (2 * eps)
        assert abs(float(grad[i]) - fd) / max(abs(fd), 1e-12) < 1e-3, (i, grad[i], fd)
