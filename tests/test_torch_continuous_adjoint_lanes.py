"""The batch-native continuous adjoint lane for lane against single-lane
runs, on the CPU (``tests/test_torch_continuous_adjoint.py`` has the
setting; a file of its own, so that the slow test runs at the end of the
suite's queue).
"""

import numpy as np
import torch

from test_torch_continuous_adjoint import (_port_lane, GRID, loss_of, OPTS, roberts_factory,
                                           ROBERTS_PARAMS, ROBERTS_YY0, S, TOL, TOUT)

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_batched_continuous_adjoint_is_lane_for_lane_the_single_lane():
    """The batch-native form (one forward and one backward solve for every
    lane; the KKT system [2N, 2N, B]) against single-lane runs."""
    params = np.outer([0.95, 1.0, 1.05], ROBERTS_PARAMS)
    loss, gp, gy0, istf, istb = S.batched_continuous_adjoint(
        roberts_factory, params, ROBERTS_YY0, params[:, :1] * np.array([-1.0, 1.0, 0.0]), TOL,
        TOUT, loss_of, grid=GRID, opts=OPTS, device="cpu")
    assert gp.shape == (3, 3) and gy0.shape == (3, 3)
    assert np.all(istf.numpy() == 0) and np.all(istb.numpy() == 0)
    for b in range(3):
        l1, g1, y1, f1, b1 = _port_lane(params[b])
        np.testing.assert_allclose(float(loss[b]), float(l1), rtol=1e-12)
        np.testing.assert_allclose(gp[b].numpy(), g1.numpy(), rtol=1e-9)
        np.testing.assert_allclose(gy0[b].numpy(), y1.numpy(), rtol=1e-9, atol=1e-15)
