"""Robertson chemical kinetics: the canonical stiff 3-equation DAE.

Port of ``ida_tpu/models/roberts.py`` (reference
``src/sample_problems/roberts.rs:36-114``, SUNDIALS ``idaRoberts_dns``):

    dy1/dt = -.04*y1 + 1e4*y2*y3
    dy2/dt =  .04*y1 - 1e4*y2*y3 - 3e7*y2^2
    0      =  y1 + y2 + y3 - 1

on t in [0, 4e10], y0 = [1, 0, 0].
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import IdaProblem

ROBERTS_YY0 = np.array([1.0, 0.0, 0.0])
ROBERTS_YP0 = np.array([-0.04, 0.04, 0.0])
ROBERTS_PARAMS = np.array([0.04, 1.0e4, 3.0e7])


def roberts_factory(params: torch.Tensor) -> IdaProblem:
    """Parameterized Roberts for ensemble sweeps: ``params = [k1, k2, k3]``
    (nominal ``ROBERTS_PARAMS``), batch-last: [3] for one lane, [3, B] for
    a batch-native ensemble. The residual and the analytic Jacobian close
    over the params, so each lane integrates its own chemistry."""
    k1, k2, k3 = params[0], params[1], params[2]

    def res(t, yy, yp):
        # (reference src/sample_problems/roberts.rs:47-62)
        r0 = -k1 * yy[0] + k2 * yy[1] * yy[2]
        r1 = -r0 - k3 * yy[1] * yy[1] - yp[1]
        return torch.stack([r0 - yp[0], r1, yy[0] + yy[1] + yy[2] - 1.0])

    def jac(t, cj, yy, yp, rr):
        # analytic J = dF/dy + cj*dF/dy' (reference roberts.rs:66-91)
        row0 = torch.stack([-k1 - cj, k2 * yy[2], k2 * yy[1]])
        row1 = torch.stack([k1, -k2 * yy[2] - 2.0 * k3 * yy[1] - cj, -k2 * yy[1]])
        row2 = torch.ones_like(yy)
        return torch.stack([row0, row1, row2])

    return IdaProblem(
        n=3,
        res=res,
        jac=jac,
        id=torch.tensor([True, True, False], device=params.device),
    )
