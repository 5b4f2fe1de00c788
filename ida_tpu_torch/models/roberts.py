"""Robertson chemical kinetics: the canonical stiff 3-equation DAE.

Port of ``ida_tpu/models/roberts.py`` (reference
``src/sample_problems/roberts.rs:36-114``, SUNDIALS ``idaRoberts_dns``):

    dy1/dt = -.04*y1 + 1e4*y2*y3
    dy2/dt =  .04*y1 - 1e4*y2*y3 - 3e7*y2^2
    0      =  y1 + y2 + y3 - 1

on t in [0, 4e10], y0 = [1, 0, 0]. Roots tracked at y1 = 1e-4 and y3 = 0.01.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..problem import IdaProblem
from ..utils.device import resolve_device

ROBERTS_YY0 = np.array([1.0, 0.0, 0.0])
ROBERTS_YP0 = np.array([-0.04, 0.04, 0.0])
ROBERTS_PARAMS = np.array([0.04, 1.0e4, 3.0e7])




@functools.lru_cache(maxsize=None)
def _id_mask(device: torch.device) -> torch.Tensor:
    """Differential (y1, y2) vs algebraic (y3), built once per device: a
    factory is called per solve, and ``torch.tensor(..., device=cuda)`` is a
    pageable host-to-device copy with a stream synchronize."""
    return torch.tensor([True, True, False], device=device)


def _root(t, yy, yp):
    # (reference roberts.rs:100-113)
    return torch.stack([yy[0] - 0.0001, yy[2] - 0.01])


def roberts_factory(params: torch.Tensor, with_roots: bool = False) -> IdaProblem:
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
        root=_root if with_roots else None,
        nroots=2 if with_roots else 0,
        id=_id_mask(params.device),
    )


def _res(t, yy, yp):
    # (reference src/sample_problems/roberts.rs:47-62)
    r0 = -0.04 * yy[0] + 1.0e4 * yy[1] * yy[2]
    r1 = -r0 - 3.0e7 * yy[1] * yy[1] - yp[1]
    return torch.stack([r0 - yp[0], r1, yy[0] + yy[1] + yy[2] - 1.0])


def _jac(t, cj, yy, yp, rr):
    # analytic J = dF/dy + cj*dF/dy' (reference roberts.rs:66-91)
    one = torch.ones_like(yy[0])
    row0 = torch.stack([-0.04 - cj, 1.0e4 * yy[2], 1.0e4 * yy[1]])
    row1 = torch.stack([0.04 * one, -1.0e4 * yy[2] - 6.0e7 * yy[1] - cj, -1.0e4 * yy[1]])
    return torch.stack([row0, row1, torch.ones_like(yy)])


def roberts_problem(
    analytic_jac: bool = True, with_roots: bool = True, *, device=None
) -> IdaProblem:
    """The fixed-parameter problem of SUNDIALS ``idaRoberts_dns``. Its
    callables hold no tensor, so they run wherever their arguments live;
    ``device`` (None: the current CUDA device) only places the ``id``
    mask."""
    return IdaProblem(
        n=3,
        res=_res,
        jac=_jac if analytic_jac else None,
        root=_root if with_roots else None,
        nroots=2 if with_roots else 0,
        id=_id_mask(resolve_device(device)),  # y3 is algebraic
    )
