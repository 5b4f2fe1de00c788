"""2-D heat equation DAE on the unit square (SUNDIALS ``idaHeat2D_kry``).

Port of ``ida_tpu/models/heat2d.py``:

    u_t = u_xx + u_yy  on the interior of an M x M grid,
    u   = 0            on the boundary (algebraic identity equations),

initial profile u = 16 x (1-x) y (1-y) (BASELINE.md config 4 at M = 100).
The state is the flattened grid, [M*M, *batch]; the residual is the
5-point Laplacian by shifted copies (``torch.roll``) of the [M, M, *batch]
view, and the diagonal preconditioner is C ``PsetupHeat``/``PsolveHeat``.
The residual is linear, so the Krylov path's J v is given in closed form
(``jtimes_fn``): the same operations a jvp of ``res`` performs on the
tangent, bit for bit, at a fifth of its host time.
Every callable keeps its input's dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..problem import IdaProblem
from ..utils.device import resolve_device
from ..utils.sharding import rows


@functools.lru_cache(maxsize=None)
def _interior(m: int, device: torch.device) -> torch.Tensor:
    mask = np.zeros((m, m), bool)
    mask[1:-1, 1:-1] = True
    return torch.from_numpy(mask.reshape(-1)).to(device)


def heat2d_problem(m: int = 10, use_prec: bool = True, *, device=None) -> IdaProblem:
    """The M x M heat problem; ``device`` (None: the current CUDA device)
    places its interior mask, the problem's ``id``."""
    n = m * m
    dx = 1.0 / (m - 1)
    coeff = 1.0 / (dx * dx)
    interior = _interior(m, resolve_device(device))

    def mask(bnd):
        return interior.reshape((n,) + (1,) * bnd)

    def laplacian(u):
        u2 = u.reshape((m, m) + u.shape[1:])
        lap = (
            torch.roll(u2, 1, 0) + torch.roll(u2, -1, 0)
            + torch.roll(u2, 1, 1) + torch.roll(u2, -1, 1)
            - 4.0 * u2
        ) * coeff
        return lap.reshape(u.shape)

    def res(t, yy, yp):
        # interior: u' - lap(u); boundary: u (algebraic, pins u = 0)
        return torch.where(mask(yy.dim() - 1), yp - laplacian(yy), yy)

    def jtimes_fn(jdata, t, cj, yy, yp, v):
        # J v for the residual, which is linear: the tangent a jvp of res
        # would compute along (v, cj v), operation for operation, without
        # the forward-mode machinery (an order of magnitude of host time)
        return torch.where(mask(v.dim() - 1), cj * v - laplacian(v), v)

    # diagonal preconditioner: interior J_ii = cj + 4/dx^2, boundary 1; on a
    # state sharded over N, the rank's rows of it (prec_local)
    def prec_setup(t, cj, yy, yp, rr):
        one = torch.ones((), dtype=yy.dtype, device=yy.device)
        own = rows(n)
        m_rows = mask(yy.dim() - 1) if own is None else mask(yy.dim() - 1)[own]
        diag = torch.where(m_rows, cj + 4.0 * coeff, one)
        return (1.0 / diag,)

    def prec_solve(pdata, r, cj):
        return pdata[0] * r

    def prec_zero():
        return (torch.zeros(n, dtype=torch.float64),)

    kwargs = {}
    if use_prec:
        kwargs = dict(prec_setup=prec_setup, prec_solve=prec_solve, prec_zero=prec_zero,
                      pdata_rows=((-1, 1),))
    return IdaProblem(n=n, res=res, id=interior, jtimes_fn=jtimes_fn, **kwargs)


def heat2d_ic(m: int = 10):
    """Consistent initial profile (C SetInitialProfile), numpy [M*M] each:
    u0 = 16x(1-x)y(1-y), up0 = lap(u0) in the interior, 0 on the boundary."""
    x = np.linspace(0.0, 1.0, m)
    xx, yy_ = np.meshgrid(x, x, indexing="ij")
    u0 = 16.0 * xx * (1.0 - xx) * yy_ * (1.0 - yy_)
    dx = 1.0 / (m - 1)
    lap = np.zeros_like(u0)
    lap[1:-1, 1:-1] = (
        u0[:-2, 1:-1] + u0[2:, 1:-1] + u0[1:-1, :-2] + u0[1:-1, 2:] - 4 * u0[1:-1, 1:-1]
    ) / dx**2
    up0 = lap
    up0[0, :] = up0[-1, :] = up0[:, 0] = up0[:, -1] = 0.0
    u0[0, :] = u0[-1, :] = u0[:, 0] = u0[:, -1] = 0.0
    return u0.reshape(-1), up0.reshape(-1)
