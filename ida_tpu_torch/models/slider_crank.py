"""Slider-crank mechanism: a stabilized index-2 DAE (GGL form), N = 10.

Port of ``ida_tpu/models/slider_crank.py`` (reference
``src/sample_problems/slider_crank.rs:26-155``, SUNDIALS ``idaSlCrank_dns``
by R. Serban). The Jacobian is forward AD of the residual, as in
``ida_tpu``, so the dense path factors a 10 x 10 system (K1 at N = 10 on
the card). ``sin``, ``cos`` and ``sqrt`` go through ``utils.numerics``, so a
CPU run rounds them as the C library and XLA:CPU do. Every callable keeps
its input's dtype.

State: [q, x, p, qd, xd, pd, lam1, lam2, mu1, mu2].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..problem import IdaProblem
from ..utils.device import resolve_device
from ..utils.numerics import cos_, sin_, sqrt_


@functools.lru_cache(maxsize=None)
def _id_mask(device: torch.device) -> torch.Tensor:
    # velocities and positions are differential; lam and mu are algebraic
    return torch.tensor([True] * 6 + [False] * 4, device=device)


def slider_crank_problem(a=0.5, J1=1.0, m2=1.0, J2=2.0, k=1.0, c=1.0, l0=1.0, F=1.0, *,
                         device=None) -> IdaProblem:
    """The mechanism with crank length ``a``, inertias ``J1``, ``J2``, the
    slider's mass ``m2``, the spring-damper ``k``, ``c``, ``l0`` and the
    applied force ``F``. Integrate it with ``IdaOptions(suppressalg=True)``:
    an index-2 system needs its multipliers out of the error test.
    ``device`` (None: the current CUDA device) places the ``id`` mask."""

    def force(yy):
        # the spring-damper force on the generalized coordinates
        # (reference slider_crank.rs:47-80)
        q, x, p, qd, xd, pd = yy.split(1)[:6]
        s1, c1 = sin_(q), cos_(q)
        s2, c2 = sin_(p), cos_(p)
        s21 = s2 * c1 - c2 * s1
        c21 = c2 * c1 + s2 * s1

        l2 = x * x - x * (c2 + a * c1) + (1.0 + a * a) / 4.0 + a * c21 / 2.0
        l = sqrt_(l2)
        ld = (
            2.0 * x * xd
            - xd * (c2 + a * c1)
            + x * (s2 * pd + a * s1 * qd)
            - a * s21 * (pd - qd) / 2.0
        ) / (2.0 * l)

        f = k * (l - l0) + c * ld
        fl = f / l
        return torch.cat([
            -fl * a * (s21 / 2.0 + x * s1) / 2.0,
            fl * (c2 / 2.0 - x + a * c1 / 2.0) + F,
            -fl * (x * s2 - a * s21 / 2.0) / 2.0 - F * s2,
        ])

    def res(t, yy, yp):
        # (reference slider_crank.rs:106-154); rows as [1, *batch] slices,
        # not 0-dim picks: under forward AD a Python constant times a 0-dim
        # float32 tensor gives a float64 tangent
        q, x, p, qd, xd, pd, lam1, lam2, mu1, mu2 = yy.split(1)
        dq, dx, dp, dqd, dxd, dpd = yp.split(1)[:6]
        s1, c1 = sin_(q), cos_(q)
        s2, c2 = sin_(p), cos_(p)
        Q0, Q1, Q2 = force(yy).split(1)
        return torch.cat([
            dq - qd + a * s1 * mu1 - a * c1 * mu2,
            dx - xd + mu1,
            dp - pd + s2 * mu1 - c2 * mu2,
            J1 * dqd - Q0 + a * s1 * lam1 - a * c1 * lam2,
            m2 * dxd - Q1 + lam1,
            J2 * dpd - Q2 + s2 * lam1 - c2 * lam2,
            x - c2 - a * c1,
            -s2 - a * s1,
            a * s1 * qd + xd + s2 * pd,
            -a * c1 * qd - c2 * pd,
        ])

    return IdaProblem(n=10, res=res, id=_id_mask(resolve_device(device)))


def slider_crank_ic(a=0.5, J1=1.0, m2=1.0, J2=2.0):
    """Consistent initial conditions (C idaSlCrank_dns ``setIC``): at rest
    in a configuration that meets the constraints, the accelerations from
    the applied forces (lambda = mu = 0 at rest). Returns numpy ``(yy0,
    yp0)`` [10] in float64; the residual is evaluated on the CPU."""
    q0 = np.pi / 2.0
    p0 = np.arcsin(-a)
    x0 = np.cos(p0) + a * np.cos(q0)
    yy0 = np.zeros(10)
    yy0[0], yy0[1], yy0[2] = q0, x0, p0
    yp0 = np.zeros(10)
    prob = slider_crank_problem(a=a, J1=J1, m2=m2, J2=J2, device="cpu")
    r0 = prob.res(torch.tensor(0.0, dtype=torch.float64), torch.from_numpy(yy0),
                  torch.from_numpy(yp0)).numpy()
    yp0[3:6] = -r0[3:6] / np.array([J1, m2, J2])
    return yy0, yp0
