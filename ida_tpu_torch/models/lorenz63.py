"""Lorenz '63 in implicit form, F = y' - f(y).

Port of ``ida_tpu/models/lorenz63.py`` (the reference ships only a stub,
``tests/lorenz63.rs:56-86``):

    x' = sigma (y - x)
    y' = x (rho - z) - y
    z' = x y - beta z

The system is chaotic: two runs that differ in the last bit part within a
few time units. Every callable keeps its input's dtype.
"""

from __future__ import annotations

import torch

from ..problem import IdaProblem


def lorenz63_problem(sigma=10.0, rho=28.0, beta=8.0 / 3.0) -> IdaProblem:
    """The Lorenz system (no ``id``: every variable is differential). Its
    residual holds no tensor, so it runs wherever its arguments live."""

    def res(t, yy, yp):
        # rows as [1, *batch] slices, not 0-dim picks: under forward AD a
        # Python constant times a 0-dim float32 tensor gives a float64 tangent
        x, y, z = yy.split(1)
        fx = sigma * (y - x)
        fy = x * (rho - z) - y
        fz = x * y - beta * z
        xd, yd, zd = yp.split(1)
        return torch.cat([xd - fx, yd - fy, zd - fz])

    return IdaProblem(n=3, res=res)
