"""Morris-Lecar, a two-variable neuron model, in implicit form with its
calcium charge and mean voltage as quadratures.

The membrane potential V (mV) and the potassium gating w of a barnacle
muscle fibre (C. Morris and H. Lecar, Biophys. J. 35, 1981), in the
parameter set of J. Rinzel and G. B. Ermentrout, "Analysis of neural
excitability and oscillations" (1998), Hopf case:

    C V' = I - gL (V - VL) - gCa m_inf(V) (V - VCa) - gK w (V - VK)
    w'   = phi (w_inf(V) - w) cosh((V - V3) / (2 V4))

with m_inf(V) = (1 + tanh((V - V1) / V2)) / 2 and w_inf(V) = (1 + tanh((V -
V3) / V4)) / 2. The applied current I (uA/cm^2) is the one parameter a lane:
sweeping it over [0, 300] crosses the Hopf bifurcation near I = 98, where
the rest state gives way to repetitive firing, the routine excitability
sweep of computational neuroscience. The quadratures are the calcium
charge int gCa m_inf(V) (V - VCa) dt and int V dt.

:func:`morris_lecar_equations` is written once over an array module (its
``stack``, ``tanh``, ``cosh``, ``sinh``), so that the tests run the same code
in ``jax.numpy``; :func:`morris_lecar_factory` is the batch-native torch
factory, through ``utils.numerics``' ``tanh_``/``cosh_``/``sinh_`` (the C
library's on the CPU, the torch ops on the card), whose analytic ``jac`` and
``quad`` the whole-solve kernel compiles in (``ops/fused_model.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import IdaProblem
from ..utils.numerics import cosh_, sinh_, tanh_

# Rinzel & Ermentrout (1998), Hopf case: uF/cm^2, mS/cm^2, mV, 1/ms
C_M, G_CA, G_K, G_L = 20.0, 4.4, 8.0, 2.0
V_CA, V_K, V_L = 120.0, -84.0, -60.0
V1, V2, V3, V4 = -1.2, 18.0, 2.0, 30.0
PHI = 0.04
I_NOMINAL = 100.0
V_REST = -60.0


def morris_lecar_equations(i_app, stack, tanh, cosh, sinh):
    """(res, jac, quad) of the lanes with applied currents ``i_app``, over
    the array module whose ``stack``, ``tanh``, ``cosh`` and ``sinh`` are
    given: F = [C V' - (I - I_ion), w' - phi (w_inf - w) lambda]."""

    def gates(v):
        m = 0.5 * (1.0 + tanh((v - V1) / V2))
        w_inf = 0.5 * (1.0 + tanh((v - V3) / V4))
        return m, w_inf, cosh((v - V3) / (2.0 * V4))

    def res(t, yy, yp):
        v, w = yy[0], yy[1]
        m, w_inf, lam = gates(v)
        ion = i_app - G_L * (v - V_L) - G_CA * m * (v - V_CA) - G_K * w * (v - V_K)
        return stack([C_M * yp[0] - ion, yp[1] - PHI * (w_inf - w) * lam])

    def jac(t, cj, yy, yp, rr):
        v, w = yy[0], yy[1]
        tm, tw = tanh((v - V1) / V2), tanh((v - V3) / V4)
        x = (v - V3) / (2.0 * V4)
        m, w_inf, lam = 0.5 * (1.0 + tm), 0.5 * (1.0 + tw), cosh(x)
        dm = 0.5 * (1.0 - tm * tm) / V2
        dw = 0.5 * (1.0 - tw * tw) / V4
        dlam = sinh(x) / (2.0 * V4)
        return stack([
            stack([cj * C_M + G_L + G_CA * (dm * (v - V_CA) + m) + G_K * w, G_K * (v - V_K)]),
            stack([-PHI * (dw * lam + (w_inf - w) * dlam), cj + PHI * lam]),
        ])

    def quad(t, yy, yp):
        v = yy[0]
        m = 0.5 * (1.0 + tanh((v - V1) / V2))
        return stack([G_CA * m * (v - V_CA), v])

    return res, jac, quad


def morris_lecar_factory(params) -> IdaProblem:
    """Batch-native lanes: ``params`` [1, *batch], the applied current."""
    res, jac, quad = morris_lecar_equations(params[0], torch.stack, tanh_, cosh_, sinh_)
    return IdaProblem(n=2, res=res, jac=jac, quad=quad, nquad=2)


def morris_lecar_inputs(b: int):
    """``b`` lanes at rest (V = -60, w = w_inf(-60)) with I = linspace(0,
    300, b), the last lane at the nominal I = 100; y'(0) consistent:
    (params [b, 1], yy0 [b, 2], yp0 [b, 2])."""
    i_app = np.linspace(0.0, 300.0, b)
    i_app[-1] = I_NOMINAL
    v0 = V_REST
    m0 = 0.5 * (1.0 + np.tanh((v0 - V1) / V2))
    w0 = 0.5 * (1.0 + np.tanh((v0 - V3) / V4))
    ion = G_L * (v0 - V_L) + G_CA * m0 * (v0 - V_CA) + G_K * w0 * (v0 - V_K)
    yp0 = np.stack([(i_app - ion) / C_M, np.zeros(b)], axis=1)
    return i_app[:, None], np.tile([v0, w0], (b, 1)), yp0
