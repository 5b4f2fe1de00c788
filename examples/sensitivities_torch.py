"""A tour of sensitivities on Roberts kinetics through the PyTorch port: the
twin of examples/sensitivities.py on ``ida_tpu_torch.sensitivity``. Forward
dy/dp (forward-mode AD through the solve), the adjoint dL/dp (one backward
pass, the IDAS adjoint role), the gradient of an integral loss through
quadratures, the gradient through ``calc_ic`` and per-lane gradients of a
parameter ensemble.

Run (on the GPU):  PYTHONPATH=. python examples/sensitivities_torch.py
On the CPU:        PYTHONPATH=. python examples/sensitivities_torch.py --device cpu
"""

import argparse
import dataclasses

import numpy as np
import torch

from ida_tpu_torch.core.quad import get_quad
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.sensitivity import (adjoint_gradient, batched_adjoint_gradient,
                                       forward_sensitivity)
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils.device import resolve_device

TOUT = 4.0


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device)")
    device = resolve_device(parser.parse_args().device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    tol = tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device=device)
    p0 = t(ROBERTS_PARAMS)

    def yy0_of(p):
        return t(ROBERTS_YY0)

    def yp0_of(p):
        return p[0] * t([-1.0, 1.0, 0.0])

    # --- forward: dy(tout)/dk1 from one forward-mode pass
    y, dy_dk1 = forward_sensitivity(roberts_factory, p0, yy0_of, yp0_of, tol, TOUT,
                                    t([1.0, 0.0, 0.0]), device=device)
    print(f"y(t={TOUT})          = {y.cpu().numpy()}")
    print(f"dy/dk1 (forward jvp) = {dy_dk1.cpu().numpy()}")

    # --- adjoint: d loss(y(tout)) / dp for every p from one backward pass
    w = t([1.0, 2.0, 3.0])
    val, grad, istate = adjoint_gradient(roberts_factory, p0, yy0_of, yp0_of, tol, TOUT,
                                         lambda y: torch.sum(y * w), max_attempts=120,
                                         device=device)
    assert int(istate) == 0
    print(f"loss sum(w*y)        = {float(val):.12f}")
    print(f"dL/dp (adjoint grad) = {grad.cpu().numpy()}")

    # --- the adjoint of an integral loss, L = int_0^T y3 dt, through the
    # solver's quadratures
    def factory_q(p):
        return dataclasses.replace(roberts_factory(p), quad=lambda t_, yy, yp: yy[2:3], nquad=1)

    val_q, grad_q, istate_q = adjoint_gradient(
        factory_q, p0, yy0_of, yp0_of, tol, TOUT, None, max_attempts=120,
        loss_of_state=lambda st, tret, prob: get_quad(st, prob, tret)[0], device=device)
    assert int(istate_q) == 0
    print(f"∫ y3 dt              = {float(val_q):.12f}")
    print(f"d(∫ y3 dt)/dp        = {grad_q.cpu().numpy()}")

    # --- the adjoint through IDACalcIC (implicit differentiation): an
    # inconsistent guess that calc_ic fixes, the gradient through the IC solve
    val_ic, grad_ic, istate_ic = adjoint_gradient(
        roberts_factory, p0, lambda p: t([1.0, 0.0, 0.3]), lambda p: t([0.0, 0.0, 0.0]),
        tol, TOUT, lambda y: torch.sum(y * w), max_attempts=120, ic=("ya_ydp", 0.4),
        device=device)
    assert int(istate_ic) == 0
    print(f"loss (via calc_ic)   = {float(val_ic):.12f}")
    print(f"dL/dp (thru calc_ic) = {grad_ic.cpu().numpy()}")

    # --- batched adjoint: per-lane gradients of a parameter ensemble
    pb = t([0.9, 1.0, 1.1])[:, None] * p0[None, :]
    vals, grads, istates = batched_adjoint_gradient(
        roberts_factory, pb, yy0_of, yp0_of, tol, TOUT, lambda y: torch.sum(y * w),
        max_attempts=120, device=device)
    assert np.all(istates.cpu().numpy() == 0)
    for b in range(3):
        print(f"lane {b}: loss={float(vals[b]):.9f}  dL/dp={grads[b].cpu().numpy()}")


if __name__ == "__main__":
    main()
