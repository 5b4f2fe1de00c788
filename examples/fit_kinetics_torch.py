"""Parameter estimation by gradient descent through the DAE solver, in the
PyTorch port: the twin of examples/fit_kinetics.py, with ``torch.optim.Adam``
in place of optax.

Recovers the Roberts rate constant k1 from observations of y1 at four
times. Each term |y1(t_i; p) - d_i|^2 of the loss needs y1 at its own t_i;
``ida_tpu``'s twin vmaps one ``continuous_adjoint`` a term. Here the four
terms are four lanes of ONE batch-native ``batched_continuous_adjoint``
(a checkpointed forward solve, the backward adjoint DAE, the gradient by
backward quadratures): lane i integrates Roberts in the scaled time
s = t / t_i, whose rates are t_i k (so every lane ends at s = 1, on the
twin's grid t_i linspace(0, 1, 65)[1:]), with the adjoint of y1(1), and the
gradient of the squared loss follows by the chain rule, in log k1.

Run (on the GPU):  PYTHONPATH=. python examples/fit_kinetics_torch.py
On the CPU:        PYTHONPATH=. python examples/fit_kinetics_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.sensitivity import batched_continuous_adjoint, solve_with_params
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils.device import resolve_device

OPTS = IdaOptions(mxstep=20000)
T_OBS = np.asarray([0.4, 1.0, 2.0, 4.0])
K1_TRUE = ROBERTS_PARAMS[0]  # 0.04


def scaled_factory(p):
    """Roberts in the scaled time s = t / t_i: p = [log(t_i k1), t_i k2,
    t_i k3], batch-last [3, B]."""
    return roberts_factory(torch.stack([torch.exp(p[0]), p[1], p[2]]))


def make_loss_and_grad(data, tol, device):
    grid = torch.linspace(0.0, 1.0, 65, dtype=torch.float64)[1:]
    yy0 = np.tile(ROBERTS_YY0, (len(T_OBS), 1))
    data = np.asarray(data)

    def loss_and_grad(logk1: float):
        params = np.stack([logk1 + np.log(T_OBS), T_OBS * ROBERTS_PARAMS[1],
                           T_OBS * ROBERTS_PARAMS[2]], axis=1)
        yp0 = np.exp(params[:, :1]) * np.array([-1.0, 1.0, 0.0])
        y1, dy1, _, istf, istb = batched_continuous_adjoint(
            scaled_factory, params, yy0, yp0, tol, 1.0, lambda y: y[0], grid=grid, opts=OPTS,
            device=device)
        resid = y1.cpu().numpy() - data
        # d/dlog k1 of sum_i (y1_i - d_i)^2, log k1 entering lane i's p[0]
        grad = float(np.sum(2.0 * resid * dy1[:, 0].cpu().numpy()))
        bad = int(max(istf.abs().max(), istb.abs().max()))
        return float(np.sum(resid**2)), grad, bad

    return loss_and_grad


def solve_y1(tol, device, t):
    """y1(t) at the true parameters (the observations)."""
    f = solve_with_params(
        roberts_factory, None,
        lambda p: torch.as_tensor(ROBERTS_YY0, dtype=torch.float64, device=device),
        lambda p: p[0:1] * torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float64, device=device),
        tol, t, opts=OPTS)
    return float(f(torch.as_tensor(ROBERTS_PARAMS, dtype=torch.float64, device=device))[0])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device)")
    parser.add_argument("--iters", type=int, default=30, help="Adam iterations")
    args = parser.parse_args()
    device = resolve_device(args.device)
    tol = tol_sv(1e-8, [1e-10, 1e-12, 1e-10], device=device)

    data = [solve_y1(tol, device, float(t)) for t in T_OBS]
    loss_and_grad = make_loss_and_grad(data, tol, device)

    # log k1, started 2x off
    param = torch.nn.Parameter(torch.tensor(np.log(K1_TRUE * 2.0), dtype=torch.float64))
    opt = torch.optim.Adam([param], lr=0.2)
    # decay the step so Adam settles instead of orbiting the optimum
    # (optax.exponential_decay(0.2, 10, 0.5))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 0.5 ** (s / 10))

    print(f"fitting k1 (true {K1_TRUE:g}) from y1 at t = {T_OBS.tolist()}")
    print(f"{'iter':>4} {'k1':>12} {'loss':>12}")
    for it in range(args.iters):
        loss, grad, bad = loss_and_grad(float(param.detach()))
        assert bad == 0, "a solve failed during fitting"
        opt.zero_grad()
        param.grad = torch.tensor(grad, dtype=torch.float64)
        opt.step()
        sched.step()
        if it % 10 == 0 or it == args.iters - 1:
            print(f"{it:>4} {float(np.exp(float(param.detach()))):12.6g} {loss:12.4e}")

    # polish: a secant iteration on the gradient's root
    x0 = float(param.detach()) - 0.02
    g0 = loss_and_grad(x0)[1]
    x1 = float(param.detach())
    for it in range(6):
        loss, g1, bad = loss_and_grad(x1)
        assert bad == 0, "a solve failed during polish"
        if abs(g1) < 1e-14 or g1 == g0:
            break
        x0, g0, x1 = x1, g1, x1 - g1 * (x1 - x0) / (g1 - g0)
        print(f"  secant {it}: k1={np.exp(x1):.8g} loss={loss:.4e}")

    k1 = float(np.exp(x1))
    err = abs(k1 - K1_TRUE) / K1_TRUE
    print(f"recovered k1 = {k1:.6g}  (relative error {err:.2e})")
    ok = err < 1e-3
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
