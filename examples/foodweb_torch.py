"""idaFoodWeb_kry through the PyTorch port: the twin of examples/foodweb.py
on ``ida_tpu_torch.IDA``. A predator-prey reaction-diffusion DAE with
algebraic predators, matrix-free SPGMR with the block-diagonal
preconditioner, and calc_ic for consistent initial conditions (BASELINE.md
config 5 at grid 20).

Run (on the GPU):  PYTHONPATH=. python examples/foodweb_torch.py [--grid MX]
On the CPU:        PYTHONPATH=. python examples/foodweb_torch.py --device cpu
"""

import argparse

from ida_tpu_torch import IDA, IdaOptions, IdaSolveStatus
from ida_tpu_torch.models import foodweb_ic, foodweb_problem
from ida_tpu_torch.tol_control import tol_ss


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--grid", type=int, default=12, help="grid points a side (default 12)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device)")
    args = parser.parse_args()
    mx = my = args.grid
    prob = foodweb_problem(mx, my, device=args.device)
    c0, cp0 = foodweb_ic(mx, my)
    opts = IdaOptions(linear_solver="spgmr", mxstep=20000, krylov_maxl=12, krylov_max_restarts=10)
    ida = IDA(prob, c0, cp0, tol_ss(1e-5, 1e-5, device=args.device), options=opts,
              device=args.device)

    print(f"idaFoodWeb_kry: {mx}x{my} grid, 1 prey + 1 predator (algebraic), "
          f"SPGMR + block-diagonal preconditioner (N = {prob.n}) on {ida.device}\n")

    print("calc_ic: correcting the flat predator guess onto the algebraic manifold...")
    ida.calc_ic("ya_ydp", tout1=1e-3)
    y0, _ = ida.get_consistent_ic()
    c = y0.reshape(mx, my, 2)
    print(f"  prey  range: [{c[..., 0].min():.4f}, {c[..., 0].max():.4f}]")
    print(f"  pred  range: [{c[..., 1].min():.1f}, {c[..., 1].max():.1f}]\n")

    print(f"{'t':>10} {'prey(mid)':>12} {'pred(mid)':>14} {'nst':>5} {'nli':>6} {'nps':>7}")
    t = 1e-3
    for _ in range(8):
        tret, status = ida.solve(t)
        assert status == IdaSolveStatus.Success
        c = ida.get_yy().reshape(mx, my, 2)
        print(
            f"{tret:10.4f} {c[mx // 2, my // 2, 0]:12.6f} "
            f"{c[mx // 2, my // 2, 1]:14.2f} {ida.get_num_steps():5d} "
            f"{ida.get_num_lin_iters():6d} {ida.get_num_prec_solves():7d}"
        )
        t *= 2.0
    print("\nmatrix-free: Jacobian evaluations =", ida.get_num_jac_evals())


if __name__ == "__main__":
    main()
