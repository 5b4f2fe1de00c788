"""idaHeat2D_kry through the PyTorch port: the twin of examples/heat2d.py on
``ida_tpu_torch.IDA``. A 2-D heat DAE with matrix-free SPGMR and the
diagonal preconditioner (BASELINE.md config 4 at grid 100).

Run (on the GPU):  PYTHONPATH=. python examples/heat2d_torch.py [--grid M]
On the CPU:        PYTHONPATH=. python examples/heat2d_torch.py --device cpu
"""

import argparse

from ida_tpu_torch import IDA, IdaOptions, IdaSolveStatus
from ida_tpu_torch.models import heat2d_ic, heat2d_problem
from ida_tpu_torch.tol_control import tol_ss


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--grid", type=int, default=10, help="grid points a side (default 10)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device)")
    args = parser.parse_args()
    m = args.grid
    prob = heat2d_problem(m, use_prec=True, device=args.device)
    u0, up0 = heat2d_ic(m)
    opts = IdaOptions(linear_solver="spgmr", mxstep=20000)
    ida = IDA(prob, u0, up0, tol_ss(1e-5, 1e-8, device=args.device), options=opts,
              device=args.device)

    print(f"idaHeat2D_kry: {m}x{m} grid heat DAE, matrix-free SPGMR, "
          f"diagonal preconditioner (N = {prob.n}) on {ida.device}\n")
    print(f"{'t':>10} {'max(u)':>12} {'nst':>5} {'k':>2} {'nli':>5} {'nps':>6} {'nre':>6}")

    tout = 0.01
    for _ in range(11):
        tret, status = ida.solve(tout)
        assert status == IdaSolveStatus.Success
        print(
            f"{tret:10.4f} {ida.get_yy().max():12.6e} {ida.get_num_steps():5d} "
            f"{ida.get_last_order():2d} {ida.get_num_lin_iters():5d} "
            f"{ida.get_num_prec_solves():6d} {ida.get_num_res_evals():6d}"
        )
        tout *= 2.0

    print("\nmatrix-free: Jacobian evaluations =", ida.get_num_jac_evals())


if __name__ == "__main__":
    main()
