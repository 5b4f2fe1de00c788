"""The headline's whole-solve launch (K2), timed in one or more checkouts of
this repository, in turns, on one card.

    python3 -m ida_tpu_torch.tools.k2_time CHECKOUT [CHECKOUT ...]

For each CHECKOUT in the order given (e.g. ``old . . old`` for parent,
change, change, parent), a fresh Python process imports that checkout's
``ida_tpu_torch``, builds its kernel library, and times seven bare K2
launches of the headline (Roberts, B = 65,536 lanes, tout 400, f64, rtol
1e-4, atol [1e-8, 1e-6, 1e-6]) with CUDA events: the arguments are checked
and the result allocated before the first event, so a window holds the
launch alone. It prints one JSON line per checkout: the launch times, their
median (the first launch of a process, cold, is left out of it), and the f64
solve kernel's registers, stack and spills from the build's ptxas log. The
card's name and power limit come first. Needs a GPU.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

# run in each checkout; uses only entry points every checkout since the
# whole-solve kernel's redesign has
_CHILD = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import numpy as np, torch
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.ops import _build, fused_solve
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.parallel import ensemble_init
from ida_tpu_torch.tol_control import tol_sv

B = 65536
params = np.outer(np.exp(np.linspace(-0.2, 0.2, B)), ROBERTS_PARAMS)
yy0 = np.tile(ROBERTS_YY0, (B, 1))
yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
p_b = torch.as_tensor(params, device="cuda").contiguous()
tol = fused_solve.tol_inputs(tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device="cuda"), 3, 1,
                             torch.float64, torch.device("cuda"))
info = fused_solve.build()
# the hand-written Roberts: a FusedModel since the kernel took generated models, 0 before
model = getattr(fused_solve, "ROBERTS", 0)
# empty_result takes the mode and the model since the kernel took quadratures
import inspect
with_model = "model" in inspect.signature(fused_solve.empty_result).parameters
runs = []
for _ in range(7):
    dst = fused_solve.empty_result(st0, IdaOptions(), model) if with_model else \
        fused_solve.empty_result(st0)
    carry = fused_solve.new_carry(B, torch.float64, st0.phi.device, False)
    go = fused_solve.prepare_launch("", st0, dst, p_b, tol, 400.0, carry, IdaOptions(), model,
                                    None)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    go()
    ev[1].record()
    torch.cuda.synchronize()
    runs.append(ev[0].elapsed_time(ev[1]))
ptxas = [v for k, v in _build.ptxas_summary(info["log"]).items()
         if "fused_solve_kernel" in k and "RealIdEE" in k and "Lb0E" in k]
print(json.dumps({"checkout": sys.argv[1], "k2_ms": runs,
                  "median_ms": statistics.median(runs[1:]), "ptxas": ptxas}))
"""


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    for checkout in argv:
        proc = subprocess.run([sys.executable, "-c", _CHILD, checkout], cwd=Path(checkout),
                              capture_output=True, text=True, timeout=900, check=False)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
