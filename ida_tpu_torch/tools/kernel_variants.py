"""Launch bounds of the whole-solve kernel, and the host work of one call.

Builds ``csrc/fused_solve.cu`` at several ``(threads a block, resident blocks
an SM)`` through ``-DIDA_THREADS`` / ``-DIDA_MIN_BLOCKS`` (all at once, one
nvcc each), and on the headline ensemble (Roberts, B = 65,536, tout = 400,
f64) times, for each variant in turn and twice over: one bare K2 launch
(CUDA events, median of 3) and every launch of the budget-32 solve. Each
variant's result must be bit for bit the first's. Then it times, on the host
clock, the pieces of one ``make_fused_solve`` call around its launch. One
JSON line per measurement; needs one NVIDIA GPU.

    python3 -m ida_tpu_torch.tools.kernel_variants            # every variant
    python3 -m ida_tpu_torch.tools.kernel_variants t64_b4 t128_b4
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.state import IdaOptions
from ..models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ..ops import _build, fused_solve
from ..parallel import ensemble_init
from ..tol_control import tol_sv

B = 65536
TOUT = 400.0
ATOL = [1e-8, 1e-6, 1e-6]
HEADERS = ("ida_lane.cuh", "small_lu.cuh", "rounded.cuh")
# name -> (threads a block, resident blocks an SM asked of the compiler)
VARIANTS = {
    "t64_b4": (64, 4), "t128_b2": (128, 2), "t32_b8": (32, 8), "t256_b1": (256, 1),
    "t128_b3": (128, 3), "t64_b5": (64, 5), "t128_b4": (128, 4), "t64_b8": (64, 8),
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def event_ms(go) -> float:
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    go()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def host_us(fn, reps: int = 200) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def same_states(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fused_solve.STATE_FIELDS)


def main(names: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit(card=smi, torch=torch.__version__)
    chosen = {k: v for k, v in VARIANTS.items() if not names or k in names}
    with ThreadPoolExecutor(len(chosen)) as pool:
        futures = {
            k: pool.submit(_build.build_library, "fused_solve.cu", HEADERS,
                           flags=(*fused_solve.BUILD_FLAGS, f"-DIDA_THREADS={t}",
                                  f"-DIDA_MIN_BLOCKS={b}"))
            for k, (t, b) in chosen.items()}
        libs = {k: f.result() for k, f in futures.items()}

    params = np.outer(np.exp(np.linspace(-0.2, 0.2, B)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (B, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st0 = ensemble_init(roberts_factory, params, yy0, yp0)
    p_b = torch.as_tensor(params, device="cuda").contiguous()
    tol = tol_sv(1e-4, ATOL)
    tol_in = fused_solve.tol_inputs(tol, 3, B, st0.dtype, st0.phi.device)
    opts = IdaOptions()
    default_build, ref = fused_solve.build, None

    for rnd in range(2):
        for name, info in libs.items():
            fused_solve.bind(info["lib"])
            fused_solve.build = lambda info=info: info
            out = fused_solve.make_fused_solve(roberts_factory, tol)(st0, p_b, TOUT)
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            k2 = []
            for _ in range(3):
                dst = fused_solve.empty_result(st0)
                carry = fused_solve.new_carry(B, st0.dtype, st0.phi.device, False)
                k2.append(event_ms(fused_solve.prepare_launch(
                    "", st0, dst, p_b, tol_in, TOUT, carry, opts, 0, None)))
            dst = fused_solve.empty_result(st0)
            carry = fused_solve.new_carry(B, st0.dtype, st0.phi.device, True)
            budgeted = []

            def step(resume: bool) -> torch.Tensor:
                budgeted.append(event_ms(fused_solve.prepare_launch(
                    "cont" if resume else "init", dst if resume else st0, dst, p_b, tol_in, TOUT,
                    carry, opts, 0, 32)))
                return carry["istate"]

            fused_solve.run_until_done(step)
            ptxas = [v for k, v in _build.ptxas_summary(info["log"]).items()
                     if "fused_solve_kernel" in k and "RealIdEE" in k and "Lb0E" in k]
            emit(variant=name, round=rnd, k2_ms=k2, k2_median_ms=statistics.median(k2),
                 budget32_ms=budgeted, equals_first=same_states(out[0], ref[0]),
                 budgeted_equals_first=same_states(dst, ref[0]), ptxas_f64=ptxas,
                 occupancy=fused_solve.occupancy(torch.float64), build_s=info["seconds"])
    fused_solve.build = default_build

    # the host work of one call of the shipped build, piece by piece
    fn = fused_solve.make_fused_solve(roberts_factory, tol)
    fn(st0, p_b, TOUT)
    dst = fused_solve.empty_result(st0)
    carry = fused_solve.new_carry(B, st0.dtype, st0.phi.device, False)
    go = fused_solve.prepare_launch("", st0, dst, p_b, tol_in, TOUT, carry, opts, 0, None)
    torch.cuda.synchronize()
    emit(host_us={
        "state_refs": host_us(lambda: fused_solve.state_refs(st0, 0)),
        "empty_result": host_us(lambda: fused_solve.empty_result(st0)),
        "new_carry": host_us(lambda: fused_solve.new_carry(B, st0.dtype, st0.phi.device, False)),
        "prepare_launch": host_us(lambda: fused_solve.prepare_launch(
            "", st0, dst, p_b, tol_in, TOUT, carry, opts, 0, None)),
        "launch_and_synchronize": host_us(lambda: (go(), torch.cuda.synchronize()), 20),
        "whole_call_and_synchronize": host_us(
            lambda: (fn(st0, p_b, TOUT), torch.cuda.synchronize()), 20),
    })


if __name__ == "__main__":
    main(sys.argv[1:])
