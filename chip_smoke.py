"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, drives the main path (the batched
Roberts ensemble: B=65,536 lanes to tout=400 in f64 through
``ensemble_init`` + ``make_ensemble_solve``), checks its results against
the CPU and against the canonical Roberts acceptance test, and prints one
JSON line per phase. Any failed check raises, so the exit code is non-zero.

    python3 chip_smoke.py

The last two lines are the kernels' summary and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from ida_tpu_torch import constants as C
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.ops import dense_lu, small_lu
from ida_tpu_torch.parallel import ensemble_init, make_ensemble_solve
from ida_tpu_torch.tol_control import tol_sv

B = 65536
TOUT = 400.0
ATOL = [1e-8, 1e-6, 1e-6]
CANONICAL_NST = [29, 43, 68, 95, 126, 161, 202, 250, 293, 325, 348, 362]
KERNEL_SOURCE = "ida_tpu_torch/csrc/small_lu.cu"
REPLACES = "ida_tpu/ops/pallas_lu.py:28"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ensemble_inputs(b: int):
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, b)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


def run_ensemble(params, yy0, yp0, device, tout):
    st = ensemble_init(roberts_factory, params, yy0, yp0, device=device)
    tol = tol_sv(1e-4, ATOL, device=device)
    return make_ensemble_solve(roberts_factory)(st, params, tol, tout)


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run(
        [small_lu.nvcc_path(), "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    info = small_lu.build()
    emit("build", seconds=info["seconds"], cached=info["cached"], library=info["path"])


def phase_kernels() -> dict:
    """Kernel vs plain on the same CUDA tensors: bit for bit."""
    errs = {"factor": 0.0, "solve": 0.0}
    for dtype in (torch.float64, torch.float32):
        for n in (3, 5, 8, 16):
            rng = np.random.default_rng(n)
            a = torch.from_numpy(rng.normal(size=(n, n, B)) + 3.0 * np.eye(n)[:, :, None]).to("cuda", dtype)
            b = torch.from_numpy(rng.normal(size=(n, B))).to("cuda", dtype)
            f, g = small_lu.lu_factor(a), dense_lu.lu_factor_unrolled(a)
            x, y = small_lu.lu_solve(f, b), dense_lu.lu_solve_unrolled(g, b)
            torch.cuda.synchronize()
            err_f = float((f.lu - g.lu).abs().max())
            err_s = float((x - y).abs().max())
            same = (torch.equal(f.lu, g.lu) and torch.equal(x, y)
                    and torch.equal(f.piv, g.piv) and torch.equal(f.fail_col, g.fail_col))
            emit("kernel_vs_plain", dtype=str(dtype), n=n, batch=B, bitwise_equal=same,
                 max_abs_err_lu=err_f, max_abs_err_x=err_s)
            check(same, f"kernel != plain at n={n} {dtype}")
            errs["factor"] = max(errs["factor"], err_f)
            errs["solve"] = max(errs["solve"], err_s)

    # singular lanes: first zero pivot's 1-based column, else 0
    a = torch.zeros((3, 3, 4), dtype=torch.float64)
    a[0, 0, 0] = 1.0  # column 2 has no pivot
    a[:, 1:, 1] = 1.0  # column 1 is zero
    a[:, :, 2] = torch.eye(3, dtype=torch.float64) * 2.0
    a[:, :, 3] = torch.eye(3, dtype=torch.float64)
    a[2, 2, 3] = 0.0  # last pivot zero
    f = small_lu.lu_factor(a.to("cuda"))
    fail = f.fail_col.cpu().tolist()
    emit("kernel_singular", fail_col=fail, expected=[2, 1, 0, 3])
    check(fail == [2, 1, 0, 3], f"fail_col {fail}")

    # times at the main path's shape: N=3, B=65,536, f64 (plain, kernel,
    # kernel, plain; the matrices fit in L2, as the solver's freshly
    # written Jacobians do)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(3, 3, B)) + 3.0 * np.eye(3)[:, :, None]).to("cuda")
    b = torch.from_numpy(rng.normal(size=(3, B))).to("cuda")
    f = small_lu.lu_factor(a)
    t = {}
    for key, fn, reps in [
        ("factor_plain_1", lambda: dense_lu.lu_factor_unrolled(a), 50),
        ("factor_kernel_1", lambda: small_lu.lu_factor(a), 500),
        ("factor_kernel_2", lambda: small_lu.lu_factor(a), 500),
        ("factor_plain_2", lambda: dense_lu.lu_factor_unrolled(a), 50),
        ("solve_plain_1", lambda: dense_lu.lu_solve_unrolled(f, b), 50),
        ("solve_kernel_1", lambda: small_lu.lu_solve(f, b), 500),
        ("solve_kernel_2", lambda: small_lu.lu_solve(f, b), 500),
        ("solve_plain_2", lambda: dense_lu.lu_solve_unrolled(f, b), 50),
    ]:
        t[key] = cuda_ms(fn, reps)
    times = {
        k: {"ms": (t[f"{k}_kernel_1"] + t[f"{k}_kernel_2"]) / 2,
            "plain_ms": (t[f"{k}_plain_1"] + t[f"{k}_plain_2"]) / 2}
        for k in ("factor", "solve")
    }
    emit("kernel_times", n=3, batch=B, dtype="float64", runs_ms=t, **times)
    return {k: {"max_abs_err": errs[k], **times[k]} for k in errs}


def phase_slice() -> dict:
    params, yy0, yp0 = ensemble_inputs(B)
    run_ensemble(params, yy0, yp0, "cuda", TOUT)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    small_lu.reset_launch_counts()
    t0 = time.perf_counter()
    st, tret, istate = run_ensemble(params, yy0, yp0, "cuda", TOUT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"factor": small_lu.FACTOR_LAUNCHES, "solve": small_lu.SOLVE_LAUNCHES}
    totals = {f: int(getattr(st, f).sum()) for f in ("nst", "nre", "nje", "nni", "netf", "ncfn")}
    n_ok = int((istate == C.SUCCESS).sum())
    emit("slice", batch=B, tout=TOUT, dtype="float64", wall_s=wall, lanes_success=n_ok,
         steps_per_s=totals["nst"] / wall, launches=launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), **totals)
    check(n_ok == B, f"{B - n_ok} lanes did not return SUCCESS")
    check(bool((tret == TOUT).all()), "tret != tout")
    check(bool(torch.isfinite(st.yy).all()) and tuple(st.yy.shape) == (B, 3), "bad yy")
    check(launches["factor"] > 0 and launches["solve"] > 0, f"LU kernels not launched: {launches}")
    return launches


def phase_card_vs_cpu() -> None:
    params, yy0, yp0 = ensemble_inputs(B)
    lanes = slice(0, 256)
    args = (params[lanes], yy0[lanes], yp0[lanes])
    sg, _, ig = run_ensemble(*args, "cuda", TOUT)
    sc, _, ic = run_ensemble(*args, "cpu", TOUT)
    check(bool((ig == C.SUCCESS).all()) and bool((ic == C.SUCCESS).all()), "a lane failed")
    ycpu = sc.yy.numpy()
    w = 1.0 / (1e-4 * np.abs(ycpu) + np.array(ATOL))
    wrms = np.sqrt(np.mean((w * (sg.yy.cpu().numpy() - ycpu)) ** 2, axis=1))
    differ = np.zeros(256, bool)
    for f in ("nst", "nre", "nje", "nni", "netf", "ncfn"):
        differ |= getattr(sg, f).cpu().numpy() != getattr(sc, f).numpy()
    emit("card_vs_cpu", lanes=256, max_wrms=float(wrms.max()), lanes_counters_differ=int(differ.sum()))
    check(float(wrms.max()) < 1.0, f"card vs CPU WRMS {wrms.max()}")


def phase_canonical() -> None:
    params = ROBERTS_PARAMS[None, :]
    st = ensemble_init(roberts_factory, params, ROBERTS_YY0[None], ROBERTS_YP0[None], device="cuda")
    fn = make_ensemble_solve(roberts_factory)
    tol = tol_sv(1e-4, ATOL, device="cuda")
    nst = []
    for k in range(12):
        st, tret, istate = fn(st, params, tol, 0.4 * 10**k)
        check(int(istate[0]) == C.SUCCESS, f"decade {k}: istate {int(istate[0])}")
        nst.append(int(st.nst[0]))
    reference = np.array([5.2083474251394888e-08, 2.0833390772616859e-13, 9.9999994791631752e-01])
    ewt = 1.0 / (1e-4 * np.abs(reference) + 10.0 * np.array(ATOL))
    err = float(np.sqrt(np.mean((ewt * (st.yy[0].cpu().numpy() - reference)) ** 2)))
    emit("canonical_lane", nst_per_decade=nst, canonical=CANONICAL_NST, check_ans_wrms=err,
         tret=float(tret[0]))
    check(float(tret[0]) == 4.0e10, "final tret")
    check(err < 1.0, f"check_ans WRMS {err}")


def main() -> None:
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_slice()
    phase_card_vs_cpu()
    phase_canonical()
    print(json.dumps({"kernels": [
        {"name": f"small_lu_{k}", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": launches[k], **kernels[k]}
        for k in ("factor", "solve")
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
