"""Variants of the hand-written kernels, built side by side and timed in
turns on one card. Two modes; one JSON line per measurement, the card's name
and power limit first; each needs one NVIDIA GPU.

**K2** (the default mode): launch bounds of the whole-solve kernel, and the
host work of one call. Builds ``csrc/fused_solve.cu`` at several ``(threads a
block, resident blocks an SM)`` through ``-DIDA_THREADS`` /
``-DIDA_MIN_BLOCKS`` (all at once, one nvcc each), and on the headline
ensemble (Roberts, B = 65,536, tout = 400, f64) times, for each variant in
turn and twice over: one bare K2 launch (CUDA events, median of 3) and every
launch of the budget-32 solve. Each variant's result must be bit for bit the
first's. Then it times, on the host clock, the pieces of one
``make_fused_solve`` call around its launch.

    python3 -m ida_tpu_torch.tools.kernel_variants            # every variant
    python3 -m ida_tpu_torch.tools.kernel_variants t64_b4 t128_b4

**K1** (``k1``): the skeletons of the LU kernels of ``csrc/small_lu.cu``.
Builds the shipped source as it is (``new``), with the parent's dispatch
(``parent``: ``-DIDA_LU_GROUP=0``: one thread a lane at every N and lane
count) and at the other candidates of ``K1_VARIANTS`` (``groups``: the group
skeleton everywhere; ``first_skeleton``: the first solve skeleton, one lane a thread in
128-thread blocks, scalar accesses), plus ``-DIDA_LU_FLOOR`` (the floor
kernels, on the grid of the skeleton the rule picks). For each build in turn (parent,
new, the others, then the same backwards: old, new, new, old) it holds the
solves bit for bit against their plain versions and takes their cold device
time (torch.profiler, the input sets rotated so that every launch reads HBM,
as ``chip_smoke.py`` does) on: the N = 2 solve at [2, 2, 400, 128] (the
foodweb preconditioner's blocks at B = 128) contiguous, in ``ida_tpu``'s
pdata layout, and in the layout ``foodweb.prec_solve`` hands it; the N = 3
solve and ``small_lu_solve_t`` at B = 65,536; the N = 6 solve at B = 1,024
(the continuous adjoint's KKT system), 320 input sets, cold; the float32 N = 3
solve at 65,536 lanes and N = 2 on foodweb's blocks (the mixed modes). Then
the floor of those N = 2 and float32 bytes (a copy in the new skeleton and an
empty launch on its grid), the few-lane rows
(:data:`FEW_LANES`: N = 10 on one lane, N = 6 on 1,024, factor and solve;
new and parent in turns, each with its bytes bound, its floor on the
shipped skeleton's grid, ``torch.linalg``'s time, registers and spills) and,
with ``--parent
DIR`` (a checkout of the parent commit), the device events and device time
of one ``foodweb.prec_solve`` at 20 x 20, B = 128 in DIR and here, in turns
(parent, new, new, parent), one process each.

    python3 -m ida_tpu_torch.tools.kernel_variants k1 [--parent DIR] [VARIANT ...]

``k1 --sweep`` instead times the factor and the solve of the ``parent`` and
``groups`` builds in turns (parent, groups, groups, parent) over
:data:`SWEEP_N` x :data:`SWEEP_LANES` in both dtypes, each bit for bit its
plain version (the sweep behind the rule ``kGroupRule``), then reports the
registers and spills of both skeletons and a summary of the SASS of the N = 6
and N = 10 kernels (``cuobjdump``; the listings under ``build/k1_sass/``),
and ends with the few-lane rows of the transposed solve.

    python3 -m ida_tpu_torch.tools.kernel_variants k1 --sweep

``k1 --solve-t`` times only those rows: ``small_lu_solve_t`` as shipped (one
thread a lane at every N) at :data:`SOLVE_T_N` x :data:`SOLVE_T_LANES` in
float64, each bit for bit its plain version, cold, beside its bytes bound and
``torch.linalg.lu_solve(..., adjoint=True)`` on the same systems.

    python3 -m ida_tpu_torch.tools.kernel_variants k1 --solve-t
"""

from __future__ import annotations

import collections
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..core.state import IdaOptions
from ..models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ..ops import _build, dense_lu, fused_solve, small_lu
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
            fused_solve.build = lambda *_, info=info, **__: info
            out = fused_solve.make_fused_solve(roberts_factory, tol)(st0, p_b, TOUT)
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            k2 = []
            for _ in range(3):
                dst = fused_solve.empty_result(st0, opts, fused_solve.ROBERTS)
                carry = fused_solve.new_carry(B, st0.dtype, st0.phi.device, False)
                k2.append(event_ms(fused_solve.prepare_launch(
                    "", st0, dst, p_b, tol_in, TOUT, carry, opts, fused_solve.ROBERTS, None)))
            dst = fused_solve.empty_result(st0, opts, fused_solve.ROBERTS)
            carry = fused_solve.new_carry(B, st0.dtype, st0.phi.device, True)
            budgeted = []

            def step(resume: bool) -> torch.Tensor:
                budgeted.append(event_ms(fused_solve.prepare_launch(
                    "cont" if resume else "init", dst if resume else st0, dst, p_b, tol_in, TOUT,
                    carry, opts, fused_solve.ROBERTS, 32)))
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
    dst = fused_solve.empty_result(st0, opts, fused_solve.ROBERTS)
    carry = fused_solve.new_carry(B, st0.dtype, st0.phi.device, False)
    go = fused_solve.prepare_launch("", st0, dst, p_b, tol_in, TOUT, carry, opts,
                                    fused_solve.ROBERTS, None)
    torch.cuda.synchronize()
    emit(host_us={
        "state_refs": host_us(lambda: fused_solve.state_refs(st0, 0, opts, fused_solve.ROBERTS)),
        "empty_result": host_us(lambda: fused_solve.empty_result(st0, opts, fused_solve.ROBERTS)),
        "new_carry": host_us(lambda: fused_solve.new_carry(B, st0.dtype, st0.phi.device, False)),
        "prepare_launch": host_us(lambda: fused_solve.prepare_launch(
            "", st0, dst, p_b, tol_in, TOUT, carry, opts, fused_solve.ROBERTS, None)),
        "launch_and_synchronize": host_us(lambda: (go(), torch.cuda.synchronize()), 20),
        "whole_call_and_synchronize": host_us(
            lambda: (fn(st0, p_b, TOUT), torch.cuda.synchronize()), 20),
    })


# ---------------------------------------------------------------- K1 mode

# name -> -D flags of csrc/small_lu.cu (``new`` is the shipped build)
K1_VARIANTS = {
    "parent": ("-DIDA_LU_GROUP=0",),
    "new": (),
    "groups": ("-DIDA_LU_GROUP=2",),
    "first_skeleton": ("-DIDA_LU_GROUP=0", "-DIDA_LU_VEC=0"),
    "pairs_t128": ("-DIDA_LU_THREADS=128",),
}
K1_FLOOR = ("-DIDA_LU_FLOOR",)
SWEEP_N = tuple(range(1, 17))
SWEEP_LANES = (1, 32, 1024, 8192, 65536)
# name -> (N, lanes, input sets): the rows of few lanes (slider-crank's one
# lane, in L2 as its fresh Jacobian; the continuous adjoint's KKT systems,
# cold, as the one-thread solve was first timed: 320 sets move ~190 MB a
# factor pass)
FEW_LANES = {"n10_b1": (10, 1, 64), "n6_b1024": (6, 1024, 320)}
# the transposed solve's few-lane rows (k1 --solve-t): N x lanes, float64
SOLVE_T_N = (3, 6, 10)
SOLVE_T_LANES = (1, 32, 1024)
K1_HEADERS = ("small_lu.cuh", "rounded.cuh")
FOOD_NPTS, FOOD_B = 400, 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, 700 W


def cold_device_ms(fns, rounds: int, name_part: str | None = None) -> float:
    """Device time per launch of the kernels whose name holds ``name_part``
    over ``rounds`` passes through ``fns`` (after a warm-up pass), from
    torch.profiler, averaged over the launches it recorded: chip_smoke.py's
    protocol. With no ``name_part``, the device time of everything the calls
    ran per call (a library call may run several kernels). A short spin heads
    the window (the profiler was seen to drop a window's first activity), and
    a window that recorded nothing is taken again, up to three times."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(rounds):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.key]
        picked = [e for e in on_card if name_part is None or name_part in e.key]
        count = sum(e.count for e in picked)
        if count:
            total = sum(e.self_device_time_total for e in picked) / 1e3
            return total / (rounds * len(fns)) if name_part is None else total / count
    raise RuntimeError(f"the profiler recorded no device time for {name_part}")


def k1_shapes(device) -> dict:
    """name -> (kernel, sets of (factors, right-hand side), profiler rounds):
    the solves' shapes, 64 sets at N = 2 (~240 MB a pass), 16 at N = 3
    (~140 MB) and 320 at N = 6 (~130 MB), each over the 50 MB of L2, so
    every launch reads HBM; the float32 rows 32 sets at N = 3 (~150 MB) and
    128 at N = 2 (~250 MB)."""
    def factors(n, lanes, seed):
        rng = np.random.default_rng(seed)
        a = rng.normal(size=(n, n) + lanes) + 3.0 * np.eye(n).reshape((n, n) + (1,) * len(lanes))
        return dense_lu.lu_factor_unrolled(torch.from_numpy(a).to(device))

    def rhs(n, lanes, seed):
        return torch.from_numpy(np.random.default_rng(seed).normal(size=(n,) + lanes)).to(device)

    food = (FOOD_NPTS, FOOD_B)
    f2, b2 = factors(2, food, 2), rhs(2, food, 22)
    # ida_tpu's pdata layout (as a checkpoint loads it): lu [npts, 2, 2, B],
    # piv [npts, 2, B], r [npts * 2, B], viewed as the solve takes them
    pdata = dense_lu.DenseLU(f2.lu.movedim((0, 1), (1, 2)).contiguous().movedim((1, 2), (0, 1)),
                             f2.piv.movedim(0, 1).contiguous().movedim(1, 0), None)
    r2 = b2.movedim(0, 1).contiguous().movedim(1, 0)
    f3, b3 = factors(3, (65536,), 3), rhs(3, (65536,), 33)
    f6, b6 = factors(6, (1024,), 6), rhs(6, (1024,), 66)

    def sets(f, b, count):
        return [(dense_lu.DenseLU(f.lu.clone(memory_format=torch.preserve_format),
                                  f.piv.clone(memory_format=torch.preserve_format), None),
                 b.clone(memory_format=torch.preserve_format)) for _ in range(count)]

    def f32(f):  # the factors cast as the mixed modes cast them, strides kept
        return dense_lu.DenseLU(f.lu.to(torch.float32), f.piv, None)

    return {
        "n2_contiguous": ("solve", sets(f2, b2, 64), 2),
        "n2_pdata": ("solve", sets(pdata, r2, 64), 2),
        "n2_prec_solve": ("solve", sets(f2, r2, 64), 2),
        "n3": ("solve", sets(f3, b3, 16), 4),
        "n3_solve_t": ("solve_t", sets(f3, b3, 16), 4),
        "n6": ("solve", sets(f6, b6, 320), 2),
        # the float32 rows of the mixed modes: N = 3 at 65,536 lanes, N = 2
        # on foodweb's blocks as the Krylov "single" prec_solve reads them
        "n3_f32": ("solve", sets(f32(f3), b3.float(), 32), 4),
        "n2_prec_solve_f32": ("solve", sets(f32(f2), r2.float(), 128), 2),
    }


def k1_bytes(f: dense_lu.DenseLU, b: torch.Tensor) -> int:
    """lu, piv and b read once, x written once."""
    return (f.lu.numel() * f.lu.element_size() + f.piv.numel() * 4
            + 2 * b.numel() * b.element_size())


def k1_layout(f, b) -> dict:
    return small_lu.solve_layout(f.lu, f.piv, b, torch.empty_like(b)).as_dict()


_KERNEL_NAME = re.compile(
    r"(solve_t_kernel|solve_kernel|factor_kernel|factor_group_kernel|solve_group_kernel)"
    r"I([df])Li(\d+)E(?:Li(\d+)E)?")


def _short(name: str) -> str:
    m = _KERNEL_NAME.search(name)
    return ",".join(g for g in m.groups() if g) if m else name


def k1_ptxas(log: str) -> dict:
    """Registers and spills of the solves at N = 2, 3, 6, of the factors and
    the group kernels at N = 6, 10, 16, and spill store bytes of every
    kernel that spills, by (kernel, type, N[, lanes])."""
    summary = _build.ptxas_summary(log)
    return {"solves_n2_3_6": {_short(k): v for k, v in summary.items()
                              if re.search(r"solve_(t_)?kernelI", k)
                              and any(f"Li{n}E" in k for n in (2, 3, 6))},
            "n6_10_16": {_short(k): v for k, v in summary.items()
                         if re.search(r"(factor_kernel|group_kernel)I", k)
                         and any(f"Li{n}E" in k for n in (6, 10, 16))},
            "spill_stores": {_short(k): v["spill_stores"] for k, v in summary.items()
                             if v.get("spill_stores", 0) > 0}}


def k1_sass(info: dict, n_values=(6, 10), out_dir: str = "build/k1_sass") -> dict:
    """A summary of the SASS of the factor and solve kernels at ``n_values``
    in a built library (``cuobjdump -sass``): instructions, global loads and
    stores, the index of the last load and of the first floating-point
    operation, shuffles, and the opcodes' counts. The listings are written
    under ``out_dir``."""
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", info["path"]], capture_output=True, text=True,
                          check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        m = _KERNEL_NAME.search(name)
        if not m or "solve_t" in m.group(1) or int(m.group(3)) not in n_values:
            continue
        ops = [ln.split("*/", 1)[1].strip().rstrip(" ;") for ln in chunk.splitlines()
               if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        codes = [op.split()[0] if not op.startswith("@") else op.split()[1] for op in ops if op]
        base = [c.split(".")[0] for c in codes]
        loads = [i for i, c in enumerate(base) if c == "LDG"]
        fp = [i for i, c in enumerate(base) if c in ("DADD", "DMUL", "DFMA", "FADD", "FMUL", "FFMA",
                                                       "MUFU")]
        short = _short(name)
        out[short] = {"instructions": len(codes), "LDG": len(loads), "STG": base.count("STG"),
                      "SHFL": base.count("SHFL"), "last_LDG": max(loads, default=-1),
                      "first_fp": min(fp, default=-1),
                      "opcodes": dict(collections.Counter(base).most_common(12))}
        Path(out_dir, short.replace(",", "_") + Path(info["path"]).parent.name[:6] + ".sass"
             ).write_text(chunk)
    return out


_PREC_CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import numpy as np, torch
from ida_tpu_torch.models import foodweb_ic, foodweb_problem
prob = foodweb_problem(20, 20)
c0, _ = foodweb_ic(20, 20)
rng = np.random.default_rng(5)
scale = np.linspace(0.95, 1.05, 128)
yy = torch.from_numpy(np.outer(c0, scale)).cuda()
cj = torch.from_numpy(1e3 * (1.0 + rng.random(128))).cuda()
pdata = prob.prec_setup(0.0, cj, yy, torch.zeros_like(yy), torch.zeros_like(yy))
r = torch.from_numpy(rng.normal(size=(800, 128))).cuda()
if len(sys.argv) > 2 and sys.argv[2] == "float32":
    # the Krylov "single" path: pdata cast once a Newton loop, as core/nls.py does
    from ida_tpu_torch.core.nls import _cast_floats
    pdata, r, cj = _cast_floats(pdata, torch.float32), r.float(), cj.float()
z = prob.prec_solve(pdata, r, cj)
torch.cuda.synchronize()
calls = 20
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    for _ in range(calls):
        prob.prec_solve(pdata, r, cj)
    torch.cuda.synchronize()
dev = [e for e in prof.key_averages()
       if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]
seen = sum(e.count for e in dev if "solve_kernel" in e.key)
print(json.dumps({"checkout": sys.argv[1], "calls": calls, "calls_recorded": seen,
                  "device_events_per_call": sum(e.count for e in dev) / max(seen, 1),
                  "device_ms_per_call": sum(e.self_device_time_total for e in dev) / 1e3
                  / max(seen, 1),
                  "kernels": {e.key[:80]: e.count / max(seen, 1) for e in dev},
                  "result_sum": float(z.sum())}))
"""


def prec_solve_events(checkout: str, dtype: str = "float64") -> dict:
    """The device events and device time of one ``foodweb.prec_solve`` (20 x
    20, B = 128, on the card) with the port of ``checkout``, from
    torch.profiler in a fresh process, per call (one K1 solve a call, so the
    recorded solves count the calls the profiler saw). ``dtype`` "float32"
    solves with the factors and right-hand side cast as the Krylov "single"
    mode casts them."""
    proc = subprocess.run([sys.executable, "-c", _PREC_CHILD, checkout, dtype], cwd=checkout,
                          capture_output=True, text=True, timeout=900, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"prec_solve in {checkout}: {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def k1_kernel_name(build: str, kernel: str, tag: str, n: int, lanes: int) -> str:
    """The name (a part of it) of the kernel that ``build`` launches for this
    factor, solve or transposed solve."""
    if kernel == "solve_t" or build in ("parent", "first_skeleton"):
        return f"{kernel}_kernel"
    if build == "groups" or small_lu.uses_groups(kernel, tag, n, lanes):
        return f"{kernel}_group_kernel"
    return f"{kernel}_kernel"


def k1_build(names: dict) -> dict:
    """Build ``small_lu.cu`` with each name's flags, all at once."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {k: pool.submit(_build.build_library, "small_lu.cu", K1_HEADERS,
                                  flags=("-fmad=false", *f)) for k, f in names.items()}
        libs = {k: f.result() for k, f in futures.items()}
    for info in libs.values():
        small_lu.bind(info["lib"])
    emit(build_s=time.perf_counter() - t0, builds={k: list(f) for k, f in names.items()})
    return libs


def bind_floor(lib) -> None:
    """Argument types of the floor's entry points (``-DIDA_LU_FLOOR``)."""
    layout = [ctypes.c_int, ctypes.POINTER(small_lu.SolveLayout), ctypes.c_void_p]
    for dt in ("f64", "f32"):
        getattr(lib, f"small_lu_copy_{dt}").argtypes = [ctypes.c_void_p] * 4 + layout
        getattr(lib, f"small_lu_factor_copy_{dt}").argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.small_lu_empty.argtypes = [ctypes.c_int] + layout
    lib.small_lu_factor_empty.argtypes = [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_void_p]


def _ok(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def k1_sweep(libs: dict, device=torch.device("cuda")) -> None:
    """The factor and the solve of the ``parent`` and ``groups`` builds in
    turns (parent, groups, groups, parent) on contiguous [N, N, lanes]
    systems, over SWEEP_N x SWEEP_LANES in both dtypes: each bit for bit its
    plain version, its device time (input sets rotated so that the large
    shapes read HBM; the small ones stay in L2 as a solver's fresh Jacobian
    does) and its bytes bound. One JSON line a shape."""
    default_build = small_lu.build
    try:
        for dtype in (torch.float64, torch.float32):
            tag, es = small_lu.DTYPE_TAGS[dtype], torch.finfo(dtype).bits // 8
            for n in SWEEP_N:
                for lanes in SWEEP_LANES:
                    gen = torch.Generator(device).manual_seed(1000 * n + lanes)
                    eye = 3.0 * torch.eye(n, dtype=dtype, device=device)[:, :, None]
                    a = torch.randn((n, n, lanes), generator=gen, dtype=dtype, device=device) + eye
                    b = torch.randn((n, lanes), generator=gen, dtype=dtype, device=device)
                    nbytes = {"factor": 2 * n * n * lanes * es + (n + 1) * lanes * 4,
                              "solve": n * n * lanes * es + n * lanes * 4 + 2 * n * lanes * es}
                    sets = max(2, min(16, math.ceil(150e6 / nbytes["factor"])))
                    rounds = 4 if lanes <= 8192 else 2
                    g = dense_lu.lu_factor_unrolled(a)
                    want = dense_lu.lu_solve_unrolled(g, b)
                    a_sets = [a.clone() for _ in range(sets)]
                    fb_sets = [(dense_lu.DenseLU(g.lu.clone(), g.piv.clone(), None), b.clone())
                               for _ in range(sets)]
                    ms = {"factor": {"parent": [], "groups": []},
                          "solve": {"parent": [], "groups": []}}
                    ok = True
                    for name in ("parent", "groups", "groups", "parent"):
                        small_lu.build = lambda info=libs[name]: info
                        f, x = small_lu.lu_factor(a), small_lu.lu_solve(g, b)
                        torch.cuda.synchronize()
                        ok = ok and all(torch.equal(u, v) for u, v in (
                            (f.lu, g.lu), (f.piv, g.piv), (f.fail_col, g.fail_col), (x, want)))
                        ms["factor"][name].append(cold_device_ms(
                            [lambda v=v: small_lu.lu_factor(v) for v in a_sets], rounds,
                            k1_kernel_name(name, "factor", tag, n, lanes)))
                        ms["solve"][name].append(cold_device_ms(
                            [lambda h=h, v=v: small_lu.lu_solve(h, v) for h, v in fb_sets], rounds,
                            k1_kernel_name(name, "solve", tag, n, lanes)))
                    emit(sweep="k1", dtype=tag, n=n, lanes=lanes, bitwise_equal=ok,
                         factor_ms=ms["factor"], solve_ms=ms["solve"],
                         factor_bound_ms=nbytes["factor"] / HBM_BYTES_PER_S * 1e3,
                         solve_bound_ms=nbytes["solve"] / HBM_BYTES_PER_S * 1e3,
                         faster={k: min(v, key=lambda name: min(v[name])) for k, v in ms.items()})
                    if not ok:
                        raise SystemExit(f"k1 sweep: a kernel differs from its plain version at "
                                         f"{tag} N={n} lanes={lanes}")
                    del a_sets, fb_sets
                    torch.cuda.empty_cache()
    finally:
        small_lu.build = default_build


def k1_rule(sweeps: dict[str, list[str]]) -> dict:
    """The cells behind the rule ``kGroupRule``, from sweep lines
    (``k1 --sweep`` output), as windows of lane counts:
    ``sweeps`` maps "factor" and "solve" to the files whose lines count for
    that kernel. A (kernel, dtype, N, lanes) is a win for the groups where
    every group time of every file is below every parent time; the window
    of an (kernel, dtype, N) is its longest run of consecutive measured lane
    counts that are wins (the lower on a tie), open above when it reaches
    the largest count measured, and (0, 0) when nothing wins. Returns
    {(kernel, dtype): [(lo, hi) by N - 1]}."""
    times: dict = collections.defaultdict(lambda: {"parent": [], "groups": []})
    for kernel, paths in sweeps.items():
        for path in paths:
            for line in Path(path).read_text().splitlines():
                d = json.loads(line)
                if d.get("sweep") != "k1":
                    continue
                for name, ms in d[f"{kernel}_ms"].items():
                    times[kernel, d["dtype"], d["n"], d["lanes"]][name] += ms
    rule = {}
    for kernel in sweeps:
        for tag in ("f64", "f32"):
            windows = []
            for n in range(1, 17):
                lanes = sorted(k[3] for k in times if k[:3] == (kernel, tag, n))
                wins = [bool(times[kernel, tag, n, b]["groups"])
                        and max(times[kernel, tag, n, b]["groups"])
                        < min(times[kernel, tag, n, b]["parent"]) for b in lanes]
                best, run = (0, 0), None
                for i, w in enumerate(wins + [False]):
                    if w and run is None:
                        run = i
                    elif not w and run is not None:
                        if i - run > best[1] - best[0]:
                            best = (run, i)
                        run = None
                if best == (0, 0):
                    windows.append((0, 0))
                else:
                    hi = small_lu.MAX_LANES if best[1] == len(lanes) else lanes[best[1] - 1]
                    windows.append((lanes[best[0]], hi))
            rule[kernel, tag] = windows
    return rule


def k1_few_lanes(libs: dict, device=torch.device("cuda")) -> dict:
    """The rows of FEW_LANES, f64: the new and the parent build's factor and
    solve in turns (parent, new, new, parent), bit for bit the plain
    versions (``max_abs_err`` the largest difference of either build), each
    with its device time (the row's input sets in turn), its bytes bound,
    its floor (a copy of the same bytes and an empty launch, ``floor``, on
    the grid of the skeleton the new build runs), the plain version's and
    ``torch.linalg``'s time, and each build's registers and spills for the
    kernel it launches. Returns {row: {...}}; ``chip_smoke.py`` reports the
    same rows."""
    lib = libs["floor"]["lib"]
    stream = torch.cuda.current_stream().cuda_stream
    default_build = small_lu.build
    ptxas = {k: _build.ptxas_summary(libs[k]["log"]) for k in ("parent", "new")}
    rows = {}
    for row, (n, lanes, nsets) in FEW_LANES.items():
        rng = np.random.default_rng(n)
        a = torch.from_numpy(rng.normal(size=(n, n, lanes)) + 3.0 * np.eye(n)[:, :, None]).to(device)
        b = torch.from_numpy(rng.normal(size=(n, lanes))).to(device)
        g = dense_lu.lu_factor_unrolled(a)
        want = dense_lu.lu_solve_unrolled(g, b)
        a_sets = [a.clone() for _ in range(nsets)]
        fb_sets = [(dense_lu.DenseLU(g.lu.clone(), g.piv.clone(), None), b.clone())
                   for _ in range(nsets)]
        out = {k: {"ms": {"parent": [], "new": []}, "sets": nsets, "max_abs_err": 0.0}
               for k in ("factor", "solve")}
        ok = True
        try:
            for name in ("parent", "new", "new", "parent"):
                small_lu.build = lambda info=libs[name]: info
                f, x = small_lu.lu_factor(a), small_lu.lu_solve(g, b)
                torch.cuda.synchronize()
                ok = ok and all(torch.equal(u, v) for u, v in (
                    (f.lu, g.lu), (f.piv, g.piv), (f.fail_col, g.fail_col), (x, want)))
                for k, err in (("factor", (f.lu - g.lu).abs().max()), ("solve", (x - want).abs().max())):
                    out[k]["max_abs_err"] = max(out[k]["max_abs_err"], float(err))
                out["factor"]["ms"][name].append(cold_device_ms(
                    [lambda v=v: small_lu.lu_factor(v) for v in a_sets], 4,
                    k1_kernel_name(name, "factor", "f64", n, lanes)))
                out["solve"]["ms"][name].append(cold_device_ms(
                    [lambda h=h, v=v: small_lu.lu_solve(h, v) for h, v in fb_sets], 4,
                    k1_kernel_name(name, "solve", "f64", n, lanes)))
        finally:
            small_lu.build = default_build

        def factor_copy(v):
            lu, piv = torch.empty_like(v), torch.empty((n, lanes), dtype=torch.int32, device=device)
            fail = torch.empty(lanes, dtype=torch.int32, device=device)
            _ok(lib.small_lu_factor_copy_f64(v.data_ptr(), lu.data_ptr(), piv.data_ptr(),
                                             fail.data_ptr(), n, lanes, stream), "factor copy")

        def solve_copy(h, v):
            x = torch.empty_like(v)
            layout = small_lu.solve_layout(h.lu, h.piv, v, x)
            _ok(lib.small_lu_copy_f64(h.lu.data_ptr(), h.piv.data_ptr(), v.data_ptr(), x.data_ptr(),
                                      n, ctypes.byref(layout), stream), "solve copy")

        layout = small_lu.solve_layout(g.lu, g.piv, b, torch.empty_like(b))
        grid = {k: "_group" if small_lu.uses_groups(k, "f64", n, lanes) else ""
                for k in ("factor", "solve")}
        out["factor"].update(
            floor_copy_ms=cold_device_ms([lambda v=v: factor_copy(v) for v in a_sets], 4,
                                         f"factor_copy{grid['factor']}_kernel"),
            floor_empty_ms=cold_device_ms(
                [lambda: _ok(lib.small_lu_factor_empty(n, 0, lanes, stream), "empty")] * 64, 4,
                "empty_kernel"),
            bound_ms=(2 * n * n * lanes * 8 + (n + 1) * lanes * 4) / HBM_BYTES_PER_S * 1e3)
        out["solve"].update(
            floor_copy_ms=cold_device_ms([lambda h=h, v=v: solve_copy(h, v) for h, v in fb_sets],
                                         4, f"copy{grid['solve']}_kernel"),
            floor_empty_ms=cold_device_ms(
                [lambda: _ok(lib.small_lu_empty(n, 0, ctypes.byref(layout), stream), "empty")] * 64,
                4, "empty_kernel"),
            bound_ms=(n * n * lanes * 8 + n * lanes * 4 + 2 * n * lanes * 8)
            / HBM_BYTES_PER_S * 1e3)
        lead = [(v.permute(2, 0, 1).contiguous(), w.t().contiguous().unsqueeze(-1))
                for v, (_, w) in zip(a_sets, fb_sets)]
        f_lead = [torch.linalg.lu_factor_ex(v)[:2] for v, _ in lead]
        out["factor"]["library_ms"] = cold_device_ms(
            [lambda v=v: torch.linalg.lu_factor_ex(v) for v, _ in lead], 4)
        out["solve"]["library_ms"] = cold_device_ms(
            [lambda h=h, w=w: torch.linalg.lu_solve(h[0], h[1], w)
             for h, (_, w) in zip(f_lead, lead)], 4)
        out["factor"]["plain_ms"] = statistics.median(
            event_ms(lambda: dense_lu.lu_factor_unrolled(a)) for _ in range(5))
        out["solve"]["plain_ms"] = statistics.median(
            event_ms(lambda: dense_lu.lu_solve_unrolled(g, b)) for _ in range(5))
        for k in ("factor", "solve"):
            out[k]["skeleton_new"] = k1_kernel_name("new", k, "f64", n, lanes)
            out[k]["ptxas"] = {
                name: {_short(key): v for key, v in ptxas[name].items()
                       if _short(key).split(",")[:3]
                       == [k1_kernel_name(name, k, "f64", n, lanes), "d", str(n)]}
                for name in ("parent", "new")}
        rows[row] = {"n": n, "lanes": lanes, "dtype": "f64", "bitwise_equal": ok, **out}
    return rows


def k1_solve_t_rows(device=torch.device("cuda")) -> None:
    """``small_lu_solve_t`` as shipped on few lanes: SOLVE_T_N x
    SOLVE_T_LANES in float64 on contiguous systems, each bit for bit its plain
    version, its cold device time (64 input sets rotated) beside its bytes
    bound (lu, piv and g read once, the result written once), the device
    time of the plain version's kernels a call, and that of
    ``torch.linalg.lu_solve(..., adjoint=True)`` on the same systems in the
    library's batch-leading layout. One JSON line a shape."""
    for n in SOLVE_T_N:
        for lanes in SOLVE_T_LANES:
            gen = torch.Generator(device).manual_seed(7000 + 100 * n + lanes)
            eye = 3.0 * torch.eye(n, dtype=torch.float64, device=device)[:, :, None]
            a = torch.randn((n, n, lanes), generator=gen, dtype=torch.float64, device=device) + eye
            g = torch.randn((n, lanes), generator=gen, dtype=torch.float64, device=device)
            f = small_lu.lu_factor(a)
            got, want = small_lu.lu_solve_t(f, g), dense_lu.lu_solve_unrolled_t(f, g)
            torch.cuda.synchronize()
            sets = [(dense_lu.DenseLU(f.lu.clone(), f.piv.clone(), None), g.clone())
                    for _ in range(64)]
            ms = cold_device_ms([lambda h=h, v=v: small_lu.lu_solve_t(h, v) for h, v in sets], 4,
                                "solve_t_kernel")
            plain_ms = cold_device_ms([lambda h=h, v=v: dense_lu.lu_solve_unrolled_t(h, v)
                                       for h, v in sets[:8]], 4)
            lead = [(h.lu.permute(2, 0, 1).contiguous(), h.piv.t().contiguous() + 1,
                     v.t().contiguous().unsqueeze(-1)) for h, v in sets]
            lib_ms = cold_device_ms([lambda x=x: torch.linalg.lu_solve(x[0], x[1], x[2],
                                                                        adjoint=True)
                                     for x in lead], 4)
            nbytes = n * n * lanes * 8 + n * lanes * 4 + 2 * n * lanes * 8
            emit(solve_t="k1", dtype="f64", n=n, lanes=lanes,
                 bitwise_equal=bool(torch.equal(got, want)), ms=ms, plain_ms=plain_ms,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=lib_ms,
                 bytes=nbytes)
            if not torch.equal(got, want):
                raise SystemExit(f"k1 solve_t: the kernel differs from its plain version at "
                                 f"N={n} lanes={lanes}")


def k1_main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants k1 needs an NVIDIA GPU")
    parent, sweep, solve_t = None, False, False
    while argv[:1] in (["--parent"], ["--sweep"], ["--solve-t"]):
        if argv[0] == "--sweep":
            sweep, argv = True, argv[1:]
        elif argv[0] == "--solve-t":
            solve_t, argv = True, argv[1:]
        else:
            parent, argv = argv[1], argv[2:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    mode = "k1 --sweep" if sweep else "k1 --solve-t" if solve_t else "k1"
    emit(card=smi, torch=torch.__version__, mode=mode)
    if solve_t:
        k1_solve_t_rows()
        return
    if sweep:
        libs = k1_build({k: K1_VARIANTS[k] for k in ("parent", "groups")})
        k1_sweep(libs)
        emit(ptxas={k: k1_ptxas(libs[k]["log"]) for k in libs},
             sass={k: k1_sass(info) for k, info in libs.items()})
        k1_solve_t_rows()
        return
    chosen = {k: v for k, v in K1_VARIANTS.items()
              if not argv or k in argv or k in ("parent", "new")}
    libs = k1_build({**chosen, "floor": K1_FLOOR})
    emit(ptxas={k: k1_ptxas(libs[k]["log"]) for k in ("parent", "new")})

    device = torch.device("cuda")
    shapes = k1_shapes(device)
    plain = {"solve": dense_lu.lu_solve_unrolled, "solve_t": dense_lu.lu_solve_unrolled_t}
    default_build = small_lu.build
    names = list(chosen)
    try:
        for rnd in range(2):
            for name in names if rnd == 0 else names[::-1]:
                small_lu.build = lambda info=libs[name]: info
                row = {}
                for shape, (kernel, sets, rounds) in shapes.items():
                    launch = small_lu.lu_solve if kernel == "solve" else small_lu.lu_solve_t
                    f, b = sets[0]
                    x = launch(f, b)
                    torch.cuda.synchronize()
                    bound = k1_bytes(f, b) / HBM_BYTES_PER_S * 1e3
                    tag, lanes = small_lu.DTYPE_TAGS[b.dtype], math.prod(b.shape[1:])
                    ms = cold_device_ms([lambda f=f, b=b: launch(f, b) for f, b in sets], rounds,
                                        k1_kernel_name(name, kernel, tag, b.shape[0], lanes))
                    row[shape] = {"ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
                                  "bitwise_equal": bool(torch.equal(x, plain[kernel](f, b))),
                                  "result_strides": list(x.stride())}
                emit(variant=name, round=rnd, flags=list(K1_VARIANTS[name]), **row)
                if not all(v["bitwise_equal"] for v in row.values()):
                    raise SystemExit(f"{name}: a solve differs from its plain version")
    finally:
        small_lu.build = default_build

    # the floor of the N = 2 and the float32 bytes: the same bytes moved by
    # the new skeleton with no arithmetic, and an empty launch on its grid
    lib = libs["floor"]["lib"]
    bind_floor(lib)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in ("n2_contiguous", "n2_pdata", "n2_prec_solve", "n3_f32", "n2_prec_solve_f32"):
        _, sets, rounds = shapes[shape]
        f, b = sets[0]
        n, tag = b.shape[0], small_lu.DTYPE_TAGS[b.dtype]
        copy_fn = getattr(lib, f"small_lu_copy_{tag}")

        def copy(f, b, copy_fn=copy_fn, n=n):
            x = torch.empty_like(b)
            layout = small_lu.solve_layout(f.lu, f.piv, b, x)
            _ok(copy_fn(f.lu.data_ptr(), f.piv.data_ptr(), b.data_ptr(), x.data_ptr(), n,
                        ctypes.byref(layout), stream), "small_lu_copy")
            return x

        layout = small_lu.solve_layout(f.lu, f.piv, b, torch.empty_like(b))

        def empty(layout=layout, n=n, f32=int(tag == "f32")):
            _ok(lib.small_lu_empty(n, f32, ctypes.byref(layout), stream), "small_lu_empty")

        x = copy(f, b)
        torch.cuda.synchronize()
        bound = k1_bytes(f, b) / HBM_BYTES_PER_S * 1e3
        copy_ms = cold_device_ms([lambda f=f, b=b: copy(f, b) for f, b in sets], rounds,
                                 "copy_kernel")
        empty_ms = cold_device_ms([empty] * len(sets), rounds, "empty_kernel")
        emit(floor=shape, copy_ms=copy_ms, empty_ms=empty_ms, bound_ms=bound,
             copy_share_of_bound=bound / copy_ms, copy_is_rhs=bool(torch.equal(x, b)),
             layout=k1_layout(f, b))

    for row, out in k1_few_lanes(libs).items():
        emit(few_lanes=row, **out)
        if not out["bitwise_equal"]:
            raise SystemExit(f"k1 {row}: a kernel differs from its plain version")

    if parent is not None:
        for checkout in (parent, ".", ".", parent):
            emit(**prec_solve_events(checkout))


if __name__ == "__main__":
    if sys.argv[1:2] == ["k1"]:
        k1_main(sys.argv[2:])
    else:
        main(sys.argv[1:])
