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

**K1** (``k1``): the skeletons of the LU solves of ``csrc/small_lu.cu``.
Builds the shipped source as it is (``new``), at the first skeleton's
settings (``parent``: ``-DIDA_LU_VEC=0``: one lane a thread, 128-thread
blocks, scalar accesses, over the strided addressing) and at the other
candidates of ``K1_VARIANTS``,
plus ``-DIDA_LU_FLOOR`` (the floor kernels). For each build in turn (parent,
new, the others, then the same backwards: old, new, new, old) it holds the
solves bit for bit against their plain versions and takes their cold device
time (torch.profiler, the input sets rotated so that every launch reads HBM,
as ``chip_smoke.py`` does) on: the N = 2 solve at [2, 2, 400, 128] (the
foodweb preconditioner's blocks at B = 128) contiguous, in ``ida_tpu``'s
pdata layout, and in the layout ``foodweb.prec_solve`` hands it; the N = 3
solve and ``small_lu_solve_t`` at B = 65,536; the N = 6 solve at B = 1,024
(the continuous adjoint's KKT system). Then the floor of those N = 2 bytes
(a copy in the new skeleton and an empty launch on its grid), the N = 6
factor's row (kernel, plain version, ``torch.linalg``) and, with ``--parent
DIR`` (a checkout of the parent commit), the device events and device time
of one ``foodweb.prec_solve`` at 20 x 20, B = 128 in DIR and here, in turns
(parent, new, new, parent), one process each.

    python3 -m ida_tpu_torch.tools.kernel_variants k1 [--parent DIR] [VARIANT ...]
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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


# ---------------------------------------------------------------- K1 mode

# name -> -D flags of csrc/small_lu.cu (``new`` is the shipped build)
K1_VARIANTS = {
    "parent": ("-DIDA_LU_VEC=0",),
    "new": (),
    "pairs_t128": ("-DIDA_LU_THREADS=128",),
}
K1_HEADERS = ("small_lu.cuh", "rounded.cuh")
FOOD_NPTS, FOOD_B = 400, 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, 700 W


def cold_device_ms(fns, rounds: int, name_part: str | None = None) -> float:
    """Device time per launch of the kernels whose name holds ``name_part``
    over ``rounds`` passes through ``fns`` (after a warm-up pass), from
    torch.profiler, averaged over the launches it recorded: chip_smoke.py's
    protocol. With no ``name_part``, the device time of everything the calls
    ran per call (a library call may run several kernels). A short spin heads
    the window (the profiler was seen to drop a window's first activity)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(rounds):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]
    if name_part is None:
        return sum(e.self_device_time_total for e in on_card) / 1e3 / (rounds * len(fns))
    picked = [e for e in on_card if name_part in e.key]
    count = sum(e.count for e in picked)
    if count == 0:
        raise RuntimeError(f"the profiler recorded no device time for {name_part}")
    return sum(e.self_device_time_total for e in picked) / 1e3 / count


def k1_shapes(device) -> dict:
    """name -> (kernel, sets of (factors, right-hand side), profiler rounds):
    the solves' shapes, 64 sets at N = 2 (~240 MB a pass), 16 at N = 3
    (~140 MB) and 320 at N = 6 (~130 MB), each over the 50 MB of L2, so
    every launch reads HBM."""
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

    return {
        "n2_contiguous": ("solve", sets(f2, b2, 64), 2),
        "n2_pdata": ("solve", sets(pdata, r2, 64), 2),
        "n2_prec_solve": ("solve", sets(f2, r2, 64), 2),
        "n3": ("solve", sets(f3, b3, 16), 4),
        "n3_solve_t": ("solve_t", sets(f3, b3, 16), 4),
        "n6": ("solve", sets(f6, b6, 320), 2),
    }


def k1_bytes(f: dense_lu.DenseLU, b: torch.Tensor) -> int:
    """lu, piv and b read once, x written once."""
    return (f.lu.numel() * f.lu.element_size() + f.piv.numel() * 4
            + 2 * b.numel() * b.element_size())


def k1_layout(f, b) -> dict:
    return small_lu.solve_layout(f.lu, f.piv, b, torch.empty_like(b)).as_dict()


def k1_ptxas(log: str) -> dict:
    """Registers and spills of the solves at N = 2, 3, 6, and spill store
    bytes of every kernel that spills, by (kernel, type, N[, lanes])."""
    def short(name):
        m = re.search(r"(solve_t_kernel|solve_kernel|factor_kernel)I([df])Li(\d+)E(?:Li(\d+)E)?",
                      name)
        return ",".join(g for g in m.groups() if g) if m else name

    summary = _build.ptxas_summary(log)
    return {"solves_n2_3_6": {short(k): v for k, v in summary.items()
                              if "solve" in k and any(f"Li{n}E" in k for n in (2, 3, 6))},
            "spill_stores": {short(k): v["spill_stores"] for k, v in summary.items()
                             if v.get("spill_stores", 0) > 0}}


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


def k1_main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants k1 needs an NVIDIA GPU")
    parent = None
    if argv[:1] == ["--parent"]:
        parent, argv = argv[1], argv[2:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit(card=smi, torch=torch.__version__, mode="k1")
    chosen = {k: v for k, v in K1_VARIANTS.items()
              if not argv or k in argv or k in ("parent", "new")}
    builds = {**{k: ("-fmad=false", *v) for k, v in chosen.items()},
              "floor": ("-fmad=false", "-DIDA_LU_FLOOR")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {k: pool.submit(_build.build_library, "small_lu.cu", K1_HEADERS, flags=f)
                   for k, f in builds.items()}
        libs = {k: f.result() for k, f in futures.items()}
    emit(build_s=time.perf_counter() - t0,
         ptxas={k: k1_ptxas(libs[k]["log"]) for k in ("parent", "new")})
    for info in libs.values():
        small_lu.bind(info["lib"])

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
                    ms = cold_device_ms([lambda f=f, b=b: launch(f, b) for f, b in sets], rounds,
                                        f"{kernel}_kernel")
                    row[shape] = {"ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
                                  "bitwise_equal": bool(torch.equal(x, plain[kernel](f, b))),
                                  "result_strides": list(x.stride())}
                emit(variant=name, round=rnd, flags=list(builds[name]), **row)
                if not all(v["bitwise_equal"] for v in row.values()):
                    raise SystemExit(f"{name}: a solve differs from its plain version")
    finally:
        small_lu.build = default_build

    # the floor of the N = 2 bytes: the same bytes moved by the new skeleton
    # with no arithmetic, and an empty launch on the grid of the solve
    lib = libs["floor"]["lib"]
    lib.small_lu_copy_f64.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.POINTER(small_lu.SolveLayout), ctypes.c_void_p]
    lib.small_lu_copy_f64.restype = ctypes.c_int
    lib.small_lu_empty.argtypes = [ctypes.POINTER(small_lu.SolveLayout), ctypes.c_void_p]
    lib.small_lu_empty.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for shape in ("n2_contiguous", "n2_pdata", "n2_prec_solve"):
        _, sets, rounds = shapes[shape]

        def copy(f, b):
            x = torch.empty_like(b)
            layout = small_lu.solve_layout(f.lu, f.piv, b, x)
            err = lib.small_lu_copy_f64(f.lu.data_ptr(), f.piv.data_ptr(), b.data_ptr(),
                                        x.data_ptr(), 2, ctypes.byref(layout), stream)
            if err:
                raise RuntimeError(f"small_lu_copy_f64: CUDA error {err}")
            return x

        f, b = sets[0]
        layout = small_lu.solve_layout(f.lu, f.piv, b, torch.empty_like(b))

        def empty(layout=layout):
            if lib.small_lu_empty(ctypes.byref(layout), stream):
                raise RuntimeError("small_lu_empty failed")

        x = copy(f, b)
        torch.cuda.synchronize()
        bound = k1_bytes(f, b) / HBM_BYTES_PER_S * 1e3
        copy_ms = cold_device_ms([lambda f=f, b=b: copy(f, b) for f, b in sets], rounds,
                                 "copy_kernel")
        empty_ms = cold_device_ms([empty] * len(sets), rounds, "empty_kernel")
        emit(floor=shape, copy_ms=copy_ms, empty_ms=empty_ms, bound_ms=bound,
             copy_share_of_bound=bound / copy_ms, copy_is_rhs=bool(torch.equal(x, b)),
             layout=k1_layout(f, b))

    # the K1 row at N = 6 (the continuous adjoint's KKT factor and solve)
    _, sets6, _ = shapes["n6"]
    a6 = [s[0].lu.clone() for s in sets6]  # any matrices of the shape: the factor reads them
    f, b = sets6[0]
    lead = [(a.permute(2, 0, 1).contiguous(), y.t().contiguous().unsqueeze(-1))
            for a, (_, y) in zip(a6, sets6)]
    f_lead = [torch.linalg.lu_factor_ex(a)[:2] for a, _ in lead]
    factor_bytes = a6[0].numel() * 8 * 2 + 6 * 1024 * 4 + 1024 * 4
    emit(n6={
        "factor_ms": cold_device_ms([lambda a=a: small_lu.lu_factor(a) for a in a6], 4,
                                    "factor_kernel"),
        "factor_bound_ms": factor_bytes / HBM_BYTES_PER_S * 1e3,
        "factor_plain_ms": statistics.median(
            event_ms(lambda: dense_lu.lu_factor_unrolled(a6[0])) for _ in range(5)),
        "factor_library_ms": cold_device_ms([lambda a=a: torch.linalg.lu_factor_ex(a)
                                             for a, _ in lead], 4),
        "solve_plain_ms": statistics.median(
            event_ms(lambda: dense_lu.lu_solve_unrolled(f, b)) for _ in range(5)),
        "solve_library_ms": cold_device_ms(
            [lambda h=h, y=y: torch.linalg.lu_solve(h[0], h[1], y)
             for h, (_, y) in zip(f_lead, lead)], 4),
    })

    if parent is not None:
        for checkout in (parent, ".", ".", parent):
            emit(**prec_solve_events(checkout))


if __name__ == "__main__":
    if sys.argv[1:2] == ["k1"]:
        k1_main(sys.argv[2:])
    else:
        main(sys.argv[1:])
