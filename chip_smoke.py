"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from this checkout (the batched small-N LU,
``csrc/small_lu.cu``, and the whole-solve kernel, ``csrc/fused_solve.cu``,
in parallel), holds each against its plain PyTorch version on the card, and
drives both paths of the batched Roberts ensemble (B=65,536 lanes to
tout=400 in f64):

* the eager path, ``ensemble_init`` + ``make_ensemble_solve`` (LU kernels);
* the fused path, ``ensemble_init`` + ``make_fused_solve`` (one kernel per
  solve, reading the batch-leading state in place and writing a new one, or
  the budgeted kernel and its continuation), bit for bit against the eager
  path's result from the same run, in f64 and (counters) f32; its line also
  gives the solve kernel's registers, stack, spills, shared memory,
  occupancy and waves, the device events of one call, and how unevenly the
  lanes of a warp work;
* the canonical Roberts acceptance lane through both;
* rootfinding at the same width (``roots_slice``: ``EnsembleIDA`` with roots
  on, re-entered after its ROOT_RETURNs, 256 lanes against a CPU run);
* dense output (``dense_slice``: one ``solve_dense`` over 12 decades at
  B=65,536, its rows bit for bit 12 chained launches of the whole-solve
  kernel; ``dense_events``: the event buffer against the re-entry form);
* the user surface (``user_surface``: ``IDA`` over 12 decades with roots
  against the pinned idaRoberts_dns counters, ``solve_dae``, ``EnsembleIDA``
  against the harness, ``report_failures``);
* the Krylov path at the published widths of BASELINE configs 4 and 5:
  heat2d 100 x 100 through ``IDA`` (SPGMR, diagonal preconditioner) against
  the port's CPU run of the same solve (``heat2d_spgmr``), 64 heat2d lanes
  batch-native (``heat2d_batched``), foodweb 20 x 20 through ``IDA.calc_ic``
  and four legs (``foodweb``), 128 foodweb lanes through batch-native
  ``calc_ic`` and the legs (``foodweb_batched``), with the LU kernel's
  launches counted on both foodweb paths and the kernel held against its
  plain version at N = 2 on the foodweb blocks, on the three layouts it
  reads there, with one ``prec_solve`` shown to run that one kernel and no
  copy (``kernel_n2_foodweb_blocks``);
* inequality constraints: the stage kernels on constrained mid-flight
  states (``constrained_stages``), and the headline's lanes held >= 0 at
  rtol 1e-2 over 12 decades through the eager solve, the whole-solve kernel
  and its budgeted form, bit for bit at every output, with the nominal
  lane's pinned counters (``constrained_headline``);
* quadratures on the headline (``quadrature_headline``), and the headline
  saved at 0.4, loaded back and solved on, bit for bit the uninterrupted
  solve (``checkpoint_resume``);
* sensitivities (``ida_tpu_torch.sensitivity``): the transposed-solve
  kernel against its plain version (``kernels_t``); bench.py's
  adjoint_batched, per-lane gradients of 4,096 Roberts lanes through the
  eager solve (K1 forward, ``small_lu_solve_t`` backward), against the CPU
  and central differences, with ``remat_attempts`` and under ``safe_ad``
  (``adjoint_batched``); its adjoint_continuous at 1,024 lanes against the
  discrete gradients, its KKT solves at N = 6 on K1's group skeleton and
  16 lanes bit for bit K1's parent dispatch (``adjoint_continuous``);
  forward sensitivities, the
  Hessian-vector product and the gradient through ``calc_ic`` on one lane
  against differences (``sensitivity_lane``);
* the band solver on heat2d 10 x 10 (idaHeat2D_bnd) through ``IDA`` and at
  B = 4,096, with one band factor and solve at 100 x 100 timed
  (``band_heat2d``, ``band_factor_solve``), and SPGMR with the BBD
  preconditioner on heat2d 20 x 20 in 4 blocks, one lane and B = 256
  (``bbd_heat2d``);
* the non-parity modes and the rest of the surface: K1 at the later
  paths' shapes against its plain version (float32 N = 3, the float32 N = 2
  solve in the Krylov "single" layout; float64 N = 10 on one lane and N = 6
  on 1,024, each on the skeleton the rule names, timed in turns with the
  parent's dispatch, one thread a lane, built beside it, with its floor:
  ``kernels_modes``); the
  headline under ``ls_precision`` "single" and "refined", K1's float32
  launches counted, two lanes against the CPU counter for counter
  (``mixed_headline``); the headline with ``fast_math`` timed in turns with
  parity, every lane within tolerance of it (``fast_f64``); heat2d 100 x
  100 under "single" with CGS2, with a bfloat16 basis and at B = 128
  (``heat2d_mixed``); foodweb 20 x 20, B = 128, under "single"
  (``foodweb_mixed``); the slider-crank example, K1 at N = 10 on the group
  skeleton, its first output bit for bit the parent dispatch's
  (``slider_crank``); the stratified solve over two decades of rates, bit
  for bit the plain one (``stratified``); the headline's first decades
  under ``utils.profiling.profile``, each ``ida.<name>`` scope's host and
  device ms, and what the scopes cost (``profile_scopes``);
* the whole-solve kernel in every non-parity mode (``fused_modes``):
  ``fast_math``, ``ls_precision`` "single" and "refined" and their
  combinations, K2 and budget 32 (K3 + K4) at the headline, each bit for bit
  the eager solve of the same mode from ``mixed_headline``/``fast_f64``,
  with a float32-state leg at B = 4,096; each mode's registers, spills,
  bare-launch time against parity's in turns, and its bound;
* generated models in the whole-solve kernel (``fused_models``,
  ``ops/fused_model.py``): the table of ops (each model's ``res``, ``jac``
  and J v through its evaluation kernel, bit for bit the eager problem's
  on 4,096 random lanes, f64 and f32); the headline through a generated
  Roberts, bit for bit the hand-written library and the eager path;
  Akzo Nobel (N = 6) at B = 65,536 to t = 180 and Lorenz '63 at B = 4,096,
  K2 and budget 32 (K3 + K4) bit for bit the eager solve (Akzo also
  "refined" and in float32), Akzo's nominal lane against the eager port's
  rtol 1e-10 run on the CPU; each library's registers, spills and bare
  launch; ``python3 chip_smoke.py fused_models`` runs it alone;
* quadratures and the new ops in the whole-solve kernel
  (``fused_quad_ops``): the quadrature headline through K2 and budget 32
  bit for bit the eager ``quadrature_headline`` (``yQ`` included,
  ``get_quad`` on one lane), "refined" and float32 at B = 4,096;
  Morris-Lecar (tanh, cosh, two quadratures) at B = 65,536 over the applied
  current to 10 ms, K2, budget 32 and "refined" bit for bit the eager
  solve, its nominal lane against the eager port's rtol 1e-10 run on the
  CPU; the table of ops with a zoo of every new op on NaN/+-0/+-inf lanes;
  the hand-written Roberts library still 234 registers;
  ``python3 chip_smoke.py fused_quad_ops`` runs it alone;
* the band and Krylov solvers in the whole-solve kernel (``fused_linear``,
  a library a solver, mode and model, ``ops.fused_solve.mode_flags``): the
  headline (B = 65,536) under band mu = ml = 2 and spgmr to 400 and band
  mu = ml = 1 to 0.4, K2 and budget 32 (K3 + K4) bit for bit the eager
  solve under the same options (the band factor and the Krylov counters
  among the fields), every lane SUCCESS, the canonical lane through K2 to
  4e10 (check_ans under the exact band); at B = 4,096 band and spgmr
  "single", a bfloat16 basis, CGS2, ``fast_math`` under each, a float32
  state under each and Morris-Lecar under band (1, 1) and spgmr to 10 ms,
  each bit for bit its eager solve; each library's registers, spills,
  bare K2 launch, K3/K4 launches and bound; ``python3 chip_smoke.py
  fused_linear`` runs it alone;
* the mesh (``mesh``, ``parallel/mesh.py``): the headline through
  ``EnsembleIDA(mesh=make_mesh(1))`` under NCCL, bit for bit the eager
  solve with K1's launch counts, and K2 on the rank's shard bit for bit the
  unsharded K2; two gloo ranks on the one card (spawned, loading the
  kernels built here): the headline's lanes split 32,768 a rank, each bit
  for bit its per-shard and the unsharded solve, no collective inside a
  rank's solve; heat2d m = 16 (SPGMR) and its BBD-blocked twin with the
  state vector over the ranks, bit for bit the one-rank runs, with the
  collectives and bytes a solve; the 20 x 20 food web with its state over
  the two ranks (``sharded_calc_ic`` then the four legs, the block-diagonal
  preconditioner on each rank's 200 grid points: K1 at N = 2 on its shard,
  held against its plain version there), again with constraints, a root
  function and a quadrature, and under ``ls_precision="single"``, each bit
  for bit the one-rank run in this process; with more than one card, NCCL
  with one rank a card on the headline, heat2d and the food web (else a
  line says it did not run).

Every stage kernel is checked bit for bit against its eager stage on real
mid-flight states first, so a parity break is localized. It prints one JSON
line per phase; any failed check raises, so the exit code is non-zero.

    python3 chip_smoke.py
    python3 chip_smoke.py mesh   # the build, slice, foodweb and mesh phases alone
    python3 chip_smoke.py fused_models   # its libraries, the slice and fused_models alone
    python3 chip_smoke.py fused_quad_ops   # its libraries, the slice, the quadrature
                                           # headline, the table of ops and fused_quad_ops
    python3 chip_smoke.py fused_linear     # its libraries and fused_linear alone

The last three lines are the kernels' summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import multiprocessing
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ida_tpu_torch import IDA, IdaProblem, IdaSolveStatus, sensitivity, solve_dae
from ida_tpu_torch import constants as C
from ida_tpu_torch.core import root as core_root
from ida_tpu_torch.core.solve import TASK_ONE_STEP, solve_dense
from ida_tpu_torch.core.solve import solve as core_solve
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.core.calc_ic import IC_YA_YDP_INIT
from ida_tpu_torch.core.calc_ic import calc_ic as core_calc_ic
from ida_tpu_torch.core.quad import get_quad
from ida_tpu_torch.models import (ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0, foodweb,
                                  foodweb_ic, foodweb_problem, heat2d_ic, heat2d_problem,
                                  roberts_factory, roberts_problem, slider_crank_ic,
                                  slider_crank_problem)
from ida_tpu_torch.models.morris_lecar import (I_NOMINAL, morris_lecar_factory,
                                               morris_lecar_inputs)
from ida_tpu_torch.ops import (_build, dense_lu, fused_model, fused_solve, fused_stages,
                               make_bbd_prec, small_lu)
from ida_tpu_torch.ops.banded import band_factor, band_solve, band_sys_jacobian, band_to_dense
from ida_tpu_torch.tools import kernel_variants
from ida_tpu_torch.parallel import (EnsembleIDA, ensemble_init, from_native, make_ensemble_solve,
                                    make_stratified_solve, pilot_cost, to_native)
from ida_tpu_torch.parallel import mesh as mesh_lib
from ida_tpu_torch.parallel.batch import _native_shared_tol
from ida_tpu_torch.tol_control import TolControl, tol_ss, tol_sv
from ida_tpu_torch.utils.ad_mode import safe_ad
from ida_tpu_torch.utils import profiling, sharding
from ida_tpu_torch.utils.checkpoint import load_state, save_state

BLOCK = 64  # threads a block of the whole-solve kernel (csrc/ida_lane.cuh IDA_THREADS)

B = 65536
B_SMALL = 4096
TOUT = 400.0
ATOL = [1e-8, 1e-6, 1e-6]
CANONICAL_NST = [29, 43, 68, 95, 126, 161, 202, 250, 293, 325, 348, 362]
CANONICAL_TOTALS = {"nst": 362, "nre": 537, "nje": 60, "nni": 537, "netf": 15, "ncfn": 0}
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn")
DECADES = [0.4 * 10**k for k in range(12)]
# SUNDIALS idaRoberts_dns with its two root functions, as tests/test_roberts_e2e.py
# and tests/test_root_oracle.py pin it: the counters exactly, the root times
# to the tolerances given there
ROOTED_TOTALS = {**CANONICAL_TOTALS, "nge": 404}
ROOT_EVENTS = [(2.6402e-01, 1e-3, [0, 1]), (2.0788e7, 1e-2, [-1, 0])]
ROOTS_PROFILE_TOUT = 0.4  # roots_slice's profiled windows: the first decade, root (0.22-0.32)
CHECK_ANS = [5.2083474251394888e-08, 2.0833390772616859e-13, 9.9999994791631752e-01]
LU_SOURCE = "ida_tpu_torch/csrc/small_lu.cu"
LU_REPLACES = "ida_tpu/ops/pallas_lu.py:28"
FUSED_SOURCE = "ida_tpu_torch/csrc/fused_solve.cu"
REPLACES = {
    "fused_solve": "ida_tpu/ops/fused_solve.py:200",
    "fused_solve_init": "ida_tpu/ops/fused_solve.py:396",
    "fused_solve_cont": "ida_tpu/ops/fused_solve.py:429",
    "stage": "scripts/bisect_fused.py:154",
}
# the whole-solve kernel's non-parity modes (fused_modes), by
# fused_solve.mode_name
FUSED_MODES = {
    "single": IdaOptions(ls_precision="single"),
    "refined": IdaOptions(ls_precision="refined"),
    "fast_math": IdaOptions(fast_math=True),
    "fast_math_single": IdaOptions(fast_math=True, ls_precision="single"),
    "fast_math_refined": IdaOptions(fast_math=True, ls_precision="refined"),
}
B_MODES_F32 = 4096
MODES_F32_TOUT = 0.4  # the float32 legs of fused_modes: the first decade
# the card's peaks (NVIDIA H100 SXM data sheet, 700 W): memory 3.35 TB/s;
# float64 outside the tensor cores 34 TFLOP/s, float32 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
# floating-point operations the solve must do per event at N = 3, counted by
# hand from ida_tpu_torch/csrc/ida_lane.cuh (a division as one operation,
# pow and sqrt as 20 each): an attempt (set_coeffs' sums, cj and ck 8, tn 1,
# predict 66, cjratio, the predictor residual and yy/yp 22, error_test's
# three norms and estimates 103), a Newton iteration (LU solve 15, scale and
# ycor 6, norm 29, tests 2), each iteration after a solve's first (rate with
# pow 24, and the residual that fed it 21), an lsetup (Jacobian 9, LU factor
# 16), a completed step (complete_step 78, stop test 2, preamble with ewt
# and norm 39). Work whose amount the counters do not give is left out, so
# the bound is a little low: the rows 1..kk of set_coeffs' recurrences (8 a
# row, only on attempts that change the step size or order), its phi
# scaling, and complete_step's phi rows above the first two.
OPS_PER = {"attempt": 200, "newton": 52, "newton_more": 45, "lsetup": 25, "step": 119}
# of those, the LU's: a solve 15 (a Newton iteration) and a factor 16 (an
# lsetup), in float32 under ls_precision "single" and "refined"; "refined"
# adds a Newton iteration a second float32 solve (15), the residual's jvp
# (17), w = cj x0 and b - J x0 (6) and x0 + dx (3)
OPS_LU = {"solve": 15, "factor": 16}
OPS_REFINED_EXTRA = 26


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` back-to-back calls
    (after one warm-up call unless ``warm`` is False)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def first_device_activity() -> None:
    """A short spin kernel at the head of a profiler window: the profiler
    was seen to drop the first device activity of a window, which must not
    be one of those measured. :func:`on_card_events` leaves it out."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def on_card_events(prof) -> list:
    return device_activities(prof.key_averages())


def device_activities(averages) -> list:
    """The device activities among a profiler window's ``key_averages()``:
    the kernels, copies and fills, not the spin kernel, and not the
    ``ida.<name>`` scopes, which the profiler also lays on the device's
    timeline (``utils/profiling.py``) as ranges spanning the kernels they
    launch."""
    return [e for e in averages
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.key and not e.key.startswith("ida.")
            and not getattr(e, "is_user_annotation", False)]


# (name, launches the profiler recorded, launches made) of every
# kernel_device_ms window: late in a long run the profiler was seen to
# record only some of a window's launches
PROFILER_COUNTS = []


def kernel_device_ms(fns, rounds: int, name_part: str) -> float:
    """Device time per launch of the kernels whose name holds ``name_part``,
    from torch.profiler, over ``rounds`` passes through ``fns`` (one launch
    each, after a warm-up pass), averaged over the launches the profiler
    recorded. Raises when it records none."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    total, count = 0.0, 0
    for _ in range(3):  # a window that recorded nothing is taken again
        with torch.profiler.profile(activities=acts) as prof:
            first_device_activity()
            for _ in range(rounds):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            dev = getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0.0))
            if name_part in evt.key and dev > 0:
                total += dev
                count += evt.count
        PROFILER_COUNTS.append((name_part, count, rounds * len(fns)))
        if count:
            break
    check(count > 0, f"the profiler recorded no device time for {name_part}")
    return total / 1e3 / count


def call_device_ms(fns, rounds: int) -> float:
    """Device time per call of everything the calls of ``fns`` ran on the
    card, from torch.profiler, over ``rounds`` passes (after a warm-up
    pass): the protocol of :func:`kernel_device_ms` for a library call,
    which may run several kernels."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        first_device_activity()
        for _ in range(rounds):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in on_card_events(prof))
    check(total > 0, "the profiler recorded no device time for the library call")
    return total / 1e3 / (rounds * len(fns))


def device_busy(fn, calls: int = 5) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler, per call: the wall,
    the device time of everything it ran on the card, the count of device
    events, and the longest of those by name. The profiler records the
    card's activity alone: with the host's operators too it took more than
    twice as long to digest (13.7-14.4 s against 5.9-6.2 s for the
    headline's first decade, the same device events and device time)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        first_device_activity()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls
    on_card = on_card_events(prof)
    dev = sum(e.self_device_time_total for e in on_card) / 1e3 / calls
    return {"profiled_wall_ms": wall * 1e3, "device_ms": dev, "calls": calls,
            "device_events": sum(e.count for e in on_card) / calls,
            "busy_share": dev / (wall * 1e3),
            "longest": sorted(((e.key[:60], e.self_device_time_total / 1e3 / calls)
                               for e in on_card), key=lambda kv: -kv[1])[:4]}


def wall_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ensemble_inputs(b: int):
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, b)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


def run_ensemble(params, yy0, yp0, device, tout, dtype=torch.float64):
    st = ensemble_init(roberts_factory, params, yy0, yp0, device=device, dtype=dtype)
    tol = tol_sv(1e-4, ATOL, device=device, dtype=dtype)
    return make_ensemble_solve(roberts_factory)(st, params, tol, tout)


def on_card(params, dtype=torch.float64) -> torch.Tensor:
    """``params`` [B, P] as the fused entry point takes them without a copy."""
    return torch.as_tensor(params, dtype=dtype, device="cuda").contiguous()


def fused_fn(device, dtype=torch.float64, budget=None):
    tol = tol_sv(1e-4, ATOL, device=device, dtype=dtype)
    return fused_solve.make_fused_solve(roberts_factory, tol, attempt_budget=budget)


BITS = {torch.float64: torch.int64, torch.float32: torch.int32, torch.float16: torch.int16,
        torch.bfloat16: torch.int16}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: the same bit pattern (so +0 and -0 differ), any NaN
    equal to any NaN."""
    if not a.is_floating_point():
        return a == b
    return (a.view(BITS[a.dtype]) == b.view(BITS[b.dtype])) | (torch.isnan(a) & torch.isnan(b))


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (+0 and -0 differ), NaN equal to NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(same_bits(a.contiguous(), b.contiguous()).all())


def first_difference(st_a, st_b, out_a: dict, out_b: dict) -> str | None:
    for f in st_a._fields:
        x, y = getattr(st_a, f), getattr(st_b, f)
        if isinstance(x, torch.Tensor) and not same(x, y):
            return f"state.{f}"
    for k in out_a:
        if not same(out_a[k].to(out_b[k].dtype), out_b[k]):
            return k
    return None


def max_abs_diff(st_a, st_b, out_a: dict | None = None, out_b: dict | None = None) -> float:
    """Largest |a - b| over the float fields and outputs (NaN = NaN)."""
    pairs = [(getattr(st_a, f), getattr(st_b, f)) for f in st_a._fields]
    pairs += [(out_a[k], out_b[k]) for k in (out_a or {})]
    worst = 0.0
    for x, y in pairs:
        if isinstance(x, torch.Tensor) and x.is_floating_point() and x.numel():
            d = (x - y.to(x.dtype)).abs()
            d = torch.where(torch.isnan(x) & torch.isnan(y.to(x.dtype)), 0.0, d)
            worst = max(worst, float(d.max()))
    return worst


def state_bytes(st, opts: IdaOptions = IdaOptions(),
                model: fused_model.FusedModel = fused_solve.ROBERTS) -> int:
    """Bytes of the fields a launch of ``model``'s library in ``opts``' mode
    reads or writes."""
    return sum(getattr(st, f).numel() * getattr(st, f).element_size()
               for f in fused_solve.touched_fields(opts, model))


# ---------------------------------------------------------------- phases


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


# K1 built as the parent dispatched it (one thread a lane everywhere) and
# with the floor kernels: the few-lane rows' yardsticks
LU_VARIANTS = {"parent": kernel_variants.K1_VARIANTS["parent"], "floor": kernel_variants.K1_FLOOR}
LU_LIBS: dict = {}


def phase_build() -> None:
    """Every library at once, one nvcc each: K1 (and its parent dispatch and
    floor, LU_VARIANTS), the whole-solve kernel in the parity mode and in
    each mode of FUSED_MODES, the generated models' libraries
    (:func:`model_builds`, traced while the others compile) and the band
    and Krylov libraries of fused_linear (:func:`linear_builds`)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(16) as pool:
        lu, fused = pool.submit(small_lu.build), pool.submit(fused_solve.build)
        variants = {k: pool.submit(_build.build_library, "small_lu.cu", kernel_variants.K1_HEADERS,
                                   flags=("-fmad=false", *f)) for k, f in LU_VARIANTS.items()}
        modes = {m: pool.submit(fused_solve.build_of, o) for m, o in FUSED_MODES.items()}
        generated = model_builds(pool)
        linear = linear_builds(pool)
        lu, fused = lu.result(), fused.result()
        LU_LIBS.update({k: f.result() for k, f in variants.items()})
        modes = {m: f.result() for m, f in modes.items()}
        generated = {k: f.result() for k, f in generated.items()}
        linear = {k: f.result() for k, f in linear.items()}
    small_lu.bind(LU_LIBS["parent"]["lib"])
    kernel_variants.bind_floor(LU_LIBS["floor"]["lib"])
    lu_ptxas = {k: v for k, v in _build.ptxas_summary(lu["log"]).items() if "Li3E" in k}
    emit("build", seconds=time.perf_counter() - t0, cached=lu["cached"] and fused["cached"],
         small_lu_seconds=lu["seconds"], library=lu["path"], small_lu_n3_ptxas=lu_ptxas,
         small_lu_variants={k: {"flags": list(f), "seconds": LU_LIBS[k]["seconds"]}
                            for k, f in LU_VARIANTS.items()},
         small_lu_few_lanes_ptxas={k: kernel_variants.k1_ptxas(info["log"])["n6_10_16"]
                                   for k, info in (("new", lu), ("parent", LU_LIBS["parent"]))})
    summary = _build.ptxas_summary(fused["log"])
    separate_pow = [k for k in summary if "torch_pow" in k]
    emit("fused_build", seconds=fused["seconds"], cached=fused["cached"], library=fused["path"],
         flags=list(fused_solve.BUILD_FLAGS), separately_compiled_pow=separate_pow,
         ptxas={k: v for k, v in summary.items() if "fused" in k or "ida" in k})
    check(not separate_pow, f"a pow compiled apart is linked into the solve: {separate_pow}")
    # every instantiation of the solve kernel in parity and in every mode:
    # registers and spills; none may spill
    ptxas = {"parity": solve_kernels_ptxas(),
             **{m: solve_kernels_ptxas(o) for m, o in FUSED_MODES.items()}}
    spills = {f"{m}/{form}": v for m, forms in ptxas.items() for form, v in forms.items()
              if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    emit("fused_modes_build", seconds={m: info["seconds"] for m, info in modes.items()},
         cached={m: info["cached"] for m, info in modes.items()},
         flags={m: list(fused_solve.mode_flags(o.fast_math, o.ls_precision))
                for m, o in FUSED_MODES.items()}, ptxas=ptxas)
    check(not spills, f"fused_modes_build: solve kernels that spill: {spills}")
    emit("fused_models_build", seconds={k: v["seconds"] for k, v in generated.items()},
         cached={k: v["cached"] for k, v in generated.items()},
         libraries={k: v["path"] for k, v in generated.items()})
    emit("fused_linear_build", seconds={k: v["seconds"] for k, v in linear.items()},
         cached={k: v["cached"] for k, v in linear.items()},
         libraries={k: v["path"] for k, v in linear.items()})


def lu_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_kernels() -> dict:
    """LU kernel vs plain on the same CUDA tensors: bit for bit."""
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
            ok = (torch.equal(f.lu, g.lu) and torch.equal(x, y)
                  and torch.equal(f.piv, g.piv) and torch.equal(f.fail_col, g.fail_col))
            emit("kernel_vs_plain", dtype=str(dtype), n=n, batch=B, bitwise_equal=ok,
                 max_abs_err_lu=err_f, max_abs_err_x=err_s)
            check(ok, f"kernel != plain at n={n} {dtype}")
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

    # the kernels' own device time (profiler), apart from the wrapper's host
    # work, cold: 16 input sets in turn move ~170 MB (factor) and ~110 MB
    # (solve) a pass, more than the 50 MB of L2, so every launch reads its
    # input from HBM
    a_sets = [a.clone() for _ in range(16)]
    b_sets = [b.clone() for _ in range(16)]
    f_sets = [small_lu.lu_factor(x) for x in a_sets]
    dev_ms = {
        "factor": kernel_device_ms([lambda x=x: small_lu.lu_factor(x) for x in a_sets], 4,
                                   "factor_kernel"),
        "solve": kernel_device_ms([lambda g=g, y=y: small_lu.lu_solve(g, y)
                                   for g, y in zip(f_sets, b_sets)], 4, "solve_kernel"),
    }
    # the library yardstick (never called by the port): the same batch,
    # batch-leading; its device time cold by the same protocol (16 input sets
    # in turn), and its back-to-back CUDA-event time under its own name
    a_lead = a.permute(2, 0, 1).contiguous()
    b_lead = b.t().contiguous().unsqueeze(-1)
    lu_l, piv_l, _ = torch.linalg.lu_factor_ex(a_lead)
    lib_wrapper_ms = {
        "factor": cuda_ms(lambda: torch.linalg.lu_factor_ex(a_lead), 200),
        "solve": cuda_ms(lambda: torch.linalg.lu_solve(lu_l, piv_l, b_lead), 200),
    }
    a_lead_sets = [x.permute(2, 0, 1).contiguous() for x in a_sets]
    b_lead_sets = [y.t().contiguous().unsqueeze(-1) for y in b_sets]
    f_lead_sets = [torch.linalg.lu_factor_ex(x)[:2] for x in a_lead_sets]
    lib_ms = {
        "factor": call_device_ms([lambda x=x: torch.linalg.lu_factor_ex(x) for x in a_lead_sets], 4),
        "solve": call_device_ms([lambda g=g, y=y: torch.linalg.lu_solve(g[0], g[1], y)
                                 for g, y in zip(f_lead_sets, b_lead_sets)], 4),
    }
    del a_sets, b_sets, f_sets, a_lead_sets, b_lead_sets, f_lead_sets
    # bytes: each input read once, each output written once
    nbytes = {
        "factor": a.numel() * 8 + a.numel() * 8 + 3 * B * 4 + B * 4,
        "solve": a.numel() * 8 + 3 * B * 4 + b.numel() * 8 + b.numel() * 8,
    }
    # "ms" and "library_ms" are cold device times (profiler); the
    # back-to-back CUDA-event times ("wrapper_ms", "library_wrapper_ms") are
    # paced by the host work of each call
    times = {}
    for k in ("factor", "solve"):
        times[k] = {"ms": dev_ms[k], "wrapper_ms": (t[f"{k}_kernel_1"] + t[f"{k}_kernel_2"]) / 2,
                    "plain_ms": (t[f"{k}_plain_1"] + t[f"{k}_plain_2"]) / 2,
                    "library_ms": lib_ms[k], "library_wrapper_ms": lib_wrapper_ms[k],
                    "bound_ms": lu_bound_ms(nbytes[k]), "bound_by": "bytes"}
    emit("kernel_times", n=3, batch=B, dtype="float64", runs_ms=t, bytes=nbytes, **times)
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
    totals = {f: int(getattr(st, f).sum()) for f in COUNTERS}
    n_ok = int((istate == C.SUCCESS).sum())
    emit("slice", batch=B, tout=TOUT, dtype="float64", wall_s=wall, lanes_success=n_ok,
         steps_per_s=totals["nst"] / wall, launches=launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         attempts_max_lane=int((st.nst + st.netf + st.ncfn).max()), **totals)
    check(n_ok == B, f"{B - n_ok} lanes did not return SUCCESS")
    check(bool((tret == TOUT).all()), "tret != tout")
    check(bool(torch.isfinite(st.yy).all()) and tuple(st.yy.shape) == (B, 3), "bad yy")
    check(launches["factor"] > 0 and launches["solve"] > 0, f"LU kernels not launched: {launches}")
    return {"launches": launches, "wall_s": wall, "result": (st, tret, istate), "totals": totals}


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
    for f in COUNTERS:
        differ |= getattr(sg, f).cpu().numpy() != getattr(sc, f).numpy()
    emit("card_vs_cpu", lanes=256, max_wrms=float(wrms.max()), lanes_counters_differ=int(differ.sum()))
    check(float(wrms.max()) < 1.0, f"card vs CPU WRMS {wrms.max()}")


def check_ans_wrms(yy: np.ndarray) -> float:
    """The acceptance metric of idaRoberts_dns at t = 4e10 (WRMS < 1)."""
    reference = np.array(CHECK_ANS)
    ewt = 1.0 / (1e-4 * np.abs(reference) + 10.0 * np.array(ATOL))
    return float(np.sqrt(np.mean((ewt * (yy - reference)) ** 2)))


def canonical(fn, label: str) -> None:
    """One lane at nominal params, decade by decade to 4e10: the canonical
    per-decade steps, the C idaRoberts_dns totals and check_ans."""
    params = ROBERTS_PARAMS[None, :]
    st = ensemble_init(roberts_factory, params, ROBERTS_YY0[None], ROBERTS_YP0[None], device="cuda")
    nst = []
    for k in range(12):
        st, tret, istate = fn(st, params, 0.4 * 10**k)
        check(int(istate[0]) == C.SUCCESS, f"{label} decade {k}: istate {int(istate[0])}")
        nst.append(int(st.nst[0]))
    totals = {f: int(getattr(st, f)[0]) for f in COUNTERS}
    err = check_ans_wrms(st.yy[0].cpu().numpy())
    emit(label, nst_per_decade=nst, canonical=CANONICAL_NST, totals=totals,
         check_ans_wrms=err, tret=float(tret[0]))
    check(nst == CANONICAL_NST, f"{label}: per-decade nst {nst} != {CANONICAL_NST}")
    check(totals == CANONICAL_TOTALS, f"{label}: totals {totals} != {CANONICAL_TOTALS}")
    check(float(tret[0]) == 4.0e10, f"{label}: final tret")
    check(err < 1.0, f"{label}: check_ans WRMS {err}")


def phase_canonical() -> None:
    tol = tol_sv(1e-4, ATOL, device="cuda")
    eager = make_ensemble_solve(roberts_factory)
    canonical(lambda st, p, t: eager(st, p, tol, t), "canonical_lane")


def stage_states():
    """Real mid-flight states from the eager path on the card: B_SMALL
    lanes, TASK_ONE_STEP calls 1, 5, 10 and 20, plus the 20th state with hh
    x16, whose next attempt fails in many lanes."""
    params, yy0, yp0 = ensemble_inputs(B_SMALL)
    st = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    tol = tol_sv(1e-4, ATOL, device="cuda")
    fn = make_ensemble_solve(roberts_factory, itask=TASK_ONE_STEP)
    snaps = {"init": to_native(st)}
    for k in range(1, 21):
        st, _, _ = fn(st, params, tol, TOUT)
        if k in (1, 5, 10, 20):
            snaps[f"step{k}"] = to_native(st)
    snaps["step20_hh_x16"] = snaps["step20"]._replace(hh=snaps["step20"].hh * 16.0)
    return torch.as_tensor(params, device="cuda").t().contiguous(), tol, snaps


def phase_fused_stages() -> dict:
    params, tol, snaps = stage_states()

    def compare(stage, st, aux=None):
        # the eager stage and the stage kernel on the same CUDA tensors
        st_e, out_e = eager_stage(stage, st, params, tol, aux)
        st_k, out_k = fused_stages.run_stage(stage, st, params, tol, TOUT, aux=aux)
        torch.cuda.synchronize()
        errs[stage] = max(errs.get(stage, 0.0), max_abs_diff(st_k, st_e, out_k, out_e))
        return first_difference(st_k, st_e, out_k, out_e), st_e, out_e

    fused_stages.reset_launch_counts()
    results, errs, n_failed_attempts = {}, {}, 0
    for name, st in snaps.items():
        if name == "init":
            diff, _, _ = compare("prologue", st)
            results[f"{name}/prologue"] = diff
            continue
        for stage in ("prologue", "stoptest", "getsol", "attempt"):
            diff, _, out = compare(stage, st)
            results[f"{name}/{stage}"] = diff
            if stage == "attempt":
                n_failed_attempts += int((out["success"] == 0).sum())
        # the chain inside one attempt, each stage on the eager output of the last
        diff, s1, o1 = compare("set_coeffs", st)
        results[f"{name}/set_coeffs"] = diff
        s1 = s1._replace(tn=s1.tn + s1.hh)
        diff, s2, _ = compare("nls", s1)
        results[f"{name}/nls"] = diff
        diff, s3, o3 = compare("error_test", s2, {"ck": o1["ck"]})
        results[f"{name}/error_test"] = diff
        diff, _, _ = compare("complete_step", s3,
                             {"err_k": o3["err_k"], "err_km1": o3["err_km1"], "ck": o1["ck"]})
        results[f"{name}/complete_step"] = diff
    fails = {k: v for k, v in results.items() if v is not None}
    launches = dict(fused_stages.STAGE_LAUNCHES)
    emit("fused_stages", batch=B_SMALL, checks=len(results), failed_attempts=n_failed_attempts,
         first_differences=fails, launches=launches, max_abs_err=errs)
    check(not fails, f"stage kernels differ from the eager stages: {fails}")
    check(n_failed_attempts > 0, "no failed attempt among the stage inputs")
    check(all(v > 0 for v in launches.values()), f"a stage kernel was not launched: {launches}")

    # times per stage at B_SMALL on the step-10 state: the bare kernel
    # launch (CUDA events, median of 5 fresh copies) vs the eager stage
    st = snaps["step10"]
    times = {}
    for stage in fused_stages.STAGES:
        src = snaps["init"] if stage == "prologue" else st
        runs = []
        for _ in range(5):
            launch, _, _ = fused_stages.prepare_launch(stage, src, params, tol, TOUT)
            runs.append(cuda_ms(launch, 1, warm=False))
        p1 = cuda_ms(lambda: eager_stage(stage, src, params, tol), 3)
        p2 = cuda_ms(lambda: eager_stage(stage, src, params, tol), 3)
        times[stage] = {"ms": statistics.median(runs), "plain_ms": (p1 + p2) / 2,
                        "bound_ms": 2 * state_bytes(src) / HBM_BYTES_PER_S * 1e3}
    emit("fused_stage_times", batch=B_SMALL, dtype="float64", times=times)
    return {"launches": launches, "times": times, "max_abs_err": errs}


def eager_stage(stage, st, params, tol, aux=None):
    """The eager stage (plain version) on the given CUDA tensors."""
    return fused_stages.plain_stage(stage, st, params, tol, TOUT, aux)


def solve_ops(totals: dict, per: dict = OPS_PER) -> float:
    attempts = totals["nst"] + totals["netf"] + totals["ncfn"]
    return (attempts * per["attempt"] + totals["nni"] * per["newton"]
            + max(totals["nni"] - attempts, 0) * per["newton_more"]
            + totals["nje"] * per["lsetup"] + totals["nst"] * per["step"])


def mode_ops(totals: dict, opts: IdaOptions, dtype: torch.dtype) -> dict:
    """:func:`solve_ops` of a solve in ``opts``' mode by the type they run
    in: under "single" and "refined" the LU's operations are float32, and
    "refined" adds its second solve and jvp a Newton iteration."""
    ops = solve_ops(totals)
    if opts.ls_precision == "full":
        return {dtype: ops}
    n_solves = totals["nni"] * (2 if opts.ls_precision == "refined" else 1)
    lu = n_solves * OPS_LU["solve"] + totals["nje"] * OPS_LU["factor"]
    rest = ops - totals["nni"] * OPS_LU["solve"] - totals["nje"] * OPS_LU["factor"]
    if opts.ls_precision == "refined":
        rest += totals["nni"] * OPS_REFINED_EXTRA
    if dtype == torch.float32:
        return {torch.float32: rest + lu}
    return {torch.float64: rest, torch.float32: lu}


def solve_bound(st, ops, opts: IdaOptions = IdaOptions(),
                model: fused_model.FusedModel = fused_solve.ROBERTS) -> tuple[float, str]:
    """The least time for a launch's work: the state (B lanes) read and
    written once, with params read once (the tolerances and tout travel by
    value), over the memory rate, against the operations (a number, in the
    state's dtype, or {dtype: operations}) over the peak rate of their
    type; the fields are those of ``model``'s library in ``opts``' mode."""
    bsz = st.tn.shape[0]
    nbytes = (2 * state_bytes(st, opts, model)
              + bsz * model.p * st.phi.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_type = ops if isinstance(ops, dict) else {st.dtype: ops}
    t_ops = sum(n / PEAK_FLOPS[dt] for dt, n in by_type.items()) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def counter_totals(st) -> dict:
    return {f: int(getattr(st, f).sum()) for f in COUNTERS}


def shared_tol(n: int = 3, dtype=torch.float64):
    return fused_solve.tol_inputs(tol_sv(1e-4, ATOL, device="cuda", dtype=dtype), n, 1, dtype,
                                  torch.device("cuda"))


def bare_launch_ms(st0, p_b, tol_in=None, opts: IdaOptions = IdaOptions(),
                   model: fused_model.FusedModel = fused_solve.ROBERTS, tout: float = TOUT) -> float:
    """CUDA-event time of one bare K2 launch of ``model``'s library to
    ``tout`` (the headline's shared tolerances unless ``tol_in`` is given)
    in ``opts``' mode: the arguments are checked and the result allocated
    before the first event, so the window holds the launch alone."""
    dst = fused_solve.empty_result(st0, opts, model)
    carry = fused_solve.new_carry(st0.tn.shape[0], st0.dtype, st0.phi.device, False)
    go = fused_solve.prepare_launch("", st0, dst, p_b, tol_in or shared_tol(), tout, carry,
                                    opts, model, None)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    go()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


# the solve kernel's instantiations by their mangled names: the state's
# dtype (...RealIdEE... f64, ...RealIfEE... f32) and LaneTol last
# (...Lb0EEEv12IdaSolveArgs... shared tolerances, ...Lb1EEEv... per lane)
SOLVE_KERNEL_FORMS = {f"{dt}_{tol}": (dtag, ttag)
                      for dt, dtag in (("f64", "RealIdEE"), ("f32", "RealIfEE"))
                      for tol, ttag in (("shared_tol", "Lb0EEEv"), ("lane_tol", "Lb1EEEv"))}


def solve_kernels_ptxas(opts: IdaOptions = IdaOptions(),
                        model: fused_model.FusedModel = fused_solve.ROBERTS) -> dict:
    """Registers, stack and spills of each instantiation of the solve
    kernel in ``opts``' mode (:data:`SOLVE_KERNEL_FORMS`) from the ptxas log
    of ``model``'s build."""
    summary = _build.ptxas_summary(fused_solve.build_of(opts, model)["log"])
    out = {}
    for form, (dtag, ttag) in SOLVE_KERNEL_FORMS.items():
        hits = {k: v for k, v in summary.items()
                if "fused_solve_kernel" in k and dtag in k and ttag in k}
        check(len(hits) == 1, f"the {form} solve kernel's ptxas line: found {sorted(hits)} "
                              f"among {sorted(k for k in summary if 'fused_solve_kernel' in k)}")
        out[form] = next(iter(hits.values()))
    return out


def solve_kernel_ptxas(opts: IdaOptions = IdaOptions()) -> dict:
    """:func:`solve_kernels_ptxas` of the f64 kernel with shared
    tolerances, the headline's."""
    return solve_kernels_ptxas(opts)["f64_shared_tol"]


def warp_divergence(st) -> dict:
    """How unevenly the lanes of a warp work, from the result's counters:
    over each group of 32 consecutive lanes, the largest over the mean count
    of attempts (nst + netf + ncfn) and of Newton iterations (nni); the
    median and the worst group. A warp runs as long as its slowest lane."""
    out = {}
    for name, x in (("attempts", st.nst + st.netf + st.ncfn), ("nni", st.nni)):
        g = x[: x.numel() // 32 * 32].reshape(-1, 32).double()
        ratio = g.max(dim=1).values / g.mean(dim=1)
        out[name] = {"median": float(ratio.median()), "worst": float(ratio.max())}
    return out


def phase_fused_slice(eager: dict) -> dict:
    params, yy0, yp0 = ensemble_inputs(B)
    st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    p_b = on_card(params)
    fn = fused_fn("cuda")
    fn(st0, p_b, TOUT)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_solve.reset_launch_counts()
    out = fn(st0, p_b, TOUT)
    torch.cuda.synchronize()
    launches = fused_solve.launch_count("solve")
    peak = torch.cuda.max_memory_allocated()
    st, tret, istate = out
    est, etret, eistate = eager["result"]

    n_ok = int((istate == C.SUCCESS).sum())
    ok_counters = {f: same(getattr(st, f), getattr(est, f)) for f in COUNTERS}
    ok_fields = {f: same(getattr(st, f), getattr(est, f)) for f in ("yy", "yp", "phi")}
    mismatch = [f for f in st._fields if isinstance(getattr(st, f), torch.Tensor)
                and not same(getattr(st, f), getattr(est, f))]
    err = max_abs_diff(st, est)
    # out of place: the input state still is the initial one
    fresh = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    input_changed = [f for f in st0._fields if isinstance(getattr(st0, f), torch.Tensor)
                     and not same(getattr(st0, f), getattr(fresh, f))]

    walls = [wall_s(lambda: fn(st0, p_b, TOUT)) for _ in range(3)]
    wall = statistics.median(walls)
    walls_numpy_params = [wall_s(lambda: fn(st0, params, TOUT)) for _ in range(3)]
    kernel_runs = [bare_launch_ms(st0, p_b) for _ in range(3)]
    kernel_ms = statistics.median(kernel_runs)
    eager_walls = [wall_s(lambda: run_ensemble(params, yy0, yp0, "cuda", TOUT)) for _ in range(2)]
    busy = device_busy(lambda: fn(st0, p_b, TOUT))
    check(busy["device_events"] > 0, "the profiler recorded no device event of the fused call")
    totals = counter_totals(st)
    bound, bound_by = solve_bound(st0, solve_ops(totals))
    occ = fused_solve.occupancy(torch.float64)
    blocks = -(-B // occ["threads"])
    slots = occ["blocks_per_sm"] * occ["sms"]
    emit("fused_slice", batch=B, tout=TOUT, dtype="float64", lanes_success=n_ok,
         istate_equal=same(istate, eistate), tret_equal=same(tret, etret),
         counters_equal=ok_counters, bitwise_equal=ok_fields, fields_differ=mismatch,
         input_fields_changed=input_changed,
         max_abs_err=err, wall_s=wall, walls_s=walls, steps_per_s=totals["nst"] / wall,
         walls_s_numpy_params=walls_numpy_params,
         kernel_ms=kernel_ms, kernel_runs_ms=kernel_runs, launches=launches,
         peak_mem_bytes=peak, eager_wall_s=eager["wall_s"],
         eager_walls_s_same_process=eager_walls, bound_ms=bound, bound_by=bound_by,
         ops=solve_ops(totals), profiled=busy, device_events_per_call=busy["device_events"],
         solve_kernel={**solve_kernel_ptxas(), **occ, "blocks": blocks, "block_slots": slots,
                       "waves": blocks / slots},
         warp_divergence=warp_divergence(st), **totals)
    check(n_ok == B, f"fused: {B - n_ok} lanes did not return SUCCESS")
    check(same(istate, eistate) and same(tret, etret), "fused istate/tret != eager")
    check(all(ok_counters.values()), f"fused counters != eager: {ok_counters}")
    check(all(ok_fields.values()), f"fused yy/yp/phi != eager: {ok_fields}")
    check(not mismatch, f"fused state fields != eager: {mismatch}")
    check(not input_changed, f"the fused solve changed its input state: {input_changed}")
    check(launches == 1, f"fused kernel launches {launches}")
    check(occ["threads"] == BLOCK, f"the kernel's block is {occ['threads']} threads, not {BLOCK}")
    return {"launches": launches, "ms": kernel_ms, "plain_ms": eager["wall_s"] * 1e3,
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err}


def phase_fused_budgeted() -> dict:
    params, yy0, yp0 = ensemble_inputs(B_SMALL)
    st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    ref = fused_fn("cuda")(st0, params, TOUT)
    fused_solve.reset_launch_counts()
    got = fused_fn("cuda", budget=7)(st0, params, TOUT)
    torch.cuda.synchronize()
    n_launch = fused_solve.launch_count("init") + fused_solve.launch_count("cont")
    differ = [f for f in ref[0]._fields if isinstance(getattr(ref[0], f), torch.Tensor)
              and not same(getattr(ref[0], f), getattr(got[0], f))]
    ok = not differ and same(ref[1], got[1]) and same(ref[2], got[2])
    err = max_abs_diff(got[0], ref[0])
    emit("fused_budgeted", batch=B_SMALL, attempt_budget=7, launches=n_launch,
         bitwise_equal=ok, fields_differ=differ, max_abs_err=err)
    check(ok, f"budgeted kernel != unbudgeted: {differ}")
    check(n_launch > 3, f"budget 7 took only {n_launch} launches")

    # the headline with budget 32: launches and wall through the entry point
    params, yy0, yp0 = ensemble_inputs(B)
    st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    p_b = on_card(params)
    fn = fused_fn("cuda", budget=32)
    fn(st0, p_b, TOUT)
    fused_solve.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(st0, p_b, TOUT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"init": fused_solve.launch_count("init"), "cont": fused_solve.launch_count("cont")}
    check(launches["init"] == 1 and launches["cont"] > 0, f"budgeted launches {launches}")

    # launch by launch against the plain version, the eager
    # solve(max_attempts=32) and its resumes on the same card: after each
    # launch (K3 out of place, K4 in place on its result) the state and the
    # 9-field carry are bit for bit the eager call's; each launch's
    # CUDA-event time beside the eager call's wall
    p = p_b.t().contiguous()
    prob = roberts_factory(p)
    eager_out = (to_native(st0), None, None, None)
    inputs = fused_solve.lane_inputs(eager_out[0], p, tol_sv(1e-4, ATOL, device="cuda"), TOUT, 3)
    tol_n = TolControl(inputs[1], inputs[2])
    dst = fused_solve.empty_result(st0, IdaOptions(), fused_solve.ROBERTS)
    carry = fused_solve.new_carry(B, dst.dtype, dst.phi.device, True)
    tol_in = shared_tol()
    runs = []

    def step(resume: bool) -> torch.Tensor:
        nonlocal eager_out
        kind = "cont" if resume else "init"
        ops_before = solve_ops(counter_totals(dst)) if resume else 0
        go = fused_solve.prepare_launch(kind, dst if resume else st0, dst, p_b, tol_in, TOUT,
                                        carry, IdaOptions(), fused_solve.ROBERTS, 32)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        istate = go()
        ev[1].record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_out = core_solve(eager_out[0], prob, IdaOptions(), tol_n, inputs[3], max_attempts=32,
                               resume_carry=eager_out[3] if resume else None)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        eager_carry = dict(zip(fused_solve.CARRY_FIELDS, eager_out[3]))
        native = to_native(dst)
        diff = first_difference(native, eager_out[0], carry, eager_carry)
        runs.append({"kind": kind, "ms": ev[0].elapsed_time(ev[1]), "plain_ms": plain_ms,
                     "ops": solve_ops(counter_totals(dst)) - ops_before, "first_difference": diff,
                     "max_abs_err": max_abs_diff(native, eager_out[0], carry, eager_carry)})
        check(diff is None, f"budget 32, launch {len(runs)} ({kind}): {diff} != the eager call's")
        return istate

    n_runs = fused_solve.run_until_done(step)
    est, etret, eistate = from_native(eager_out[0]), eager_out[1], eager_out[2]
    differ = [f for f in est._fields if isinstance(getattr(est, f), torch.Tensor)
              and not same(getattr(out[0], f), getattr(est, f))]
    final_ok = not differ and same(out[1], etret) and same(out[2], eistate)
    init, cont = runs[0], runs[1:]
    ops_cont = statistics.mean(r["ops"] for r in cont)
    bound_init, by_init = solve_bound(st0, init["ops"])
    bound_cont, by_cont = solve_bound(st0, ops_cont)
    emit("fused_budgeted_headline", batch=B, attempt_budget=32, wall_s=wall, launches=launches,
         per_launch=runs, entry_point_equals_eager_budgeted=final_ok, fields_differ=differ,
         bound_init_ms=bound_init, bound_cont_ms=bound_cont)
    check(n_runs == launches["init"] + launches["cont"],
          f"the eager budgeted loop ran {n_runs} calls, the entry point {launches} launches")
    check(final_ok, f"budget 32 through make_fused_solve != the eager budgeted loop: {differ}")
    check(bool((out[2] == C.SUCCESS).all()), "budget 32: a lane did not return SUCCESS")
    return {
        "init": {"launches": launches["init"], "ms": init["ms"], "plain_ms": init["plain_ms"],
                 "bound_ms": bound_init, "bound_by": by_init, "max_abs_err": init["max_abs_err"]},
        "cont": {"launches": launches["cont"], "ms": statistics.mean(r["ms"] for r in cont),
                 "plain_ms": statistics.mean(r["plain_ms"] for r in cont),
                 "bound_ms": bound_cont, "bound_by": by_cont,
                 "max_abs_err": max(r["max_abs_err"] for r in cont)},
    }


def phase_fused_f32() -> None:
    params, yy0, yp0 = ensemble_inputs(B)
    st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda", dtype=torch.float32)
    st, tret, istate = fused_fn("cuda", torch.float32)(st0, params, TOUT)
    est, etret, eistate = run_ensemble(params, yy0, yp0, "cuda", TOUT, dtype=torch.float32)
    torch.cuda.synchronize()
    counters = {f: same(getattr(st, f), getattr(est, f)) for f in COUNTERS}
    bitwise = {f: same(getattr(st, f), getattr(est, f)) for f in ("yy", "yp", "phi")}
    n_ok = int((istate == C.SUCCESS).sum())
    emit("fused_f32", batch=B, tout=TOUT, lanes_success=n_ok, istate_equal=same(istate, eistate),
         tret_equal=same(tret, etret), counters_equal=counters, bitwise_equal=bitwise,
         nst=int(st.nst.sum()))
    check(same(istate, eistate) and same(tret, etret), "f32 kernel istate/tret != eager f32")
    check(all(counters.values()), f"f32 kernel counters != eager f32: {counters}")


def phase_fused_canonical() -> None:
    fn = fused_fn("cuda")
    canonical(fn, "fused_canonical_lane")

# ------------------------------------------- roots, dense output, user surface


def roots_factory(p):
    return roberts_factory(p, with_roots=True)


def lu_launches() -> dict:
    return {"factor": small_lu.FACTOR_LAUNCHES, "solve": small_lu.SOLVE_LAUNCHES}


def run_rooted(params, yy0, yp0, device, tout, max_calls=4) -> dict:
    """``EnsembleIDA`` with roots on, called again while any lane returns
    ROOT_RETURN (the loop of bench.py::run_roberts_roots). Per lane: how
    often it returned a root, and the time and signs of its last one."""
    ens = EnsembleIDA(roots_factory, params, yy0, yp0, tol_sv(1e-4, ATOL, device=device),
                      device=device)
    bsz = len(params)
    n_root = np.zeros(bsz, np.int64)
    t_root = np.zeros(bsz)
    iroots = np.zeros((bsz, 2), np.int64)
    calls, wall = 0, 0.0
    while True:
        check(calls < max_calls, f"still ROOT_RETURN lanes after {calls} solve calls")
        t0 = time.perf_counter()
        tret, istate = ens.solve(tout)  # returns host arrays: synchronizes
        wall += time.perf_counter() - t0
        calls += 1
        hit = istate == C.ROOT_RETURN
        if not hit.any():
            break
        n_root += hit
        t_root[hit] = tret[hit]
        iroots[hit] = ens.states.iroots.cpu().numpy()[hit]
    return {"ens": ens, "tret": tret, "istate": istate, "calls": calls, "wall_s": wall,
            "n_root": n_root, "t_root": t_root, "iroots": iroots}


def phase_roots_slice(eager: dict) -> dict:
    params, yy0, yp0 = ensemble_inputs(B)
    run_rooted(params, yy0, yp0, "cuda", ROOTS_PROFILE_TOUT)  # warm-up
    torch.cuda.synchronize()
    small_lu.reset_launch_counts()
    core_root.reset_pass_count()
    out = run_rooted(params, yy0, yp0, "cuda", TOUT)
    launches, passes = lu_launches(), core_root.ILLINOIS_PASSES
    st = out["ens"].states
    totals = {f: int(getattr(st, f).sum()) for f in COUNTERS + ("nge",)}
    n_ok = int((out["istate"] == C.SUCCESS).sum())
    once = int((out["n_root"] == 1).sum())
    on_g1 = int((out["iroots"] == np.array([0, 1])).all(axis=1).sum())
    # the device's share of the wall, and the same for the solve without
    # roots beside it (its events a call are the yardstick for what the root
    # checks add), over the first decades, which hold the root (to tout 400
    # the two windows held ~120,000 and ~90,000 device events and took the
    # profiler over a minute each to digest). Windows this long come after
    # every phase that profiles a handful of launches: such a short window
    # was seen to come back empty right after a long one
    busy = device_busy(lambda: run_rooted(params, yy0, yp0, "cuda", ROOTS_PROFILE_TOUT), calls=1)
    busy_eager = device_busy(lambda: run_ensemble(params, yy0, yp0, "cuda", ROOTS_PROFILE_TOUT),
                             calls=1)
    check(busy["device_events"] > 0 and busy_eager["device_events"] > 0,
          "the profiler recorded no device event of the eager solves")

    # 256 evenly spaced lanes against the port's own CPU run
    lanes = np.linspace(0, B - 1, 256).astype(int)
    cpu = run_rooted(params[lanes], yy0[lanes], yp0[lanes], "cpu", TOUT)
    sc = cpu["ens"].states
    exact = {f: bool((getattr(st, f)[lanes].cpu() == getattr(sc, f)).all()) for f in ("nst", "nge")}
    exact["iroots"] = bool((out["iroots"][lanes] == cpu["iroots"]).all())
    exact["n_root"] = bool((out["n_root"][lanes] == cpu["n_root"]).all())
    ycpu = sc.yy.numpy()
    w = 1.0 / (1e-4 * np.abs(ycpu) + np.array(ATOL))
    wrms = float(np.sqrt(np.mean((w * (st.yy[lanes].cpu().numpy() - ycpu)) ** 2, axis=1)).max())
    # the root time on the scale of the relative tolerance
    t_err = float((np.abs(out["t_root"][lanes] - cpu["t_root"]) / (1e-4 * cpu["t_root"])).max())
    emit("roots_slice", batch=B, tout=TOUT, dtype="float64", wall_s=out["wall_s"],
         eager_no_roots_wall_s=eager["wall_s"], solve_calls=out["calls"], lanes_success=n_ok,
         lanes_one_root=once, lanes_root_on_g1=on_g1, steps_per_s=totals["nst"] / out["wall_s"],
         illinois_passes=passes, launches=launches,
         attempts_max_lane=int((st.nst + st.netf + st.ncfn).max()), root_time_min=float(out["t_root"].min()),
         root_time_max=float(out["t_root"].max()), profiled_to=ROOTS_PROFILE_TOUT, profiled=busy,
         busy_share=busy["busy_share"], profiled_without_roots=busy_eager,
         card_vs_cpu={"lanes": 256, "exact": exact, "max_wrms_yy": wrms,
                      "max_root_time_err_over_rtol": t_err}, **totals)
    check(n_ok == B, f"roots_slice: {B - n_ok} lanes did not end SUCCESS")
    check(bool((out["tret"] == TOUT).all()), "roots_slice: tret != tout")
    check(once == B, f"roots_slice: {B - once} lanes did not return exactly one root")
    check(on_g1 == B, f"roots_slice: {B - on_g1} lanes' root is not g1 rising (iroots [0, +1])")
    check(0.2 < out["t_root"].min() and out["t_root"].max() < 0.35, "roots_slice: root times")
    check(totals["nst"] == eager["totals"]["nst"], "roots_slice: roots changed the steps taken")
    check(all(exact.values()), f"roots_slice: card != CPU on 256 lanes: {exact}")
    check(wrms < 1.0 and t_err < 1.0, f"roots_slice: card vs CPU WRMS {wrms}, root time {t_err}")
    check(launches["factor"] > 0 and launches["solve"] > 0, f"LU kernels not launched: {launches}")
    return {"launches": launches}


def native_setup(factory, params, yy0, yp0):
    """Batch-native state, problem and tolerances on the card (the layout
    ``solve`` and ``solve_dense`` take; bench.py::_native_setup)."""
    st = to_native(ensemble_init(factory, params, yy0, yp0, device="cuda"))
    p = on_card(params).t().contiguous()
    inputs = fused_solve.lane_inputs(st, p, tol_sv(1e-4, ATOL, device="cuda"), TOUT, 3)
    return st, factory(p), TolControl(inputs[1], inputs[2])


def phase_dense_slice() -> dict:
    params, yy0, yp0 = ensemble_inputs(B)
    # B is even, so no lane of the sweep sits at the nominal parameters: the
    # middle lane is put there, to carry the canonical per-decade steps
    mid = B // 2
    params[mid] = ROBERTS_PARAMS
    yp0[mid] = ROBERTS_YP0

    def run(touts=DECADES):
        st, prob, tol = native_setup(roberts_factory, params, yy0, yp0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve_dense(st, prob, IdaOptions(), tol, touts)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(DECADES[:1])  # warm-up: what the solve launches, loaded
    small_lu.reset_launch_counts()
    (st, tret, ist, yy, yp, nst), wall = run()
    launches = lu_launches()
    # the busy share from the first decade only: the profiler takes
    # minutes to digest the ~360,000 device events of all twelve
    busy = device_busy(lambda: run(DECADES[:1]), calls=1)
    check(busy["device_events"] > 0, "the profiler recorded no device event of solve_dense")

    # the scan form at full width: 12 chained launches of the whole-solve
    # kernel (bit for bit the eager solve, lane by lane)
    fn = fused_fn("cuda")
    sk = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    p_b = on_card(params)
    fused_solve.reset_launch_counts()
    differ, chain_ms = [], 0.0
    for k, tout in enumerate(DECADES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sk, ktret, kist = fn(sk, p_b, tout)
        ev[1].record()
        torch.cuda.synchronize()
        chain_ms += ev[0].elapsed_time(ev[1])
        pairs = {"tret": (tret[k], ktret), "istate": (ist[k], kist), "yy": (yy[k], sk.yy.t()),
                 "yp": (yp[k], sk.yp.t()), "nst": (nst[k], sk.nst)}
        differ += [f"row {k}: {name}" for name, (a, b) in pairs.items() if not same(a, b.contiguous())]
    n_ok = int((ist == C.SUCCESS).sum())
    attempts = st.nst + st.netf + st.ncfn
    total_nst = int(st.nst.sum())
    emit("dense_slice", batch=B, rows=len(DECADES), dtype="float64", wall_s=wall,
         rows_success=n_ok, steps_per_s=total_nst / wall, nst=total_nst,
         attempts_total=int(attempts.sum()), attempts_max_lane=int(attempts.max()),
         launches=launches, scan_form_kernel_launches=fused_solve.launch_count("solve"),
         scan_form_ms=chain_ms, rows_differ_from_scan_form=differ[:8],
         nominal_lane_nst=nst[:, mid].tolist(), profiled_first_decade=busy,
         busy_share=busy["busy_share"])
    check(n_ok == len(DECADES) * B, f"dense_slice: {len(DECADES) * B - n_ok} rows not SUCCESS")
    check(fused_solve.launch_count("solve") == len(DECADES), "dense_slice: the scan form's launches")
    check(not differ, f"dense_slice: rows != 12 chained whole-solve launches: {differ[:8]}")
    check(nst[:, mid].tolist() == CANONICAL_NST, f"dense_slice: nominal lane {nst[:, mid].tolist()}")
    check(launches["factor"] > 0 and launches["solve"] > 0, f"LU kernels not launched: {launches}")
    return {"launches": launches, "scan_form_launches": fused_solve.launch_count("solve")}


def phase_dense_events() -> None:
    # ties of the sign-change scan on the card: equal fractions, and no sign
    # change at all, pick component 0
    glo = torch.tensor([[-1.0, 1.0], [-1.0, 1.0]], device="cuda")
    gnew = torch.tensor([[1.0, 2.0], [1.0, 2.0]], device="cuda")
    act = torch.ones_like(glo, dtype=torch.bool)
    _, sgn, imax = core_root._scan(act, torch.zeros_like(glo, dtype=torch.int32), glo, gnew)
    check(sgn.tolist() == [True, False] and imax.tolist() == [0, 0], f"_scan ties: {imax.tolist()}")

    max_events = 4
    params, yy0, yp0 = ensemble_inputs(B_SMALL)
    st0, prob, tol = native_setup(roots_factory, params, yy0, yp0)
    out = solve_dense(st0, prob, IdaOptions(), tol, DECADES, max_events=max_events)
    ev = out[6]
    s0, p0, t0 = native_setup(roberts_factory, params, yy0, yp0)
    plain_nst = solve_dense(s0, p0, IdaOptions(), t0, DECADES)[5]

    # the re-entry form on the same lanes: every ROOT_RETURN of every call
    st = st0
    count = torch.zeros(B_SMALL, dtype=torch.int32, device="cuda")
    slot = torch.arange(max_events, dtype=torch.int32, device="cuda").reshape(-1, 1)
    ev_t = torch.zeros_like(ev.t)
    ev_ir, ev_yy = torch.zeros_like(ev.iroots), torch.zeros_like(ev.yy)
    calls = 0
    for tout in DECADES:
        while True:
            st, tret, ist = core_solve(st, prob, IdaOptions(), tol, tout)
            calls += 1
            hit = ist == C.ROOT_RETURN
            if not bool(hit.any()):
                break
            row = (slot == count) & hit
            ev_t = torch.where(row, tret, ev_t)
            ev_ir = torch.where(row.unsqueeze(1), st.iroots.unsqueeze(0), ev_ir)
            ev_yy = torch.where(row.unsqueeze(1), st.yy.unsqueeze(0), ev_yy)
            count = count + hit.to(torch.int32)
        check(bool((ist == C.SUCCESS).all()), f"re-entry form: a lane failed toward {tout}")
    equal = {"t": same(ev.t, ev_t), "iroots": same(ev.iroots, ev_ir), "yy": same(ev.yy, ev_yy),
             "count": same(ev.count, count), "rows_nst": same(out[5], plain_nst)}
    counts = sorted(set(ev.count.tolist()))
    emit("dense_events", batch=B_SMALL, max_events=max_events, events_per_lane=counts,
         reentry_solve_calls=calls, rows_success=int((out[2] == C.SUCCESS).sum()), equal=equal,
         first_event=[float(ev.t[0].min()), float(ev.t[0].max())],
         second_event=[float(ev.t[1].min()), float(ev.t[1].max())])
    check(all(equal.values()), f"dense_events: != the re-entry form: {equal}")
    check(counts == [2], f"dense_events: events per lane {counts}")
    check(bool((out[2] == C.SUCCESS).all()), "dense_events: a row is not SUCCESS")
    check(bool((ev.iroots[0] == torch.tensor([[0], [1]], device="cuda")).all())
          and bool((ev.iroots[1] == torch.tensor([[-1], [0]], device="cuda")).all()),
          "dense_events: the signs of the two events")


def phase_user_surface() -> None:
    # --- IDA, one lane on the card, as examples/roberts.py drives it ---
    tol = tol_sv(1e-4, ATOL)
    ida = IDA(roberts_problem(), ROBERTS_YY0, ROBERTS_YP0, tol)
    t0 = time.perf_counter()
    roots, iout, tout = [], 0, 0.4
    while iout < 12:
        tret, status = ida.solve(tout)
        if status == IdaSolveStatus.Root:
            roots.append((tret, ida.get_root_info().tolist()))
            continue
        check(status == IdaSolveStatus.Success, f"IDA: {status} toward {tout}")
        iout += 1
        tout *= 10.0
    wall = time.perf_counter() - t0
    got = {"nst": ida.get_num_steps(), "nre": ida.get_num_res_evals(),
           "nje": ida.get_num_jac_evals(), "nni": ida.get_num_nonlin_solv_iters(),
           "netf": ida.get_num_err_test_fails(), "ncfn": ida.get_num_nonlin_solv_conv_fails(),
           "nge": ida.get_num_g_evals()}
    err = check_ans_wrms(ida.get_yy())
    t_in = ida.get_current_time() - 0.5 * ida.get_last_step()
    dky_equal = bool(np.array_equal(ida.get_dky(t_in, 0), ida.get_solution(t_in)[0]))
    emit("user_surface_ida", device=str(ida.device), wall_s=wall, roots=roots, counters=got,
         pinned=ROOTED_TOTALS, check_ans_wrms=err, tret=tret, get_dky0_equals_get_solution=dky_equal)
    check(got == ROOTED_TOTALS, f"IDA counters {got} != {ROOTED_TOTALS}")
    check(len(roots) == len(ROOT_EVENTS), f"IDA found {len(roots)} roots")
    for (t, ir), (t_ref, rtol, ir_ref) in zip(roots, ROOT_EVENTS):
        check(abs(t - t_ref) <= rtol * t_ref and ir == ir_ref, f"IDA root {t} {ir}")
    check(tret == 4.0e10 and err < 1.0, f"IDA: tret {tret}, check_ans WRMS {err}")
    check(dky_equal, "get_dky(t, 0) != get_solution(t)[0]")

    # --- solve_dae with an event function ---
    prob = roberts_problem()
    sol = solve_dae(prob.res, (0.0, 4.0e3), ROBERTS_YY0, ROBERTS_YP0, t_eval=DECADES[:5],
                    rtol=1e-4, atol=ATOL, jac=prob.jac, roots=prob.root)
    emit("user_surface_solve_dae", success=sol.success, t=sol.t.tolist(),
         t_events=sol.t_events.tolist(), stats=sol.stats)
    check(sol.success and sol.t.tolist() == DECADES[:5], f"solve_dae: {sol.message}")
    check(sol.t_events.tolist() == [roots[0][0]], f"solve_dae events {sol.t_events.tolist()}")
    check(bool(np.isfinite(sol.y).all()) and sol.y.shape == (5, 3), "solve_dae: y")

    # --- EnsembleIDA against the harness of the slice phase, same lanes ---
    params, yy0, yp0 = ensemble_inputs(B_SMALL)
    ens = EnsembleIDA(roberts_factory, params, yy0, yp0, tol)
    tret_e, ist_e = ens.solve(TOUT)
    hst, htret, hist = run_ensemble(params, yy0, yp0, "cuda", TOUT)
    est = ens.states
    differ = [f for f in hst._fields if isinstance(getattr(hst, f), torch.Tensor)
              and not same(getattr(est, f), getattr(hst, f))]
    ok = (not differ and np.array_equal(tret_e, htret.cpu().numpy())
          and np.array_equal(ist_e, hist.cpu().numpy()))
    # --- report_failures: five steps are not enough for anybody ---
    bad = EnsembleIDA(roberts_factory, params, yy0, yp0, tol, IdaOptions(mxstep=5))
    _, ist_b = bad.solve(TOUT)
    rows = bad.report_failures(ist_b)
    names = sorted({r["status_name"] for r in rows})
    emit("user_surface_ensemble", batch=B_SMALL, equals_harness=ok, fields_differ=differ,
         lanes_success=int((ist_e == C.SUCCESS).sum()), failures_reported=len(rows),
         failure_names=names, first_line=bad.format_failures(ist_b).splitlines()[0])
    check(ok, f"EnsembleIDA.solve != ensemble_init + make_ensemble_solve: {differ}")
    check(len(rows) == B_SMALL and names == ["TOO_MUCH_WORK"]
          and [r["lane"] for r in rows] == list(range(B_SMALL)), "report_failures with mxstep=5")
    check(all(r["nst"] == 5 for r in rows), "report_failures: nst")


# --------------------------------------------- the Krylov path and calc_ic

HEAT_M = 100  # BASELINE config 4 (idaHeat2D_kry at 100 x 100, N = 10,000)
HEAT_TOUT = 0.16
HEAT_B = 64  # bench.py::run_heat2d_batched
FOOD_M = 20  # BASELINE config 5 (idaFoodWeb_kry at 20 x 20, N = 800)
FOOD_B = 128  # bench.py::run_foodweb_batched
FOOD_TOUTS = [1e-3, 4e-3, 1.6e-2, 6.4e-2]
# ida_tpu's own counts on its last recorded run (BENCH_DETAIL.json, a TPU
# run): printed beside the card's as a cross-check, never a gate, because
# the order of a sum moves Krylov counts
JAX_COUNTS = {"heat2d": {"nst": 173, "nli": 1006}, "foodweb": {"nst": 43, "nli": 102}}
KRYLOV = ("nst", "nni", "nli", "nps", "ncfl", "netf", "ncfn", "nje")


def heat2d_opts() -> IdaOptions:
    return IdaOptions(linear_solver="spgmr", mxstep=20000)


def foodweb_opts() -> IdaOptions:
    return IdaOptions(linear_solver="spgmr", mxstep=5000, krylov_maxl=12, krylov_max_restarts=10)


def krylov_counts(st) -> dict:
    return {f: int(getattr(st, f).sum()) for f in KRYLOV}


def heat2d_ida(device) -> IDA:
    u0, up0 = heat2d_ic(HEAT_M)
    return IDA(heat2d_problem(HEAT_M, device=device), u0, up0,
               tol_ss(1e-5, 1e-8, device=device), heat2d_opts(), device=device)


def phase_heat2d_spgmr() -> None:
    """One 100 x 100 instance through ``IDA`` (bench.py::run_heat2d), held
    against the port's CPU run of the same solve."""
    ida = heat2d_ida("cuda")
    wall = wall_s(lambda: ida.solve(HEAT_TOUT))
    got = krylov_counts(ida.state)
    cpu = heat2d_ida("cpu")
    t0 = time.perf_counter()
    cpu.solve(HEAT_TOUT)
    cpu_wall = time.perf_counter() - t0
    # WRMS of the difference under the card run's own weights
    yy, ewt = ida.state.yy.cpu(), ida.state.ewt.cpu()
    wrms = float(torch.sqrt(torch.mean(((yy - cpu.state.yy) * ewt) ** 2)))
    emit("heat2d_spgmr", grid=f"{HEAT_M}x{HEAT_M}", n=HEAT_M * HEAT_M, tout=HEAT_TOUT,
         gs="modified", wall_s=wall, steps_per_s=got["nst"] / wall, **got,
         cpu=krylov_counts(cpu.state), cpu_wall_s=cpu_wall, wrms_card_vs_cpu=wrms,
         ida_tpu_tpu_run=JAX_COUNTS["heat2d"])
    check(ida.get_current_time() >= HEAT_TOUT, "heat2d_spgmr: did not reach tout")
    check(got["nje"] == 0 and got["nli"] > 0, f"heat2d_spgmr: nje {got['nje']}, nli {got['nli']}")
    check(bool(torch.isfinite(ida.state.yy).all()), "heat2d_spgmr: yy not finite")
    check(wrms < 1.0, f"heat2d_spgmr: card vs CPU WRMS {wrms}")


def phase_heat2d_batched() -> None:
    """B = 64 instances, u0 x linspace(0.9, 1.1, B), batch-native
    ``ensemble_init`` + ``core.solve`` (bench.py::run_heat2d_batched)."""
    u0, up0 = heat2d_ic(HEAT_M)
    prob = heat2d_problem(HEAT_M)
    opts = heat2d_opts()
    tol = tol_ss(1e-5, 1e-8)
    scales = np.linspace(0.9, 1.1, HEAT_B)

    st0 = to_native(ensemble_init(lambda p: prob, scales[:, None], u0[None] * scales[:, None],
                                  up0[None] * scales[:, None], opts=opts))
    out = {}
    wall = wall_s(lambda: out.update(r=core_solve(st0, prob, opts, tol, HEAT_TOUT)))
    st, tret, istate = out["r"]
    nst = int(st.nst.sum())
    # the device's busy share over a short steady window: one more internal
    # step of every lane from the end state, three times (a few thousand
    # events, which the profiler digests in seconds)
    busy = device_busy(lambda: core_solve(st, prob, opts, tol, 1.0, TASK_ONE_STEP), calls=3)
    emit("heat2d_batched", grid=f"{HEAT_M}x{HEAT_M}", batch=HEAT_B, tout=HEAT_TOUT, wall_s=wall,
         total_steps=nst, agg_steps_per_s=nst / wall, **krylov_counts(st),
         lanes_success=int((istate == C.SUCCESS).sum()), busy_window="one step from the end state",
         **busy)
    check(bool((istate == C.SUCCESS).all()), "heat2d_batched: a lane is not SUCCESS")
    check(bool(torch.isfinite(st.yy).all()), "heat2d_batched: yy not finite")


def predator_ratio_err(yy: np.ndarray) -> float:
    """max |c_pred / (EE c_prey) - 1| (tests/test_foodweb.py:24-33)."""
    c = yy.reshape(-1, 2)
    return float(np.abs(c[:, 1] / (foodweb.EE * c[:, 0]) - 1.0).max())


def phase_foodweb() -> dict:
    """One 20 x 20 instance through ``IDA``: calc_ic("ya_ydp"), then the
    four legs of bench.py::run_foodweb."""
    c0, cp0 = foodweb_ic(FOOD_M, FOOD_M)
    ida = IDA(foodweb_problem(FOOD_M, FOOD_M), c0, cp0, tol_ss(1e-5, 1e-5), foodweb_opts())
    small_lu.reset_launch_counts()
    ic_wall = wall_s(lambda: ida.calc_ic("ya_ydp", tout1=FOOD_TOUTS[0]))
    ic_err = predator_ratio_err(ida.get_consistent_ic()[0])
    statuses = []
    wall = wall_s(lambda: statuses.extend(ida.solve(t)[1].name for t in FOOD_TOUTS))
    launches = lu_launches()
    got = krylov_counts(ida.state)
    end_err = predator_ratio_err(ida.get_yy())
    emit("foodweb", grid=f"{FOOD_M}x{FOOD_M}", n=2 * FOOD_M * FOOD_M, calc_ic_wall_s=ic_wall,
         legs_wall_s=wall, steps_per_s=got["nst"] / wall, statuses=statuses, **got,
         predator_ratio_err_ic=ic_err, predator_ratio_err_end=end_err, lu_launches=launches,
         ida_tpu_tpu_run=JAX_COUNTS["foodweb"])
    check(statuses == ["Success"] * 4, f"foodweb: {statuses}")
    check(ic_err < 1e-3 and end_err < 1e-2, f"foodweb: predator ratio {ic_err}, {end_err}")
    check(got["nje"] == 0 and got["nps"] > 0, f"foodweb: nje {got['nje']}, nps {got['nps']}")
    check(launches["factor"] > 0 and launches["solve"] > 0, f"foodweb: LU kernels {launches}")
    return {"launches": launches, "counters": got}


def phase_foodweb_batched() -> dict:
    """B = 128 instances, prey x linspace(0.95, 1.05, B): batch-native
    calc_ic, then the four legs (bench.py::run_foodweb_batched)."""
    c0, cp0 = foodweb_ic(FOOD_M, FOOD_M)
    prob = foodweb_problem(FOOD_M, FOOD_M)
    opts = foodweb_opts()
    tol = tol_ss(1e-5, 1e-5)
    ids = prob.id.cpu().numpy()
    scales = np.linspace(0.95, 1.05, FOOD_B)
    c0b = np.stack([c0 * np.where(ids, s, 1.0) for s in scales])
    st = to_native(ensemble_init(lambda p: prob, scales[:, None], c0b, np.tile(cp0, (FOOD_B, 1)),
                                 opts=opts))
    small_lu.reset_launch_counts()
    out = {}
    ic_wall = wall_s(lambda: out.update(ic=core_calc_ic(st, prob, opts, tol, IC_YA_YDP_INIT,
                                                        FOOD_TOUTS[0])))
    st, ok = out["ic"]
    ic_launches = lu_launches()
    ists = []

    def legs():
        nonlocal st
        for t in FOOD_TOUTS:
            st, _, ist = core_solve(st, prob, opts, tol, t)
            ists.append(ist)

    wall = wall_s(legs)
    launches = lu_launches()
    nst = int(st.nst.sum())
    lanes_ok = int((ok & torch.stack(ists).eq(C.SUCCESS).all(dim=0)).sum())
    emit("foodweb_batched", grid=f"{FOOD_M}x{FOOD_M}", batch=FOOD_B, calc_ic_wall_s=ic_wall,
         legs_wall_s=wall, total_steps=nst, agg_steps_per_s=nst / wall, **krylov_counts(st),
         lanes_ok=lanes_ok, calc_ic_ok=int(ok.sum()), lu_launches_calc_ic=ic_launches,
         lu_launches=launches, predator_ratio_err_end=predator_ratio_err(st.yy.t().cpu().numpy()))
    check(lanes_ok == FOOD_B, f"foodweb_batched: {FOOD_B - lanes_ok} lanes not ok and SUCCESS")
    check(launches["factor"] > 0 and launches["solve"] > 0, f"foodweb_batched: LU kernels {launches}")
    return {"launches": launches, "state": st}


# kernel_variants.prec_solve_events of this checkout, each in a fresh
# process, by dtype: started by start_prec_events, ahead of the phases that
# read them
PREC_EVENTS: dict = {}


def start_prec_events() -> None:
    """Start the fresh processes that profile one foodweb.prec_solve in
    float64 (kernels_n2) and in float32 (foodweb_mixed), one after the
    other on a thread, while the phases before those run."""
    pool = ThreadPoolExecutor(1)
    for dtype in ("float64", "float32"):
        PREC_EVENTS[dtype] = pool.submit(kernel_variants.prec_solve_events,
                                         str(Path(__file__).resolve().parent), dtype)
    pool.shutdown(wait=False)


def prec_events(dtype: str) -> dict:
    """The profile of one prec_solve in ``dtype``, which start_prec_events
    started."""
    return PREC_EVENTS.pop(dtype).result()


def phase_kernels_n2(food: dict) -> dict:
    """K1 at N = 2 on the foodweb blocks of one lsetup, both batch axes
    ([2, 2, 400, 128]): kernel against its plain version bit for bit, its
    device time, its bound and torch.linalg's time on the same blocks. The
    solve is held and timed on three layouts: batch-last contiguous,
    ``ida_tpu``'s pdata (lu [400, 2, 2, 128], piv [400, 2, 128], r [800,
    128], as a checkpoint loads them) and the views ``foodweb.prec_solve``
    hands it on the path; then one ``prec_solve`` call (profiled in a fresh
    process) must be one device event, the solve."""
    st = food["state"]
    # at the last legs' state, with each lane's cj of its last lsetup
    blocks = foodweb.prec_blocks(FOOD_M, FOOD_M, st.cjold, st.yy)
    r = st.yy.clone()  # [800, 128], a right-hand side in the path's layout
    rb = r.reshape((FOOD_M * FOOD_M, 2, FOOD_B)).movedim(1, 0).contiguous()
    f, g = small_lu.lu_factor(blocks), dense_lu.lu_factor_unrolled(blocks)
    pdata_f = dense_lu.DenseLU(f.lu.movedim((0, 1), (1, 2)).contiguous().movedim((1, 2), (0, 1)),
                               f.piv.movedim(0, 1).contiguous().movedim(1, 0), None)
    layouts = {  # name -> (factors, right-hand side)
        "contiguous": (f, rb),
        "pdata": (pdata_f, r.reshape(rb.shape[1], 2, FOOD_B).movedim(1, 0)),
        "prec_solve": (f, r.reshape(rb.shape[1], 2, FOOD_B).movedim(1, 0)),
    }
    x = {k: small_lu.lu_solve(*v) for k, v in layouts.items()}
    y = dense_lu.lu_solve_unrolled(g, rb)
    torch.cuda.synchronize()
    ok = {"factor": same(f.lu, g.lu) and same(f.piv, g.piv) and same(f.fail_col, g.fail_col),
          **{f"solve_{k}": same(v.contiguous(), y) for k, v in x.items()}}
    errs = {"factor": float((f.lu - g.lu).abs().max()),
            "solve": max(float((v - y).abs().max()) for v in x.values())}
    m = blocks[0, 0].numel()
    # cold, as at N = 3: 64 input sets in turn move ~240 MB a pass, five
    # times the L2, so every launch reads its input from HBM
    sets = [(blocks.clone(), rb.clone()) for _ in range(64)]
    f_sets = [small_lu.lu_factor(a) for a, _ in sets]
    dev_ms = {
        "factor": kernel_device_ms([lambda a=a: small_lu.lu_factor(a) for a, _ in sets], 2,
                                   "factor_kernel"),
    }
    for k, (h0, b0) in layouts.items():
        like = [(dense_lu.DenseLU(h0.lu.clone(memory_format=torch.preserve_format),
                                  h0.piv.clone(memory_format=torch.preserve_format), None),
                 b0.clone(memory_format=torch.preserve_format)) for _ in range(64)]
        dev_ms[f"solve_{k}"] = kernel_device_ms([lambda h=h, b=b: small_lu.lu_solve(h, b)
                                                 for h, b in like], 2, "solve_kernel")
        del like
    plain_ms = {"factor": cuda_ms(lambda: dense_lu.lu_factor_unrolled(blocks), 20),
                "solve": cuda_ms(lambda: dense_lu.lu_solve_unrolled(g, rb), 20)}
    # the library yardstick (never called by the port), batch-leading, cold
    # by the same protocol
    lead = [(a.reshape(2, 2, m).permute(2, 0, 1).contiguous(),
             b.reshape(2, m).t().contiguous().unsqueeze(-1)) for a, b in sets]
    f_lead = [torch.linalg.lu_factor_ex(a)[:2] for a, _ in lead]
    lib_ms = {"factor": call_device_ms([lambda a=a: torch.linalg.lu_factor_ex(a) for a, _ in lead], 2),
              "solve": call_device_ms([lambda h=h, b=b: torch.linalg.lu_solve(h[0], h[1], b)
                                       for h, (_, b) in zip(f_lead, lead)], 2)}
    del sets, f_sets, lead, f_lead
    nbytes = {"factor": 4 * m * 8 + 4 * m * 8 + 2 * m * 4 + m * 4,
              "solve": 4 * m * 8 + 2 * m * 4 + 2 * m * 8 + 2 * m * 8}
    # one foodweb.prec_solve on the card, profiled in a fresh process: late
    # in this run the profiler records only some launches of a short window,
    # or none (the layouts it hands the kernel are held above)
    prec = prec_events("float64")
    # "ms" of the solve is the layout the path launches it on
    rows = {
        "factor": {"max_abs_err": errs["factor"], "ms": dev_ms["factor"],
                   "plain_ms": plain_ms["factor"], "bound_ms": lu_bound_ms(nbytes["factor"]),
                   "bound_by": "bytes", "library_ms": lib_ms["factor"]},
        "solve": {"max_abs_err": errs["solve"], "ms": dev_ms["solve_prec_solve"],
                  "ms_contiguous": dev_ms["solve_contiguous"],
                  "ms_pdata_layout": dev_ms["solve_pdata"], "plain_ms": plain_ms["solve"],
                  "bound_ms": lu_bound_ms(nbytes["solve"]), "bound_by": "bytes",
                  "library_ms": lib_ms["solve"],
                  "prec_solve_device_events_per_call": prec["device_events_per_call"],
                  "prec_solve_device_ms_per_call": prec["device_ms_per_call"]},
    }
    emit("kernel_n2_foodweb_blocks", shape=list(blocks.shape), systems=m, bitwise_equal=ok,
         bytes=nbytes, layouts={k: small_lu.solve_layout(h.lu, h.piv, b, x[k]).as_dict()
                                for k, (h, b) in layouts.items()},
         prec_solve=prec, **rows)
    check(all(ok.values()), f"K1 at N = 2 != its plain version: {ok}")
    names = list(prec["kernels"])
    check(prec["calls_recorded"] > 0 and len(names) == 1 and "solve_kernel" in names[0],
          f"foodweb.prec_solve is not one K1 solve and nothing else: {prec}")
    return rows


# --------------- constraints, band and BBD, quadratures and checkpoints

C_RTOL = 1e-2  # the constraints probe: Roberts held >= 0 at a loose tolerance
C_ATOL = [1e-5, 1e-3, 1e-3]
# ida_tpu's counts of the probe's nominal lane over 12 decades (its CPU run,
# tests/test_torch_constraints.py), pinned here: this script imports no JAX
C_PROBE = {"nst": 148, "nre": 219}
K2_PR5_MS = 1.025  # the unconstrained K2 headline launch, PERF.md (PR 5's run)
BAND_M = 10  # idaHeat2D_bnd: a 10 x 10 grid, mu = ml = 10
BAND_B = 4096
BAND_BIG_M = 100  # one band factor and solve at heat2d 100 x 100, mu = ml = 100
BBD_M = 20  # idaHeat2D_kry_bbd_p: 20 x 20 on 4 subdomains (strips of 5 grid rows)
BBD_B = 256
BBD_TOUT = 0.01  # the first of the heat legs' outputs (0.01, 0.04, 0.16)
BAND_TOUT = 0.04  # band_heat2d's horizon: the second of them
CHECKPOINT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def constrained(st):
    return st._replace(constraints=torch.ones_like(st.constraints),
                       constraints_set=torch.ones_like(st.constraints_set))


def constrained_stage_states():
    """Mid-flight states of the probe (B_SMALL lanes, every y >= 0): after
    step 2, where the next Newton iterate dips below zero by less than the
    Newton tolerance (the correction is pulled back inside), and after step
    72 with h x16, where it dips by more (the attempt fails)."""
    params, yy0, yp0 = ensemble_inputs(B_SMALL)
    st = constrained(ensemble_init(roberts_factory, params, yy0, yp0, device="cuda"))
    tol = tol_sv(C_RTOL, C_ATOL, device="cuda")
    fn = make_ensemble_solve(roberts_factory, itask=TASK_ONE_STEP)
    snaps = {}
    for k in range(1, 73):
        st, _, _ = fn(st, params, tol, 4.0e10)
        if k == 2:
            snaps["step2"] = to_native(st)
    last = to_native(st)
    snaps["step72_hh_x16"] = last._replace(hh=last.hh * 16.0)
    return torch.as_tensor(params, device="cuda").t().contiguous(), tol, snaps


def phase_constrained_stages() -> dict:
    """K5 on constrained states: each stage kernel bit for bit its eager
    stage (the chain inside one attempt, and the attempt, stop tests and
    interpolation on the state itself), with the block biting both ways."""
    params, tol, snaps = constrained_stage_states()
    fused_stages.reset_launch_counts()
    fails, errs, kinds = {}, {}, {}

    def compare(name, stage, st, aux=None):
        st_e, out_e = fused_stages.plain_stage(stage, st, params, tol, 4.0e10, aux)
        st_k, out_k = fused_stages.run_stage(stage, st, params, tol, 4.0e10, aux=aux)
        torch.cuda.synchronize()
        diff = first_difference(st_k, st_e, out_k, out_e)
        if diff is not None:
            fails[f"{name}/{stage}"] = diff
        errs[stage] = max(errs.get(stage, 0.0), max_abs_diff(st_k, st_e, out_k, out_e))
        return st_e, out_e

    for name, st in snaps.items():
        for stage in ("attempt", "stoptest", "getsol"):
            compare(name, stage, st)
        s1, o1 = compare(name, "set_coeffs", st)
        s2, o2 = compare(name, "nls", s1._replace(tn=s1.tn + s1.hh))
        s3, o3 = compare(name, "error_test", s2, {"ck": o1["ck"]})
        compare(name, "complete_step", s3, {"err_k": o3["err_k"], "err_km1": o3["err_km1"],
                                            "ck": o1["ck"]})
        nl = o2["nl_status"]
        kinds[name] = {"rec_constraint": int((nl == C.REC_CONSTRAINT).sum()),
                       # an iterate below zero that passed: its correction was
                       # pulled back inside (the eager block changes ee only)
                       "pulled_back": int(((s2.yy < 0).any(dim=0) & (nl == C.REC_NONE)).sum())}
    launches = {k: v for k, v in fused_stages.STAGE_LAUNCHES.items() if v}
    emit("constrained_stages", batch=B_SMALL, rtol=C_RTOL, atol=C_ATOL, checks=7 * len(snaps),
         first_differences=fails, nls_kinds=kinds, launches=launches, max_abs_err=errs)
    check(not fails, f"stage kernels differ from the eager stages on constrained states: {fails}")
    check(kinds["step72_hh_x16"]["rec_constraint"] > 0, "no REC_CONSTRAINT among the stage inputs")
    check(kinds["step2"]["pulled_back"] > 0, "no pulled-back correction among the stage inputs")
    check(len(launches) == 7, f"stage launches {launches}")
    return {"launches": launches, "max_abs_err": errs}


def constrained_chain(st0, fn_by_route: dict) -> dict:
    """Each route over the 12 decades from ``st0``: per route its result at
    each output time and the wall of all 12 calls."""
    out = {}
    for route, fn in fn_by_route.items():
        st, rows = st0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tout in DECADES:
            st, tret, ist = fn(st, tout)
            rows.append((st, tret, ist))
        torch.cuda.synchronize()
        out[route] = {"rows": rows, "wall_s": time.perf_counter() - t0}
    return out


def phase_constrained_headline() -> dict:
    """The headline's B = 65,536 lanes held >= 0 at rtol 1e-2 over 12
    decades, through the eager solve, K2 and K3/K4 at budgets 32 and 7: the kernels
    bit for bit the eager solve at every output, every y >= 0 to the rounding
    of the constraint's correction (-eps * atol), the nominal lane's exactly
    and with ida_tpu's 148 steps and 219 residual evaluations."""
    params, yy0, yp0 = ensemble_inputs(B)
    st0 = constrained(ensemble_init(roberts_factory, params, yy0, yp0, device="cuda"))
    p_b = on_card(params)
    tol = tol_sv(C_RTOL, C_ATOL, device="cuda")
    eager = make_ensemble_solve(roberts_factory)
    k2 = fused_solve.make_fused_solve(roberts_factory, tol)
    # budget 32 (the headline's), and 7: a decade of this probe takes fewer
    # than 32 attempts, so only the smaller budget resumes (K4)
    k34 = fused_solve.make_fused_solve(roberts_factory, tol, attempt_budget=32)
    k34_b7 = fused_solve.make_fused_solve(roberts_factory, tol, attempt_budget=7)
    routes = {"eager": lambda st, t: eager(st, params, tol, t),
              "k2": lambda st, t: k2(st, p_b, t), "k34": lambda st, t: k34(st, p_b, t),
              "k34_b7": lambda st, t: k34_b7(st, p_b, t)}
    for fn in routes.values():  # warm-up
        fn(st0, DECADES[0])
    small_lu.reset_launch_counts()
    fused_solve.reset_launch_counts()
    runs = constrained_chain(st0, routes)
    lu_l = lu_launches()
    launches = {"k2": fused_solve.launch_count("solve"), "init": fused_solve.launch_count("init"),
                "cont": fused_solve.launch_count("cont")}
    # IDA holds the constraints on the Newton iterates, to the rounding of the
    # correction that pulls a small violation back: late decades, where y1
    # and y2 are ~0, give values of -1e-37 to -1e-22 in ida_tpu run op by op
    # as here (one such lane checked on the CPU). The gate: every output
    # above -eps * atol, and exactly >= 0 for the nominal lane
    floor = -torch.finfo(torch.float64).eps * torch.tensor(C_ATOL, device="cuda")
    differ, negative, below_floor, ok_lanes, y_min = [], 0, 0, B, 0.0
    for k, tout in enumerate(DECADES):
        est, etret, eist = runs["eager"]["rows"][k]
        for route in ("k2", "k34", "k34_b7"):
            st, tret, ist = runs[route]["rows"][k]
            fields = [f for f in est._fields if isinstance(getattr(est, f), torch.Tensor)
                      and not same(getattr(st, f), getattr(est, f))]
            if not (same(tret, etret) and same(ist, eist)):
                fields.append("tret/istate")
            differ += [f"{route} decade {k}: {f}" for f in fields]
        negative += int((est.yy < 0).any(dim=1).sum())
        below_floor += int((est.yy < floor).any(dim=1).sum())
        y_min = min(y_min, float(est.yy.min()))
        ok_lanes = min(ok_lanes, int((eist == C.SUCCESS).sum()))
    est = runs["eager"]["rows"][-1][0]
    totals = counter_totals(est)
    err = max(max_abs_diff(runs[r]["rows"][-1][0], est) for r in ("k2", "k34", "k34_b7"))

    # the nominal lane alone (B = 1), eager and K2
    one = constrained(ensemble_init(roberts_factory, ROBERTS_PARAMS[None], ROBERTS_YY0[None],
                                    ROBERTS_YP0[None], device="cuda"))
    lane = constrained_chain(one, {
        "eager": lambda st, t: eager(st, ROBERTS_PARAMS[None], tol, t),
        "k2": lambda st, t: k2(st, on_card(ROBERTS_PARAMS[None]), t)})
    nominal = {r: {f: int(getattr(lane[r]["rows"][-1][0], f)[0]) for f in ("nst", "nre")}
               for r in lane}
    nominal_min_y = min(float(row[0].yy.min()) for row in lane["eager"]["rows"])
    lane_same = not [f for f in one._fields if isinstance(getattr(one, f), torch.Tensor)
                     and not same(getattr(lane["k2"]["rows"][-1][0], f),
                                  getattr(lane["eager"]["rows"][-1][0], f))]

    # K2 from the start to tout = 400 at the probe's tolerances, constrained,
    # beside the same lanes without constraints (CUDA events, 3 each, in turns)
    tol_in = fused_solve.tol_inputs(tol, 3, 1, torch.float64, torch.device("cuda"))
    st_free = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    k2_ms, free_ms = [], []
    for _ in range(3):
        free_ms.append(bare_launch_ms(st_free, p_b, tol_in))
        k2_ms.append(bare_launch_ms(st0, p_b, tol_in))
    ptxas = solve_kernel_ptxas()
    emit("constrained_headline", batch=B, rtol=C_RTOL, atol=C_ATOL, decades=len(DECADES),
         walls_s={r: runs[r]["wall_s"] for r in runs}, lanes_success_min=ok_lanes,
         outputs_with_negative_y=negative, outputs_below_minus_eps_atol=below_floor,
         min_output_y=y_min, nominal_lane_min_y=nominal_min_y, fields_differ=differ[:8],
         launches=launches,
         lu_launches=lu_l, max_abs_err=err, nominal_lane=nominal, nominal_pinned=C_PROBE,
         nominal_lane_k2_equals_eager=lane_same,
         k2_to_400_ms={"constrained": k2_ms, "same_lanes_unconstrained": free_ms},
         k2_headline_pr5_ms=K2_PR5_MS,
         solve_kernel_ptxas=ptxas, steps_per_s_eager=totals["nst"] / runs["eager"]["wall_s"],
         **totals)
    check(not differ, f"constrained_headline: the kernels differ from the eager solve: {differ[:8]}")
    check(ok_lanes == B, f"constrained_headline: {B - ok_lanes} lanes not SUCCESS")
    check(below_floor == 0, f"constrained_headline: {below_floor} outputs below -eps * atol")
    check(nominal_min_y >= 0.0, f"constrained_headline: the nominal lane's y {nominal_min_y}")
    check(all(v == C_PROBE for v in nominal.values()), f"nominal lane {nominal} != {C_PROBE}")
    check(lane_same, "constrained_headline: the nominal lane's K2 state != eager")
    check(launches["k2"] == 12 and launches["init"] == 24 and launches["cont"] > 0,
          f"constrained_headline: kernel launches {launches}")
    check(lu_l["factor"] > 0 and lu_l["solve"] > 0, f"LU kernels not launched: {lu_l}")
    return {"launches": launches, "lu_launches": lu_l, "k2_ms": statistics.median(k2_ms)}


class OpCounter(TorchDispatchMode):
    """Counts the operators dispatched to a kernel (views, which launch
    nothing, left out): about the kernel launches of eager code."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn) -> int:
    with OpCounter() as counter:
        fn()
    return counter.ops


def heat2d_band_opts(m) -> IdaOptions:
    return IdaOptions(linear_solver="band", band_mu=m, band_ml=m, mxstep=20000)


def heat2d_lanes(m, bsz, opts, prob):
    """``bsz`` heat2d instances, u0 x linspace(0.9, 1.1, bsz), batch-native on
    the card (bench.py::run_heat2d_batched's sweep), the middle lane at
    scale 1 (the single lane's own problem)."""
    u0, up0 = heat2d_ic(m)
    scales = np.linspace(0.9, 1.1, bsz)
    scales[bsz // 2] = 1.0
    return scales, to_native(ensemble_init(lambda p: prob, scales[:, None],
                                           u0[None] * scales[:, None], up0[None] * scales[:, None],
                                           opts=opts, device="cuda"))


def cpu_lanes(m, scales, opts, prob_cpu, lanes, tout, tol_args):
    """The same lanes on the CPU (lanes are independent, so a batch of a few
    gives each lane's own result)."""
    u0, up0 = heat2d_ic(m)
    sc = scales[lanes]
    st = to_native(ensemble_init(lambda p: prob_cpu, sc[:, None], u0[None] * sc[:, None],
                                 up0[None] * sc[:, None], opts=opts, device="cpu"))
    return core_solve(st, prob_cpu, opts, tol_ss(*tol_args, device="cpu"), tout)


def wrms_lanes(y, y_ref, rtol, atol) -> float:
    """Largest WRMS over lanes of y - y_ref ([N, lanes]) under weights of
    y_ref."""
    w = 1.0 / (rtol * y_ref.abs() + atol)
    return float(torch.sqrt(torch.mean(((y - y_ref) * w) ** 2, dim=0)).max())


def phase_band_heat2d() -> None:
    """heat2d at idaHeat2D_bnd's grid (10 x 10, mu = ml = 10) on the band
    solver: one lane through ``IDA`` (on the card, and against it the band
    and the dense solver on the CPU), and B = 4,096 lanes batch-native."""
    m = BAND_M
    opts = heat2d_band_opts(m)
    u0, up0 = heat2d_ic(m)
    idas, walls = {}, {}
    for name, dev, o in (("band", "cuda", opts), ("band_cpu", "cpu", opts),
                         ("dense_cpu", "cpu", IdaOptions(mxstep=20000))):
        ida = IDA(heat2d_problem(m, use_prec=False, device=dev), u0, up0,
                  tol_ss(1e-5, 1e-8, device=dev), o, device=dev)
        t0 = time.perf_counter()
        ida.solve(BAND_TOUT)  # returns host numbers: synchronizes
        walls[name] = time.perf_counter() - t0
        idas[name] = ida
    got = krylov_counts(idas["band"].state)
    yb = idas["band"].state.yy.cpu().unsqueeze(1)
    wrms_cpu = wrms_lanes(yb, idas["band_cpu"].state.yy.unsqueeze(1), 1e-5, 1e-8)
    wrms_dense = wrms_lanes(yb, idas["dense_cpu"].state.yy.unsqueeze(1), 1e-5, 1e-8)

    prob = heat2d_problem(m, use_prec=False, device="cuda")
    scales, st0 = heat2d_lanes(m, BAND_B, opts, prob)
    out = {}
    wall_b = wall_s(lambda: out.update(r=core_solve(st0, prob, opts,
                                                    tol_ss(1e-5, 1e-8, device="cuda"), BAND_TOUT)))
    st, tret, istate = out["r"]
    lanes = np.linspace(0, BAND_B - 1, 4).astype(int)
    sc, _, ic = cpu_lanes(m, scales, opts, heat2d_problem(m, use_prec=False, device="cpu"),
                          lanes, BAND_TOUT, (1e-5, 1e-8))
    wrms_b = wrms_lanes(st.yy[:, lanes].cpu(), sc.yy, 1e-5, 1e-8)
    nst_b = int(st.nst.sum())
    emit("band_heat2d", grid=f"{m}x{m}", mu=m, ml=m, tout=BAND_TOUT, walls_s=walls, **got,
         cpu=krylov_counts(idas["band_cpu"].state), dense_cpu=krylov_counts(idas["dense_cpu"].state),
         wrms_card_vs_cpu=wrms_cpu, wrms_band_vs_dense=wrms_dense,
         batched={"batch": BAND_B, "wall_s": wall_b, "total_steps": nst_b,
                  "agg_steps_per_s": nst_b / wall_b, "lanes_success": int((istate == C.SUCCESS).sum()),
                  "cpu_lanes": lanes.tolist(), "wrms_card_vs_cpu": wrms_b,
                  **krylov_counts(st)})
    check(idas["band"].get_current_time() >= BAND_TOUT, "band_heat2d: did not reach tout")
    check(got["nje"] > 0 and got["nli"] == 0, f"band_heat2d: nje {got['nje']}, nli {got['nli']}")
    check(wrms_cpu < 1.0 and wrms_dense < 1.0, f"band_heat2d: WRMS {wrms_cpu}, {wrms_dense}")
    check(bool((istate == C.SUCCESS).all()), "band_heat2d: a batched lane is not SUCCESS")
    check(bool((ic == C.SUCCESS).all()) and wrms_b < 1.0, f"band_heat2d batched vs CPU {wrms_b}")


def phase_band_factor_100() -> dict:
    """One band factor and one band solve at heat2d 100 x 100 (n = 10,000,
    mu = ml = 100) on the card, and at 10 x 10: their walls (one call each),
    their dispatched operators (about their kernel launches; the profiler's
    device events beside the count at 10 x 10), and the solve's residual."""
    out = {}
    for m in (BAND_M, BAND_BIG_M):
        prob = heat2d_problem(m, use_prec=False, device="cuda")
        u0, up0 = heat2d_ic(m)
        yy = torch.as_tensor(u0, device="cuda")
        yp = torch.as_tensor(up0, device="cuda")
        zero = torch.zeros((), dtype=torch.float64, device="cuda")
        cj = torch.tensor(6250.0, dtype=torch.float64, device="cuda")  # 1 / the first step
        ab = band_sys_jacobian(prob, zero, cj, yy, yp, m, m)
        rhs = torch.as_tensor(np.random.default_rng(m).standard_normal(m * m), device="cuda")
        res = {}
        walls = {"factor": wall_s(lambda: res.update(f=band_factor(ab, m, m))),
                 "solve": wall_s(lambda: res.update(x=band_solve(res["f"], rhs)))}
        f, x = res["f"], res["x"]
        ops = {"factor": count_ops(lambda: band_factor(ab, m, m)),
               "solve": count_ops(lambda: band_solve(f, rhs))}
        dense = band_to_dense(ab, m, m)
        resid = float((dense @ x - rhs).abs().max() / rhs.abs().max())
        row = {"n": m * m, "walls_s": walls, "dispatched_ops": ops, "relative_residual": resid,
               "fail_col": int(f.fail_col)}
        if m == BAND_M:
            row["device_events"] = {
                "factor": device_busy(lambda: band_factor(ab, m, m), calls=1)["device_events"],
                "solve": device_busy(lambda: band_solve(f, rhs), calls=1)["device_events"]}
        out[f"{m}x{m}"] = row
        check(resid < 1e-10 and int(f.fail_col) == 0, f"band {m}x{m}: residual {resid}")
        del dense
    emit("band_factor_solve", mu_ml="m", **out)
    return out


def bbd_problem(m, device):
    base = heat2d_problem(m, use_prec=False, device=device)
    prec = make_bbd_prec(base.res, base.n, m, m, nblocks=4)
    return IdaProblem(n=base.n, res=base.res, id=base.id, jtimes_fn=base.jtimes_fn, **prec.hooks())


def phase_bbd_heat2d() -> None:
    """heat2d 20 x 20 on SPGMR with the BBD preconditioner (mu = ml = 20, 4
    blocks of 5 grid rows): one lane through ``IDA`` on the card, on the CPU,
    and with the diagonal preconditioner; then B = 256 batch-native (each
    lane SUCCESS, its scale-1 lane against the single lane; the check of
    the card against the CPU is the single lane's: a batch of lanes on the
    CPU costs what one does, ~20 s)."""
    m = BBD_M
    opts = IdaOptions(linear_solver="spgmr", mxstep=20000)
    u0, up0 = heat2d_ic(m)
    idas, walls = {}, {}
    for name, dev, prob in (("bbd", "cuda", bbd_problem(m, "cuda")),
                            ("bbd_cpu", "cpu", bbd_problem(m, "cpu")),
                            ("diag", "cuda", heat2d_problem(m, device="cuda"))):
        ida = IDA(prob, u0, up0, tol_ss(1e-5, 1e-8, device=dev), opts, device=dev)
        t0 = time.perf_counter()
        ida.solve(BBD_TOUT)  # returns host numbers: synchronizes
        walls[name] = time.perf_counter() - t0
        idas[name] = ida
    got = krylov_counts(idas["bbd"].state)
    yb = idas["bbd"].state.yy.cpu().unsqueeze(1)
    wrms_cpu = wrms_lanes(yb, idas["bbd_cpu"].state.yy.unsqueeze(1), 1e-5, 1e-8)
    wrms_diag = wrms_lanes(yb, idas["diag"].state.yy.cpu().unsqueeze(1), 1e-5, 1e-8)

    prob = bbd_problem(m, "cuda")
    scales, st0 = heat2d_lanes(m, BBD_B, opts, prob)
    out = {}
    wall_b = wall_s(lambda: out.update(r=core_solve(st0, prob, opts,
                                                    tol_ss(1e-5, 1e-8, device="cuda"), BBD_TOUT)))
    st, tret, istate = out["r"]
    nst_b = int(st.nst.sum())
    wrms_mid = wrms_lanes(st.yy[:, BBD_B // 2:BBD_B // 2 + 1].cpu(), yb, 1e-5, 1e-8)
    emit("bbd_heat2d", grid=f"{m}x{m}", mu=m, ml=m, nblocks=4, tout=BBD_TOUT, walls_s=walls,
         **got, cpu=krylov_counts(idas["bbd_cpu"].state), diag=krylov_counts(idas["diag"].state),
         wrms_card_vs_cpu=wrms_cpu, wrms_bbd_vs_diag=wrms_diag,
         batched={"batch": BBD_B, "wall_s": wall_b, "total_steps": nst_b,
                  "agg_steps_per_s": nst_b / wall_b, "lanes_success": int((istate == C.SUCCESS).sum()),
                  "wrms_scale_1_lane_vs_single": wrms_mid, **krylov_counts(st)})
    check(idas["bbd"].get_current_time() >= BBD_TOUT, "bbd_heat2d: did not reach tout")
    check(got["nps"] > 0 and got["nje"] == 0, f"bbd_heat2d: nps {got['nps']}, nje {got['nje']}")
    check(wrms_cpu < 1.0 and wrms_diag < 1.0, f"bbd_heat2d: WRMS {wrms_cpu}, {wrms_diag}")
    check(bool((istate == C.SUCCESS).all()), "bbd_heat2d: a batched lane is not SUCCESS")
    check(wrms_mid < 1.0, f"bbd_heat2d: the batch's scale-1 lane against the single lane {wrms_mid}")


def quad_factory(p):
    """Roberts with the quadratures [y1 + y2 + y3, y1]."""
    return dataclasses.replace(
        roberts_factory(p), quad=lambda t, yy, yp: torch.stack([yy[0] + yy[1] + yy[2], yy[0]]),
        nquad=2)


def phase_quadrature_headline(eager: dict) -> dict:
    """The headline with quadratures attached, eager: every field but yQ the
    quadrature-free headline's bit for bit, yQ[0] = tn (the integral of
    y1 + y2 + y3 = 1) in every lane, and ``IDA.get_quad`` on one lane."""
    params, yy0, yp0 = ensemble_inputs(B)
    tol = tol_sv(1e-4, ATOL, device="cuda")
    fn = make_ensemble_solve(quad_factory)
    st0 = ensemble_init(quad_factory, params, yy0, yp0, device="cuda")
    small_lu.reset_launch_counts()
    out = {}
    wall = wall_s(lambda: out.update(r=fn(st0, params, tol, TOUT)))
    lu_l = lu_launches()
    st, tret, istate = out["r"]
    est = eager["result"][0]
    differ = [f for f in st._fields if f != "yQ" and isinstance(getattr(st, f), torch.Tensor)
              and not same(getattr(st, f), getattr(est, f))]
    q_err = float(((st.yQ[:, 0] - st.tn).abs() / st.tn.clamp(min=1.0)).max())

    # one lane (the last) through IDA: its yQ and get_quad at tret
    lane = B - 1
    ida = IDA(quad_factory(torch.as_tensor(params[lane], device="cuda")), yy0[lane], yp0[lane],
              tol, device="cuda")
    ida.solve(TOUT)
    lane_same = bool(same(ida.state.yQ, st.yQ[lane]))
    q_ida = ida.get_quad()
    q_core = get_quad(to_native(st), quad_factory(on_card(params).t().contiguous()),
                      tret)[:, lane].cpu().numpy()
    emit("quadrature_headline", batch=B, tout=TOUT, nquad=2, wall_s=wall,
         eager_no_quad_wall_s=eager["wall_s"], fields_differ=differ,
         max_rel_err_yq0_vs_tn=q_err, lane=lane, ida_yq_equals_lane=lane_same,
         ida_get_quad=q_ida.tolist(), core_get_quad=q_core.tolist(), lu_launches=lu_l,
         lanes_success=int((istate == C.SUCCESS).sum()))
    check(not differ, f"quadrature_headline: fields other than yQ differ: {differ}")
    check(q_err < 1e-9, f"quadrature_headline: yQ[0] off tn by {q_err} (relative)")
    check(lane_same and np.array_equal(q_ida, q_core), "quadrature_headline: IDA.get_quad lane")
    check(bool((istate == C.SUCCESS).all()), "quadrature_headline: a lane is not SUCCESS")
    return {"lu_launches": lu_l, "result": out["r"], "wall_s": wall, "lane": lane,
            "ida_get_quad": q_ida}


def phase_checkpoint_resume() -> dict:
    """The headline saved at tout 0.4, loaded back onto the card and solved to
    400: bit for bit the solve that was never interrupted."""
    params, yy0, yp0 = ensemble_inputs(B)
    tol = tol_sv(1e-4, ATOL, device="cuda")
    fn = make_ensemble_solve(roberts_factory)
    st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    small_lu.reset_launch_counts()
    mid, _, _ = fn(st0, params, tol, 0.4)
    straight, stret, sist = fn(mid, params, tol, TOUT)
    CHECKPOINT_DIR.mkdir(parents=True, exist_ok=True)
    path = CHECKPOINT_DIR / "headline_0.4.npz"
    t0 = time.perf_counter()
    save_state(str(path), mid)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_state(str(path), device="cuda")
    load_s = time.perf_counter() - t0
    resumed, rtret, rist = fn(back, params, tol, TOUT)
    torch.cuda.synchronize()
    lu_l = lu_launches()
    loaded_differ = [f for f in mid._fields if isinstance(getattr(mid, f), torch.Tensor)
                     and not same(getattr(back, f), getattr(mid, f))]
    differ = [f for f in straight._fields if isinstance(getattr(straight, f), torch.Tensor)
              and not same(getattr(resumed, f), getattr(straight, f))]
    nbytes = path.stat().st_size
    path.unlink()
    emit("checkpoint_resume", batch=B, saved_at=0.4, tout=TOUT, archive_bytes=nbytes,
         save_s=save_s, load_s=load_s, loaded_on=str(back.phi.device),
         loaded_fields_differ=loaded_differ, resumed_fields_differ=differ, lu_launches=lu_l)
    check(back.phi.is_cuda, "checkpoint_resume: the state did not load onto the card")
    check(not loaded_differ, f"checkpoint_resume: the loaded state differs: {loaded_differ}")
    check(not differ and same(rtret, stret) and same(rist, sist),
          f"checkpoint_resume: resumed != uninterrupted: {differ}")
    return {"lu_launches": lu_l}


# --------------------------------------------- sensitivities (the adjoints)

ADJ_B = 4096  # bench.py::run_adjoint_batched (bench.py:517-559)
ADJ_CONT_B = 1024  # bench.py::run_adjoint_continuous (bench.py:562-611)
ADJ_TOUT = 4.0
ADJ_ATTEMPTS = 120
ADJ_W = [1.0, 2.0, 3.0]
ADJ_GRID = np.logspace(-4, np.log10(ADJ_TOUT), 64)
ADJ_LANES = 8  # spread lanes held against the CPU and central differences
T_SOURCE = LU_SOURCE


def adjoint_params(b: int) -> np.ndarray:
    return np.outer(np.exp(np.linspace(-0.05, 0.05, b)), ROBERTS_PARAMS)


def adjoint_maps(device):
    """``bench.py``'s per-lane maps and loss <[1, 2, 3], y(tout)>."""
    yy0 = torch.tensor(ROBERTS_YY0, dtype=torch.float64, device=device)
    dirn = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float64, device=device)
    w = torch.tensor(ADJ_W, dtype=torch.float64, device=device)
    return (lambda p: yy0), (lambda p: p[0] * dirn), (lambda y: (y * w).sum())


def run_adjoint_batched(params, device, opts=None):
    yy0_of, yp0_of, loss_of = adjoint_maps(device)
    return sensitivity.batched_adjoint_gradient(
        roberts_factory, params, yy0_of, yp0_of, tol_sv(1e-4, ATOL, device=device), ADJ_TOUT,
        loss_of, opts=opts, max_attempts=ADJ_ATTEMPTS, device=device)


def adjoint_forward(params, device, opts=IdaOptions(unroll_newton=True), tout=ADJ_TOUT):
    """The eager forward solve of the lanes ``params`` [B, P] (the adjoint's
    primal): the batch-native state."""
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st = to_native(ensemble_init(roberts_factory, params, np.tile(ROBERTS_YY0, (len(params), 1)),
                                 yp0, device=device, opts=opts))
    p = torch.as_tensor(params, dtype=torch.float64, device=device).t().contiguous()
    tol = tol_sv(1e-4, ATOL, device=device)
    out = core_solve(st, roberts_factory(p), opts, _native_shared_tol(tol, st), tout,
                     max_attempts=ADJ_ATTEMPTS)
    return out[0], out[2]


def central_differences(params, eps_rel=1e-6):
    """d<w, y(tout)>/dp of each lane of ``params`` [L, P] by central
    differences on the card (tests/test_adjoint.py:44-50: eps = 1e-6 p_i),
    all 2 P L perturbed lanes in one batch-native eager solve."""
    lanes, n_p = params.shape
    shifted = []
    for sign in (1.0, -1.0):
        for i in range(n_p):
            q = params.copy()
            q[:, i] *= 1.0 + sign * eps_rel
            shifted.append(q)
    st, ist = adjoint_forward(np.concatenate(shifted), "cuda")
    check(bool((ist == C.SUCCESS).all()), "a perturbed lane failed")
    loss = (st.yy * torch.tensor(ADJ_W, dtype=torch.float64, device="cuda")[:, None]).sum(0)
    loss = loss.cpu().numpy().reshape(2, n_p, lanes)
    eps = eps_rel * params.T  # [P, L]
    return ((loss[0] - loss[1]) / (2 * eps)).T


def rel_err(a, b, floor=1e-12) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


def phase_kernels_t() -> dict:
    """The transposed solve ``small_lu_solve_t`` (the backward of every LU
    solve) against its plain version on the card, bit for bit, at N = 3, 2
    and 6 on B = 65,536 lanes, with its time at N = 3 beside its bound and
    ``torch.linalg.lu_solve(..., adjoint=True)``'s."""
    err = 0.0
    for n in (3, 2, 6):
        rng = np.random.default_rng(40 + n)
        a = torch.from_numpy(rng.normal(size=(n, n, B)) + 3.0 * np.eye(n)[:, :, None]).to("cuda")
        g = torch.from_numpy(rng.normal(size=(n, B))).to("cuda")
        f = small_lu.lu_factor(a)
        lam, ref = small_lu.lu_solve_t(f, g), dense_lu.lu_solve_unrolled_t(f, g)
        torch.cuda.synchronize()
        e = float((lam - ref).abs().max())
        emit("kernel_t_vs_plain", n=n, batch=B, bitwise_equal=same(lam, ref), max_abs_err=e)
        check(same(lam, ref), f"small_lu_solve_t != its plain version at n={n}")
        err = max(err, e)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(3, 3, B)) + 3.0 * np.eye(3)[:, :, None]).to("cuda")
    g = torch.from_numpy(rng.normal(size=(3, B))).to("cuda")
    f = small_lu.lu_factor(a)
    runs = {}
    for key, fn, reps in [("plain_1", lambda: dense_lu.lu_solve_unrolled_t(f, g), 50),
                          ("kernel_1", lambda: small_lu.lu_solve_t(f, g), 500),
                          ("kernel_2", lambda: small_lu.lu_solve_t(f, g), 500),
                          ("plain_2", lambda: dense_lu.lu_solve_unrolled_t(f, g), 50)]:
        runs[key] = cuda_ms(fn, reps)
    # cold, as K1's rows: 16 input sets in turn move ~140 MB a pass
    sets = [(small_lu.lu_factor(a.clone()), g.clone()) for _ in range(16)]
    ms = kernel_device_ms([lambda h=h, y=y: small_lu.lu_solve_t(h, y) for h, y in sets], 4,
                          "solve_t_kernel")
    lead = [(h.lu.permute(2, 0, 1).contiguous(), h.piv.t().contiguous() + 1,
             y.t().contiguous().unsqueeze(-1)) for h, y in sets]
    lib_ms = call_device_ms([lambda x=x: torch.linalg.lu_solve(x[0], x[1], x[2], adjoint=True)
                             for x in lead], 4)
    # the library's answer is the same transposed solve
    lu_l, piv_l, _ = torch.linalg.lu_factor_ex(a.permute(2, 0, 1).contiguous())
    lib = torch.linalg.lu_solve(lu_l, piv_l, g.t().contiguous().unsqueeze(-1), adjoint=True)
    lib_err = float((lib.squeeze(-1).t() - small_lu.lu_solve_t(f, g)).abs().max())
    del sets, lead
    nbytes = a.numel() * 8 + 3 * B * 4 + g.numel() * 8 + g.numel() * 8  # lu, piv, g in; lam out
    row = {"max_abs_err": err, "ms": ms, "wrapper_ms": (runs["kernel_1"] + runs["kernel_2"]) / 2,
           "plain_ms": (runs["plain_1"] + runs["plain_2"]) / 2, "library_ms": lib_ms,
           "bound_ms": lu_bound_ms(nbytes), "bound_by": "bytes"}
    emit("kernel_t_times", n=3, batch=B, dtype="float64", runs_ms=runs, bytes=nbytes,
         bytes_per_lane=nbytes // B, library_max_abs_diff=lib_err, **row)
    check(lib_err < 1e-10, f"small_lu_solve_t disagrees with torch.linalg: {lib_err}")
    return row


def phase_adjoint_batched() -> dict:
    """bench.py's adjoint_batched: 4,096 Roberts lanes, per-lane losses and
    gradients through the eager solve, K1 forward and its transposed solve
    backward; against the CPU and central differences on spread lanes; the
    same with remat_attempts; the primal under safe_ad bit for bit."""
    params = adjoint_params(ADJ_B)
    run_adjoint_batched(params[:64], "cuda", IdaOptions(remat_attempts=False))  # warm-up
    torch.cuda.synchronize()
    out = {}
    for remat in (False, True):
        torch.cuda.reset_peak_memory_stats()
        small_lu.reset_launch_counts()
        t0 = time.perf_counter()
        vals, grads, ist = run_adjoint_batched(params, "cuda", IdaOptions(remat_attempts=remat))
        torch.cuda.synchronize()
        out[remat] = {"wall_s": time.perf_counter() - t0, "vals": vals, "grads": grads, "ist": ist,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "launches": {"factor": small_lu.FACTOR_LAUNCHES, "solve": small_lu.SOLVE_LAUNCHES,
                                   "solve_t": small_lu.SOLVE_T_LAUNCHES},
                      "group_launches": k1_launches(small_lu.GROUP_LAUNCHES)}
    plain, remat = out[False], out[True]
    vals, grads, ist = plain["vals"], plain["grads"], plain["ist"]
    n_ok = int((ist == C.SUCCESS).sum())
    finite = int(torch.isfinite(grads).all(dim=1).sum())
    remat_err = rel_err(remat["grads"].cpu().numpy(), grads.cpu().numpy(), floor=1e-300)

    # eight spread lanes: the port's CPU run and central differences on the card
    idx = np.linspace(0, ADJ_B - 1, ADJ_LANES).astype(int)
    t0 = time.perf_counter()
    vc, gc, ic = run_adjoint_batched(params[idx], "cpu")
    cpu_s = time.perf_counter() - t0
    st_g, _ = adjoint_forward(params[idx], "cuda")
    st_c, _ = adjoint_forward(params[idx], "cpu")
    nst_same = bool(torch.equal(st_g.nst.cpu(), st_c.nst) and torch.equal(st_g.nre.cpu(), st_c.nre))
    g8 = grads[idx].cpu().numpy()
    cpu_err = rel_err(g8, gc.numpy())
    val_err = rel_err(vals[idx].cpu().numpy(), vc.numpy())
    fd = central_differences(params[idx])
    fd_err = rel_err(g8, fd)

    # the primal under safe_ad is the eager solve without it, bit for bit
    fwd_s = wall_s(lambda: adjoint_forward(params, "cuda"))  # the primal alone, no graph
    st_plain, _ = adjoint_forward(params, "cuda")
    with safe_ad():
        st_safe, _ = adjoint_forward(params, "cuda")
    primal_same = first_difference(st_plain, st_safe, {}, {}) is None
    loss_primal = torch.func.vmap(adjoint_maps("cuda")[2])(st_plain.yy.t())

    emit("adjoint_batched", batch=ADJ_B, tout=ADJ_TOUT, max_attempts=ADJ_ATTEMPTS,
         wall_s=plain["wall_s"], grads_per_s=ADJ_B / plain["wall_s"], primal_wall_s=fwd_s,
         peak_mem_bytes=plain["peak_mem_bytes"], launches=plain["launches"],
         group_launches=plain["group_launches"], remat_wall_s=remat["wall_s"], remat_grads_per_s=ADJ_B / remat["wall_s"],
         remat_peak_mem_bytes=remat["peak_mem_bytes"], remat_launches=remat["launches"],
         remat_max_rel_err=remat_err, lanes_ok=n_ok, lanes_finite=finite,
         nst_max=int(st_plain.nst.max()), nst_total=int(st_plain.nst.sum()),
         spread_lanes=idx.tolist(), cpu_wall_s=cpu_s, cpu_counters_same=nst_same,
         cpu_max_rel_err_grad=cpu_err, cpu_max_rel_err_val=val_err, fd_max_rel_err=fd_err,
         primal_safe_ad_bitwise=primal_same,
         val_vs_primal_max_abs=float((vals - loss_primal).abs().max()),
         grad_lane0=grads[0].tolist())
    check(n_ok == ADJ_B, f"{ADJ_B - n_ok} adjoint lanes did not return SUCCESS")
    check(finite == ADJ_B, f"{ADJ_B - finite} lanes have non-finite gradients")
    check(bool((ic == C.SUCCESS).all()), "a CPU adjoint lane failed")
    check(val_err < 1e-10 and (cpu_err < 1e-6 or not nst_same),
          f"card vs CPU: values {val_err}, gradients {cpu_err} (counters same: {nst_same})")
    check(fd_err < 5e-4, f"gradients vs central differences: {fd_err}")
    check(remat_err < 1e-12, f"remat_attempts changed the gradients: {remat_err}")
    check(remat["peak_mem_bytes"] < plain["peak_mem_bytes"],
          f"remat_attempts did not lower peak memory: {remat['peak_mem_bytes']} vs {plain['peak_mem_bytes']}")
    check(primal_same, "the primal under safe_ad differs from the plain eager solve")
    check(bool(torch.equal(vals, loss_primal)), "the adjoint's losses are not the eager primal's")
    lau = plain["launches"]
    check(lau["factor"] > 0 and lau["solve"] > 0 and lau["solve_t"] > 0,
          f"K1 or small_lu_solve_t not launched: {lau}")
    # the rule keeps N = 3 on one thread a lane at 4,096 lanes
    check(not plain["group_launches"] and not remat["group_launches"],
          f"adjoint_batched: K1 launched on the group skeleton: {plain['group_launches']}")
    return {"launches": lau, "wall_s": plain["wall_s"], "params": params, "grads": grads}


def phase_adjoint_continuous(discrete: dict) -> dict:
    """bench.py's adjoint_continuous: 1,024 lanes, dense checkpoints on a
    64-point log grid, the adjoint DAE backward, KKT terminal conditions
    through K1 at N = 6 (the solve on the group skeleton); 64 lanes against
    the discrete adjoint, 16 bit for bit the parent dispatch's."""
    params = adjoint_params(ADJ_CONT_B)
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    _, _, loss_of = adjoint_maps("cuda")
    sizes = []
    factor = small_lu.lu_factor

    def noted(a):
        sizes.append(a.shape[0])
        return factor(a)

    def run(p, y0):
        return sensitivity.batched_continuous_adjoint(
            roberts_factory, p, ROBERTS_YY0, y0, tol_sv(1e-4, ATOL, device="cuda"), ADJ_TOUT,
            loss_of, grid=ADJ_GRID, opts=IdaOptions(mxstep=20000), device="cuda")

    # the warm-up's 16 lanes, with the parent's dispatch too: bit for bit
    # (the N = 6 solve on the groups against one thread a lane)
    warm_groups = []
    small_lu.reset_launch_counts()
    warm = run(params[:16], yp0[:16])
    warm_groups.append(k1_launches(small_lu.GROUP_LAUNCHES))
    small_lu.reset_launch_counts()
    with parent_lu():
        warm_parent = run(params[:16], yp0[:16])
    warm_groups.append(k1_launches(small_lu.GROUP_LAUNCHES))
    torch.cuda.synchronize()
    parent_same = all(torch.equal(u, v) for u, v in zip(warm, warm_parent))
    small_lu.reset_launch_counts()
    small_lu.lu_factor = noted
    try:
        t0 = time.perf_counter()
        loss, gp, gy0, istf, istb = run(params, yp0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        small_lu.lu_factor = factor
    launches = {"factor": small_lu.FACTOR_LAUNCHES, "solve": small_lu.SOLVE_LAUNCHES,
                "factor_n6": sizes.count(6), "solve_n6": small_lu.LAUNCHES["solve", "f64", 6],
                "factor_n6_groups": small_lu.GROUP_LAUNCHES["factor", "f64", 6],
                "solve_n6_groups": small_lu.GROUP_LAUNCHES["solve", "f64", 6]}
    groups = k1_launches(small_lu.GROUP_LAUNCHES)
    ok = int(((istf == 0) & (istb == 0)).sum())
    finite = int(torch.isfinite(gp).all(dim=1).sum())
    idx = np.linspace(0, ADJ_CONT_B - 1, 64).astype(int)
    _, g_disc, i_disc = run_adjoint_batched(params[idx], "cuda")
    err = rel_err(gp[idx].cpu().numpy(), g_disc.cpu().numpy())
    emit("adjoint_continuous", batch=ADJ_CONT_B, tout=ADJ_TOUT, grid=len(ADJ_GRID), wall_s=wall,
         grads_per_s=ADJ_CONT_B / wall, discrete_wall_s_4096=discrete["wall_s"],
         lanes_ok=ok, lanes_finite=finite, launches=launches, group_launches=groups,
         warm16_group_launches={"new": warm_groups[0], "parent": warm_groups[1]},
         vs_discrete_lanes=64, vs_discrete_max_rel_err=err, grad_lane0=gp[0].tolist(),
         lanes16_bitwise_parent=parent_same)
    check(ok == ADJ_CONT_B, f"{ADJ_CONT_B - ok} continuous-adjoint lanes failed")
    check(finite == ADJ_CONT_B, f"{ADJ_CONT_B - finite} lanes have non-finite gradients")
    check(bool((i_disc == 0).all()), "a discrete lane failed")
    check(err < 2e-2, f"continuous vs discrete gradients: {err}")
    check(launches["factor_n6"] > 0, f"K1 not launched at N = 6 (KKT): {launches}")
    check(launches["solve_n6_groups"] == launches["solve_n6"] > 0,
          f"the KKT solve at N = 6 not on the group skeleton: {launches}")
    # the N = 6 solve alone takes the groups: N = 3 keeps one thread a lane
    check(groups == {"solve_f64_n6": launches["solve_n6"]},
          f"adjoint_continuous: K1's group launches {groups}")
    check(warm_groups[0].get("solve_f64_n6", 0) > 0 and not warm_groups[1],
          f"adjoint_continuous: group launches of the 16 lanes, new and parent: {warm_groups}")
    check(parent_same, "adjoint_continuous: 16 lanes differ from the parent dispatch's")
    return {"launches": launches, "wall_s": wall}


def phase_sensitivity_lane() -> dict:
    """One lane on the card: forward_sensitivity, adjoint_hvp and
    adjoint_gradient(ic=...) against central differences, with K1's
    launches on these few lanes (the transposed solve's among them)."""
    small_lu.reset_launch_counts()
    p0 = np.asarray(ROBERTS_PARAMS)
    tol = tol_sv(1e-4, ATOL, device="cuda")
    yy0_of, yp0_of, loss_of = adjoint_maps("cuda")

    # forward sensitivity along k1 (tests/test_sensitivity.py:20-32)
    v = np.array([1.0, 0.0, 0.0])
    t0 = time.perf_counter()
    y, dy = sensitivity.forward_sensitivity(roberts_factory, p0, yy0_of, yp0_of, tol, ADJ_TOUT, v,
                                            device="cuda")
    fwd_s = time.perf_counter() - t0
    eps = 1e-7
    st, ist = adjoint_forward(np.stack([p0 + eps * v, p0 - eps * v]), "cuda", IdaOptions())
    yy = st.yy.cpu().numpy()
    fd = (yy[:, 0] - yy[:, 1]) / (2 * eps)
    fwd_err = rel_err(dy.cpu().numpy(), fd, floor=1e-30)

    # the Hessian-vector product along k1 (tests/test_second_order.py)
    t0 = time.perf_counter()
    g, hvp, ist_h = sensitivity.adjoint_hvp(roberts_factory, p0, yy0_of, yp0_of, tol, ADJ_TOUT,
                                            loss_of, v, max_attempts=ADJ_ATTEMPTS, device="cuda")
    hvp_s = time.perf_counter() - t0
    eps = 4e-7 * p0[0]
    _, gpm, _ = run_adjoint_batched(np.stack([p0 + eps * v, p0 - eps * v]), "cuda")
    gpm = gpm.cpu().numpy()
    fd_h = (gpm[0] - gpm[1]) / (2 * eps)
    hvp_err = abs(float(hvp[0]) - fd_h[0]) / max(abs(fd_h[0]), 1e-10)

    # through calc_ic (tests/test_ic_sensitivity.py:75-110)
    yy_bad = torch.tensor([1.0, 0.0, 0.3], dtype=torch.float64, device="cuda")
    yp_bad = torch.zeros(3, dtype=torch.float64, device="cuda")
    t0 = time.perf_counter()
    _, g_ic, ist_ic = sensitivity.adjoint_gradient(
        roberts_factory, p0, lambda p: yy_bad, lambda p: yp_bad, tol, ADJ_TOUT, loss_of,
        max_attempts=ADJ_ATTEMPTS, ic=("ya_ydp", 0.4), device="cuda")
    ic_s = time.perf_counter() - t0
    shifted = []
    for sign in (1.0, -1.0):
        for i in range(3):
            q = p0.copy()
            q[i] *= 1.0 + sign * 1e-6
            shifted.append(q)
    vals, _, ist_fd = sensitivity.batched_adjoint_gradient(
        roberts_factory, np.stack(shifted), lambda p: yy_bad, lambda p: yp_bad, tol, ADJ_TOUT,
        loss_of, max_attempts=ADJ_ATTEMPTS, ic=("ya_ydp", 0.4), device="cuda")
    vals = vals.cpu().numpy().reshape(2, 3)
    fd_ic = (vals[0] - vals[1]) / (2e-6 * p0)
    ic_err = rel_err(g_ic.cpu().numpy(), fd_ic)
    emit("sensitivity_lane", tout=ADJ_TOUT, forward_s=fwd_s, forward_max_rel_err=fwd_err,
         dy=dy.tolist(), hvp_s=hvp_s, hvp=hvp.tolist(), hvp_fd=fd_h.tolist(),
         hvp_rel_err=hvp_err, ic_s=ic_s, grad_ic=g_ic.tolist(), fd_ic=fd_ic.tolist(),
         ic_max_rel_err=ic_err, k1_launches=k1_launches())
    check(bool((ist == C.SUCCESS).all()), "a forward-difference lane failed")
    check(fwd_err < 1e-5, f"forward sensitivity vs differences: {fwd_err}")
    check(int(ist_h) == 0 and bool(torch.isfinite(hvp).all()), "adjoint_hvp failed")
    check(hvp_err < 5e-3, f"hvp vs differences of the gradient: {hvp_err}")
    check(int(ist_ic) == 0 and bool((ist_fd == 0).all()), "the IC adjoint failed")
    check(ic_err < 5e-4, f"adjoint through calc_ic vs differences: {ic_err}")
    check(small_lu.LAUNCHES["solve_t", "f64", 3] > 0, "no transposed solve on the few lanes")
    return {"launches": k1_launches()}


# ---------- mixed precision, fast_math, slider-crank, stratified, scopes

MIXED_MODES = ("single", "refined")
HEAT_B_MIXED = 128  # bench.py heat2d_100x100_batched_mixed
HEAT_MIXED_TOUT = 0.04  # heat2d_mixed's horizon: the second of the heat outputs
SLIDER_TEND, SLIDER_NOUT = 10.0, 20  # examples/slider_crank_torch.py
# the example's CPU run (ida_tpu's examples/slider_crank.py prints the same)
SLIDER_CPU = {"nst": 222, "ke_avg": 0.33366266}
STRAT_CHUNKS = 4
STRAT_TOUT = 4.0  # the stratified and plain solves: the first two decades
PROFILE_DIR = CHECKPOINT_DIR / "trace"
# profile_scopes' solves: the headline's first decades (43 of the canonical
# lane's 95 steps to TOUT); its window to TOUT took most of a minute to digest
PROFILE_SCOPES_TOUT = 0.4  # the first decade


def mixed_inputs(b: int):
    """The headline's lanes, the last at the nominal parameters."""
    params, yy0, yp0 = ensemble_inputs(b)
    params[-1] = ROBERTS_PARAMS
    yp0[-1] = ROBERTS_YP0
    return params, yy0, yp0


def run_mode(params, yy0, yp0, device, tout, opts: IdaOptions):
    st = ensemble_init(roberts_factory, params, yy0, yp0, device=device, opts=opts)
    tol = tol_sv(1e-4, ATOL, device=device)
    return make_ensemble_solve(roberts_factory, opts)(st, params, tol, tout)


def k1_launches(counts=None) -> dict:
    """``small_lu.LAUNCHES`` (or ``counts``, e.g. ``GROUP_LAUNCHES``) as
    "kernel_tag_nN" -> launches."""
    counts = small_lu.LAUNCHES if counts is None else counts
    return {f"{k}_{tag}_n{n}": c for (k, tag, n), c in sorted(counts.items())}


def k1_times(a: torch.Tensor, b: torch.Tensor, sets: int, rounds: int) -> dict:
    """K1's factor and solve on ``a`` [N, N, *lanes], ``b`` [N, *lanes]
    (contiguous, one dtype): each bit for bit its plain version, its cold
    device time (``sets`` input sets in turn, more bytes than the L2), the
    plain version's back-to-back time, torch.linalg's cold device time on the
    same systems batch-leading, and the bytes bound (each input read once,
    each output written once)."""
    n, es = a.shape[0], a.element_size()
    m = b[0].numel()
    f, g = small_lu.lu_factor(a), dense_lu.lu_factor_unrolled(a)
    x, y = small_lu.lu_solve(f, b), dense_lu.lu_solve_unrolled(g, b)
    torch.cuda.synchronize()
    ok = {"factor": same(f.lu, g.lu) and same(f.piv, g.piv) and same(f.fail_col, g.fail_col),
          "solve": same(x, y)}
    errs = {"factor": float((f.lu - g.lu).abs().max()), "solve": float((x - y).abs().max())}
    a_sets = [a.clone() for _ in range(sets)]
    b_sets = [b.clone() for _ in range(sets)]
    f_sets = [small_lu.lu_factor(v) for v in a_sets]
    dev = {"factor": kernel_device_ms([lambda v=v: small_lu.lu_factor(v) for v in a_sets], rounds,
                                      "factor_kernel"),
           "solve": kernel_device_ms([lambda h=h, v=v: small_lu.lu_solve(h, v)
                                      for h, v in zip(f_sets, b_sets)], rounds, "solve_kernel")}
    plain = {"factor": cuda_ms(lambda: dense_lu.lu_factor_unrolled(a), 20),
             "solve": cuda_ms(lambda: dense_lu.lu_solve_unrolled(g, b), 20)}
    lead = [(v.reshape(n, n, m).permute(2, 0, 1).contiguous(),
             w.reshape(n, m).t().contiguous().unsqueeze(-1)) for v, w in zip(a_sets, b_sets)]
    f_lead = [torch.linalg.lu_factor_ex(v)[:2] for v, _ in lead]
    lib = {"factor": call_device_ms([lambda v=v: torch.linalg.lu_factor_ex(v) for v, _ in lead],
                                    rounds),
           "solve": call_device_ms([lambda h=h, w=w: torch.linalg.lu_solve(h[0], h[1], w)
                                    for h, (_, w) in zip(f_lead, lead)], rounds)}
    nbytes = {"factor": 2 * n * n * m * es + n * m * 4 + m * 4,
              "solve": n * n * m * es + n * m * 4 + 2 * n * m * es}
    return {k: {"bitwise_equal": ok[k], "max_abs_err": errs[k], "ms": dev[k],
                "plain_ms": plain[k], "bound_ms": lu_bound_ms(nbytes[k]), "bound_by": "bytes",
                "library_ms": lib[k], "bytes": nbytes[k]} for k in ("factor", "solve")}


def phase_kernels_modes() -> dict:
    """K1 at the shapes of the later paths, each against its plain version:
    float32 N = 3 at B = 65,536 ("single" and "refined"), the float32 N = 2
    solve on the foodweb blocks in the layout the Krylov "single" path hands
    it (the float64 factors cast to float32), and the few-lane rows
    (``kernel_variants.k1_few_lanes``): float64 N = 10 on one lane
    (slider-crank) and N = 6 on 1,024 lanes (the continuous adjoint), each
    on the skeleton the rule names, timed in turns with the parent's
    dispatch, beside its floor and torch.linalg."""
    rng = np.random.default_rng(31)
    a3 = torch.from_numpy(rng.normal(size=(3, 3, B)) + 3.0 * np.eye(3)[:, :, None])
    b3 = torch.from_numpy(rng.normal(size=(3, B)))
    # float32 N = 3: 32 sets (75 MB a factor pass) keep every launch cold
    f32_n3 = k1_times(a3.to("cuda", torch.float32), b3.to("cuda", torch.float32), 32, 4)
    # the few-lane rows: f64 N = 10 on one lane (slider-crank) and N = 6 on
    # 1,024 lanes (the continuous adjoint's KKT systems), the shipped build
    # and the parent's dispatch in turns, each with its floor
    few = kernel_variants.k1_few_lanes({"new": small_lu.build(), **LU_LIBS})

    # float32 N = 2 on foodweb's blocks as prec_solve reads them under
    # "single": factored in float64, cast with their strides kept
    c0, _ = foodweb_ic(FOOD_M, FOOD_M)
    yy = torch.from_numpy(np.outer(c0, np.linspace(0.95, 1.05, FOOD_B))).cuda()
    cj = torch.from_numpy(1e3 * (1.0 + rng.random(FOOD_B))).cuda()
    prob = foodweb_problem(FOOD_M, FOOD_M)
    lu_view, piv_view = prob.prec_setup(0.0, cj, yy, torch.zeros_like(yy), torch.zeros_like(yy))
    lu32 = lu_view.to(torch.float32)  # core/nls.py's cast: the strides kept
    r = torch.from_numpy(rng.normal(size=(2 * FOOD_M * FOOD_M, FOOD_B))).cuda().float()
    rb = r.reshape(FOOD_M * FOOD_M, 2, FOOD_B).movedim(1, 0)
    # the views foodweb.prec_solve hands the solve
    h = dense_lu.DenseLU(lu32.movedim((1, 2), (0, 1)), piv_view.movedim(1, 0), None)
    x, y = small_lu.lu_solve(h, rb), dense_lu.lu_solve_unrolled(h, rb)
    torch.cuda.synchronize()
    n2_ok = same(x.contiguous(), y.contiguous())
    layout = small_lu.solve_layout(h.lu, h.piv, rb, x).as_dict()
    sets = [(dense_lu.DenseLU(h.lu.clone(memory_format=torch.preserve_format), h.piv, None),
             rb.clone(memory_format=torch.preserve_format)) for _ in range(128)]
    m = FOOD_M * FOOD_M * FOOD_B
    n2 = {"bitwise_equal": n2_ok, "max_abs_err": float((x - y).abs().max()),
          "ms": kernel_device_ms([lambda h=h, v=v: small_lu.lu_solve(h, v) for h, v in sets], 2,
                                 "solve_kernel"),
          "plain_ms": cuda_ms(lambda: dense_lu.lu_solve_unrolled(h, rb), 20),
          "bound_ms": lu_bound_ms(4 * m * 4 + 2 * m * 4 + 4 * m * 4), "bound_by": "bytes",
          "bytes": 4 * m * 4 + 2 * m * 4 + 4 * m * 4}
    lead = [(v.lu.movedim((0, 1), (-2, -1)).reshape(m, 2, 2).contiguous(),
             v.piv.movedim(0, -1).reshape(m, 2).contiguous() + 1,
             w.movedim(0, -1).reshape(m, 2, 1).contiguous()) for v, w in sets[:64]]
    n2["library_ms"] = call_device_ms([lambda t=t: torch.linalg.lu_solve(t[0], t[1], t[2])
                                       for t in lead], 2)
    del sets, lead
    emit("kernels_modes", f32_n3=f32_n3, f32_n2_prec_solve=n2, n2_layout=layout, few_lanes=few)
    check(all(v["bitwise_equal"] for v in f32_n3.values()), "K1 f32 N=3 != its plain version")
    check(n2_ok, "K1 float32 N=2 solve != its plain version")
    for row, out in few.items():
        check(out["bitwise_equal"], f"K1 {row}: a skeleton differs from its plain version")
        for k in ("factor", "solve"):
            group = small_lu.uses_groups(k, "f64", out["n"], out["lanes"])
            check(out[k]["skeleton_new"] == (f"{k}_group_kernel" if group else f"{k}_kernel"),
                  f"K1 {row} {k}: the shipped build ran {out[k]['skeleton_new']}")
    # the rows of the kernels line: the shipped build's time (the mean of
    # its two turns), its plain version and the library call
    rows = {row: {k: {"max_abs_err": out[k]["max_abs_err"], "ms": statistics.mean(out[k]["ms"]["new"]),
                      "plain_ms": out[k]["plain_ms"], "bound_ms": out[k]["bound_ms"],
                      "bound_by": "bytes", "library_ms": out[k]["library_ms"],
                      "skeleton": out[k]["skeleton_new"],
                      "parent_ms": statistics.mean(out[k]["ms"]["parent"]),
                      "floor_copy_ms": out[k]["floor_copy_ms"],
                      "floor_empty_ms": out[k]["floor_empty_ms"]} for k in ("factor", "solve")}
            for row, out in few.items()}
    return {"f32_n3": f32_n3, "f64_n10": rows["n10_b1"], "f64_n6": rows["n6_b1024"], "f32_n2": n2}


def phase_mixed_headline(eager: dict, k1: dict) -> dict:
    """The headline (B = 65,536, tout 400, f64 state) under ls_precision
    "single" and "refined": K1's float32 factor and solve at N = 3, the
    lu carry in float32; the first and the nominal lane against the port's
    CPU run of those lanes, counter for counter."""
    params, yy0, yp0 = mixed_inputs(B)
    lanes = [0, B - 1]
    # walls in turns with the full mode in this phase: full, single,
    # refined, refined, single, full; counts and results from the first of
    # each
    walls, res, counts = {m: [] for m in ("full",) + MIXED_MODES}, {}, {}
    for mode in ("full",) + MIXED_MODES + MIXED_MODES[::-1] + ("full",):
        opts = IdaOptions(ls_precision=mode)
        small_lu.reset_launch_counts()
        walls[mode].append(wall_s(lambda: res.setdefault(mode, []).append(
            run_mode(params, yy0, yp0, "cuda", TOUT, opts))))
        counts.setdefault(mode, k1_launches())
    full_nst = int(res["full"][0][0].nst.sum())
    out = {}
    for mode in MIXED_MODES:
        opts = IdaOptions(ls_precision=mode)
        wall = min(walls[mode])
        launches = counts[mode]
        st, tret, ist = res[mode][0]
        totals = {f: int(getattr(st, f).sum()) for f in COUNTERS}
        n_ok = int((ist == C.SUCCESS).sum())
        sc, _, ic = run_mode(params[lanes], yy0[lanes], yp0[lanes], "cpu", TOUT, opts)
        card = {f: getattr(st, f)[lanes].cpu().tolist() for f in COUNTERS}
        cpu = {f: getattr(sc, f).tolist() for f in COUNTERS}
        lu_bytes = st.lu.numel() * st.lu.element_size()
        # the device's busy share over one more internal step of every lane
        native = to_native(st)
        prob = roberts_factory(torch.as_tensor(params, device="cuda").t().contiguous())
        tol = _native_shared_tol(tol_sv(1e-4, ATOL, device="cuda"), native)
        busy = device_busy(lambda: core_solve(native, prob, opts, tol, 4.0e3, TASK_ONE_STEP),
                           calls=3)
        out[mode] = {"wall_s": wall, "launches": launches, "result": res[mode][0]}
        emit("mixed_headline", mode=mode, batch=B, tout=TOUT, wall_s=wall, walls_s=walls[mode],
             walls_full_s=walls["full"], wall_vs_full=wall / min(walls["full"]),
             nst_full=full_nst, eager_headline_wall_s=eager["wall_s"],
             steps_per_s=totals["nst"] / wall,
             lanes_success=n_ok, **totals, k1_launches=launches, lu_dtype=str(st.lu.dtype),
             lu_carry_bytes=lu_bytes, lu_carry_bytes_f64=2 * lu_bytes, lanes_checked=lanes,
             card_counters=card, cpu_counters=cpu, k1_f32_n3=k1["f32_n3"],
             busy_window="one step from the end state", **busy)
        check(n_ok == B, f"mixed_headline {mode}: {B - n_ok} lanes not SUCCESS")
        check(bool(torch.isfinite(st.yy).all()), f"mixed_headline {mode}: yy not finite")
        check(st.lu.dtype == torch.float32, f"mixed_headline {mode}: lu is {st.lu.dtype}")
        check(launches.get("factor_f32_n3", 0) > 0 and launches.get("solve_f32_n3", 0) > 0,
              f"mixed_headline {mode}: K1 float32 not launched: {launches}")
        check(not any("f64" in k for k in launches),
              f"mixed_headline {mode}: a float64 LU launched: {launches}")
        check(card == cpu, f"mixed_headline {mode}: lanes {lanes} {card} != CPU {cpu}")
    return out


def phase_fast_f64(eager: dict) -> dict:
    """The headline with fast_math (bench.py's fast_f64 leg), timed in turns
    with the parity headline in this process (parity, fast, fast, parity):
    every lane within rtol 1e-3 / atol 1e-10 of parity; the canonical lane
    over 12 decades within check_ans."""
    params, yy0, yp0 = ensemble_inputs(B)
    walls, res = {"parity": [], "fast": []}, {}
    for mode in ("parity", "fast", "fast", "parity"):
        opts = IdaOptions(fast_math=mode == "fast")
        small_lu.reset_launch_counts()
        walls[mode].append(wall_s(lambda: res.update({mode: run_mode(params, yy0, yp0, "cuda",
                                                                      TOUT, opts)})))
        if mode == "fast":
            launches = lu_launches()
    (sf, _, i_f), (sp, _, i_p) = res["fast"], res["parity"]
    n_ok = int(((i_f == C.SUCCESS) & (i_p == C.SUCCESS)).sum())
    excess = ((sf.yy - sp.yy).abs() - (1e-3 * sp.yy.abs() + 1e-10)).max()
    rel = ((sf.yy - sp.yy).abs() / sp.yy.abs().clamp(min=1e-300)).amax(dim=0).tolist()
    nst_f, nst_p = int(sf.nst.sum()), int(sp.nst.sum())
    # the canonical lane over 12 decades
    opts = IdaOptions(fast_math=True)
    tol = tol_sv(1e-4, ATOL, device="cuda")
    solve = make_ensemble_solve(roberts_factory, opts)
    st = ensemble_init(roberts_factory, ROBERTS_PARAMS[None], ROBERTS_YY0[None], ROBERTS_YP0[None],
                       device="cuda", opts=opts)
    nst_dec = []
    for k in range(12):
        st, tret, istate = solve(st, ROBERTS_PARAMS[None], tol, 0.4 * 10**k)
        check(int(istate[0]) == C.SUCCESS, f"fast_f64 canonical decade {k}: {int(istate[0])}")
        nst_dec.append(int(st.nst[0]))
    err = check_ans_wrms(st.yy[0].cpu().numpy())
    emit("fast_f64", batch=B, tout=TOUT, walls_fast_s=walls["fast"], walls_parity_s=walls["parity"],
         steps_per_s_fast=nst_f / min(walls["fast"]), steps_per_s_parity=nst_p / min(walls["parity"]),
         nst_fast=nst_f, nst_parity=nst_p, lanes_success=n_ok,
         lanes_nst_differ=int((sf.nst != sp.nst).sum()), max_excess_over_tol=float(excess),
         max_rel_diff_per_component=rel, lu_launches=launches, canonical_nst_per_decade=nst_dec,
         canonical_check_ans_wrms=err, eager_parity_wall_s=eager["wall_s"])
    check(n_ok == B, f"fast_f64: {B - n_ok} lanes not SUCCESS")
    check(float(excess) <= 0.0, f"fast_f64: a lane beyond rtol 1e-3 / atol 1e-10 of parity: {excess}")
    check(err < 1.0, f"fast_f64: canonical lane check_ans WRMS {err}")
    check(launches["factor"] > 0 and launches["solve"] > 0, f"fast_f64: LU kernels {launches}")
    return {"launches": launches, "result": res["fast"], "wall_s": min(walls["fast"])}


def phase_heat2d_mixed() -> None:
    """heat2d 100 x 100 under ls_precision "single": one lane through IDA with
    CGS2 (bench.py's heat2d_100x100_spgmr_mixed) and with a bfloat16 basis,
    each against the port's CPU run of the same solve; then B = 128
    batch-native (heat2d_100x100_batched_mixed), lane 0 against its CPU run.
    The counters are printed beside the CPU's, and the gate is the WRMS of
    the difference under the CPU state's weights below 10, the bound
    ``ida_tpu``'s tests/test_mixed_precision.py sets between two runs of
    one problem on different step sequences (a broken float32 solve gives
    100+): the eager path's ``pow`` is CUDA's on the card and the C
    library's on the CPU (``utils/numerics``), and one ulp of the step
    ratio after an error-test failure (hh at step 99 of the "single" MGS
    run, found by replaying that step on both) parts the step sequences."""
    u0, up0 = heat2d_ic(HEAT_M)
    tol, tout = (1e-5, 1e-8), HEAT_MIXED_TOUT
    legs = {"single_cgs2": dict(ls_precision="single", krylov_gs="classical"),
            "single_bf16": dict(ls_precision="single", krylov_storage="bfloat16")}
    for name, kw in legs.items():
        opts = IdaOptions(linear_solver="spgmr", mxstep=20000, **kw)
        runs = {}
        for dev in ("cuda", "cpu"):
            ida = IDA(heat2d_problem(HEAT_M, device=dev), u0, up0, tol_ss(*tol, device=dev), opts,
                      device=dev)
            runs[dev] = (wall_s(lambda: ida.solve(tout)) if dev == "cuda"
                         else _host_wall(lambda: ida.solve(tout)), krylov_counts(ida.state),
                         ida.state.yy.cpu())
        (wall, got, yy), (cpu_wall, cpu, yc) = runs["cuda"], runs["cpu"]
        wrms = wrms_card_vs_cpu(yy, yc, *tol)
        emit("heat2d_mixed", leg=name, grid=f"{HEAT_M}x{HEAT_M}", tout=tout, wall_s=wall,
             steps_per_s=got["nst"] / wall, **got, cpu=cpu, cpu_wall_s=cpu_wall,
             counters_equal_cpu=got == cpu, wrms_card_vs_cpu=wrms)
        check(bool(torch.isfinite(yy).all()), f"heat2d_mixed {name}: yy not finite")
        check(wrms < 10.0, f"heat2d_mixed {name}: card vs CPU WRMS {wrms}")

    prob = heat2d_problem(HEAT_M)
    opts = IdaOptions(linear_solver="spgmr", mxstep=20000, ls_precision="single")
    scales = np.linspace(0.9, 1.1, HEAT_B_MIXED)
    st0 = to_native(ensemble_init(lambda p: prob, scales[:, None], u0[None] * scales[:, None],
                                  up0[None] * scales[:, None], opts=opts))
    res = {}
    wall = wall_s(lambda: res.update(r=core_solve(st0, prob, opts, tol_ss(*tol), tout)))
    st, tret, istate = res["r"]
    prob_c = heat2d_problem(HEAT_M, device="cpu")
    s1 = to_native(ensemble_init(lambda p: prob_c, scales[:1, None], u0[None] * scales[0],
                                 up0[None] * scales[0], opts=opts, device="cpu"))
    sc, _, _ = core_solve(s1, prob_c, opts, tol_ss(*tol, device="cpu"), tout)
    lane0 = {f: int(getattr(st, f)[0]) for f in KRYLOV}
    cpu0 = {f: int(getattr(sc, f)[0]) for f in KRYLOV}
    wrms = wrms_card_vs_cpu(st.yy[:, 0].cpu(), sc.yy[:, 0], *tol)
    nst = int(st.nst.sum())
    emit("heat2d_mixed", leg="batched_single", grid=f"{HEAT_M}x{HEAT_M}", batch=HEAT_B_MIXED,
         tout=tout, wall_s=wall, total_steps=nst, agg_steps_per_s=nst / wall,
         **krylov_counts(st), lanes_success=int((istate == C.SUCCESS).sum()), lane0=lane0,
         lane0_cpu=cpu0, lane0_counters_equal_cpu=lane0 == cpu0, lane0_wrms_card_vs_cpu=wrms)
    check(bool((istate == C.SUCCESS).all()), "heat2d_mixed batched: a lane is not SUCCESS")
    check(wrms < 10.0, f"heat2d_mixed batched: lane 0 card vs CPU WRMS {wrms}")


def wrms_card_vs_cpu(yy: torch.Tensor, yc: torch.Tensor, rtol: float, atol: float) -> float:
    """WRMS of the card's state against the CPU's under the CPU state's
    error weights."""
    w = 1.0 / (rtol * yc.abs() + atol)
    return float(torch.sqrt(torch.mean(((yy.to(yc.dtype) - yc) * w) ** 2)))


def _host_wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def phase_foodweb_mixed() -> dict:
    """foodweb 20 x 20, B = 128, Krylov "single" (bench.py's
    foodweb_20x20_batched_mixed): batch-native calc_ic and four legs; the
    preconditioner's solve is K1's float32 solve at N = 2 (its factor stays
    float64: prec_setup runs in the state's dtype), one launch and no copy
    a prec_solve (profiled in a fresh process)."""
    c0, cp0 = foodweb_ic(FOOD_M, FOOD_M)
    prob = foodweb_problem(FOOD_M, FOOD_M)
    opts = dataclasses.replace(foodweb_opts(), ls_precision="single")
    tol = tol_ss(1e-5, 1e-5)
    ids = prob.id.cpu().numpy()
    scales = np.linspace(0.95, 1.05, FOOD_B)
    c0b = np.stack([c0 * np.where(ids, s, 1.0) for s in scales])
    st = to_native(ensemble_init(lambda p: prob, scales[:, None], c0b, np.tile(cp0, (FOOD_B, 1)),
                                 opts=opts))
    small_lu.reset_launch_counts()
    out = {}
    ic_wall = wall_s(lambda: out.update(ic=core_calc_ic(st, prob, opts, tol, IC_YA_YDP_INIT,
                                                        FOOD_TOUTS[0])))
    st, ok = out["ic"]
    ists = []

    def legs():
        nonlocal st
        for t in FOOD_TOUTS:
            st, _, ist = core_solve(st, prob, opts, tol, t)
            ists.append(ist)

    wall = wall_s(legs)
    launches = k1_launches()
    nst = int(st.nst.sum())
    lanes_ok = int((ok & torch.stack(ists).eq(C.SUCCESS).all(dim=0)).sum())
    prec = prec_events("float32")
    emit("foodweb_mixed", grid=f"{FOOD_M}x{FOOD_M}", batch=FOOD_B, calc_ic_wall_s=ic_wall,
         legs_wall_s=wall, total_steps=nst, agg_steps_per_s=nst / wall, **krylov_counts(st),
         lanes_ok=lanes_ok, k1_launches=launches, prec_solve_f32=prec,
         predator_ratio_err_end=predator_ratio_err(st.yy.t().cpu().numpy()))
    check(lanes_ok == FOOD_B, f"foodweb_mixed: {FOOD_B - lanes_ok} lanes not ok and SUCCESS")
    check(launches.get("solve_f32_n2", 0) > 0, f"foodweb_mixed: no float32 N=2 solve: {launches}")
    names = list(prec["kernels"])
    check(prec["calls_recorded"] > 0 and len(names) == 1 and "solve_kernel" in names[0]
          and "float" in names[0],
          f"foodweb_mixed: a float32 prec_solve is not one K1 solve and nothing else: {prec}")
    return {"launches": launches}


@contextlib.contextmanager
def parent_lu():
    """Route K1's wrappers to the parent's dispatch (one thread a lane) for
    the length of a ``with``: the build the few-lane skeleton is held to."""
    default = small_lu.build
    small_lu.build = lambda: LU_LIBS["parent"]
    try:
        yield
    finally:
        small_lu.build = default


def phase_slider_crank() -> dict:
    """examples/slider_crank_torch.py on the card: 20 outputs to t = 10, the
    kinetic energy as a quadrature; the AD Jacobian factored by K1 at N = 10
    every lsetup, on the group skeleton; the first output's state bit for
    bit the parent dispatch's."""
    base = slider_crank_problem()
    prob = dataclasses.replace(
        base, quad=lambda t, yy, yp: torch.stack([0.5 * (yy[3] * yy[3] + yy[4] * yy[4]
                                                         + 2.0 * yy[5] * yy[5])]), nquad=1)
    yy0, yp0 = slider_crank_ic()

    def new_ida():
        return IDA(prob, yy0, yp0, tol_ss(1e-6, 1e-6), IdaOptions(mxstep=100000, suppressalg=True))

    first = SLIDER_TEND / SLIDER_NOUT
    legs, leg_groups = [], []
    for routing in (contextlib.nullcontext, parent_lu):
        leg = new_ida()
        small_lu.reset_launch_counts()
        with routing():
            leg.solve(first)
        legs.append((leg.get_num_steps(), leg.get_yy(), leg.get_yp()))
        leg_groups.append(k1_launches(small_lu.GROUP_LAUNCHES))
    parent_same = legs[0][0] == legs[1][0] and all(
        np.array_equal(u, v) for u, v in zip(legs[0][1:], legs[1][1:]))
    ida = new_ida()
    small_lu.reset_launch_counts()
    statuses = []
    wall = wall_s(lambda: statuses.extend(
        ida.solve(float(t))[1].name for t in np.linspace(SLIDER_TEND / SLIDER_NOUT, SLIDER_TEND,
                                                         SLIDER_NOUT)))
    launches, group = k1_launches(), k1_launches(small_lu.GROUP_LAUNCHES)
    y = ida.get_yy()
    gnorm = float(np.hypot(y[1] - np.cos(y[2]) - 0.5 * np.cos(y[0]), -np.sin(y[2]) - 0.5 * np.sin(y[0])))
    ke = float(ida.get_quad()[0]) / SLIDER_TEND
    nst = ida.get_num_steps()
    emit("slider_crank", tend=SLIDER_TEND, outputs=SLIDER_NOUT, wall_s=wall, steps_per_s=nst / wall,
         nst=nst, nre=ida.get_num_res_evals(), nje=ida.get_num_jac_evals(),
         netf=ida.get_num_err_test_fails(), ke_avg=ke, position_constraint=gnorm,
         k1_launches=launches, k1_group_launches=group, cpu_example=SLIDER_CPU,
         first_output_bitwise_parent=parent_same, first_output_nst=legs[0][0],
         first_output_group_launches={"new": leg_groups[0], "parent": leg_groups[1]})
    check(statuses == ["Success"] * SLIDER_NOUT, f"slider_crank: {statuses}")
    check(gnorm < 1e-7, f"slider_crank: the position constraint drifted: {gnorm}")
    check(nst == SLIDER_CPU["nst"] and abs(ke - SLIDER_CPU["ke_avg"]) < 1e-5,
          f"slider_crank: {nst} steps, mean KE {ke}")
    check(launches.get("factor_f64_n10", 0) >= ida.get_num_jac_evals() > 0
          and launches.get("solve_f64_n10", 0) > 0, f"slider_crank: K1 N=10 {launches}")
    check(all(group.get(k, 0) == launches[k] for k in ("factor_f64_n10", "solve_f64_n10")),
          f"slider_crank: K1 N=10 not on the group skeleton: {group} of {launches}")
    check(parent_same, "slider_crank: the first output differs from the parent dispatch's")
    check(leg_groups[0].get("factor_f64_n10", 0) > 0 and not leg_groups[1],
          f"slider_crank: group launches of the first output, new and parent: {leg_groups}")
    return {"launches": launches, "group_launches": group}


def phase_stratified() -> None:
    """The headline's lanes spread over two decades of rates and shuffled:
    pilot_cost at 0.4, make_stratified_solve in 4 chunks to STRAT_TOUT
    against the plain solve, bit for bit in every lane and field, walls side by side."""
    scale = np.logspace(-1.0, 1.0, B)[np.random.default_rng(11).permutation(B)]
    params = np.outer(scale, ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (B, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    tol, tout = tol_sv(1e-4, ATOL, device="cuda"), STRAT_TOUT
    st0 = ensemble_init(roberts_factory, params, yy0, yp0)
    out = {}
    pilot = wall_s(lambda: out.update(key=pilot_cost(roberts_factory, st0, params, tol, 0.4)))
    strat = make_stratified_solve(roberts_factory, n_chunks=STRAT_CHUNKS)
    plain = make_ensemble_solve(roberts_factory)
    walls = {"plain": [], "stratified": []}
    for name in ("plain", "stratified", "stratified", "plain"):
        fn = (lambda: out.update(s=strat(st0, params, tol, tout, out["key"]))) if name == "stratified" \
            else (lambda: out.update(p=plain(st0, params, tol, tout)))
        walls[name].append(wall_s(fn))
    (ss, ts, is_), (sp, tp, ip) = out["s"], out["p"]
    differ = [f for f in sp._fields if isinstance(getattr(sp, f), torch.Tensor)
              and not same(getattr(ss, f), getattr(sp, f))]
    nst = sp.nst.cpu().numpy()
    order = np.argsort(out["key"].cpu().numpy(), kind="stable")
    chunk_max = [int(x.max()) for x in np.array_split(nst[order], STRAT_CHUNKS)]
    emit("stratified", batch=B, tout=tout, chunks=STRAT_CHUNKS, rate_spread="logspace(-1, 1)",
         pilot_wall_s=pilot, walls_plain_s=walls["plain"], walls_stratified_s=walls["stratified"],
         total_steps=int(nst.sum()), max_lane_steps=int(nst.max()), chunk_max_steps=chunk_max,
         lanes_success=int((ip == C.SUCCESS).sum()), fields_differ=differ)
    check(not differ and same(ts, tp) and same(is_, ip),
          f"stratified: not bit for bit the plain solve: {differ}")
    check(bool((ip == C.SUCCESS).all()), "stratified: a lane is not SUCCESS")


def phase_profile_scopes(eager: dict) -> None:
    """The headline's lanes to PROFILE_SCOPES_TOUT under
    utils.profiling.profile: per ida.<name> scope its calls, host ms, the
    device ms of the kernels launched inside it and the span it covers on
    the device's timeline; and what the scopes cost on the same solve's wall
    without a profiler (ENABLED on and off in turns, two rounds)."""
    params, yy0, yp0 = ensemble_inputs(B)
    walls = {True: [], False: []}
    try:
        for on in (True, False, False, True):
            profiling.ENABLED = on
            walls[on].append(wall_s(lambda: run_ensemble(params, yy0, yp0, "cuda",
                                                         PROFILE_SCOPES_TOUT)))
    finally:
        profiling.ENABLED = True
    with profiling.profile(str(PROFILE_DIR)) as prof:
        wall = wall_s(lambda: run_ensemble(params, yy0, yp0, "cuda", PROFILE_SCOPES_TOUT))
    check(prof is not None, "profile_scopes: the profiler did not start")
    scopes = {}
    averages = prof.key_averages()
    for e in averages:
        if not e.key.startswith("ida."):
            continue
        row = scopes.setdefault(e.key, {})
        dev = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            row["device_span_ms"] = dev  # the range the profiler lays on the device
        else:
            row.update(calls=e.count, host_ms=e.cpu_time_total / 1e3, device_ms=dev)
    dev_total = sum(e.self_device_time_total for e in device_activities(averages)) / 1e3
    emit("profile_scopes", batch=B, tout=PROFILE_SCOPES_TOUT, profiled_wall_s=wall,
         device_ms=dev_total,
         scopes=scopes, walls_scopes_on_s=walls[True], walls_scopes_off_s=walls[False],
         scope_cost_share_of_min=(min(walls[True]) - min(walls[False])) / min(walls[False]),
         scope_cost_share_of_median=(statistics.median(walls[True])
                                     - statistics.median(walls[False]))
         / statistics.median(walls[False]),
         trace=str(PROFILE_DIR / "trace.json"))
    check(len(scopes) > 0, "profile_scopes: the trace holds no ida.<name> scope")
    check({"ida.step.attempt", "ida.nonlinear_solve", "ida.lsetup"} <= set(scopes),
          f"profile_scopes: scopes missing: {sorted(scopes)}")
    check(all("host_ms" in v for v in scopes.values()),
          f"profile_scopes: a scope without its host event: {scopes}")
    check(scopes["ida.step.attempt"].get("device_ms", 0.0) > 0.0,
          "profile_scopes: no device time inside ida.step.attempt")


def mode_launch_times(opts: IdaOptions, st0, p_b, budget: int, tol_in=None,
                      model: fused_model.FusedModel = fused_solve.ROBERTS,
                      tout: float = TOUT) -> list:
    """CUDA-event ms of each launch of a budgeted solve of ``model``'s
    library in ``opts``' mode (K3, then K4 in place on its result until no
    lane is CONTINUE)."""
    dst = fused_solve.empty_result(st0, opts, model)
    carry = fused_solve.new_carry(st0.tn.shape[0], st0.dtype, st0.phi.device, True)
    tol_in = tol_in or shared_tol(dtype=st0.dtype)
    runs = []

    def step(resume: bool) -> torch.Tensor:
        go = fused_solve.prepare_launch("cont" if resume else "init", dst if resume else st0, dst,
                                        p_b, tol_in, tout, carry, opts, model, budget)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        istate = go()
        ev[1].record()
        torch.cuda.synchronize()
        runs.append(ev[0].elapsed_time(ev[1]))
        return istate

    fused_solve.run_until_done(step)
    return runs


def phase_fused_modes(mixed: dict, fast: dict) -> dict:
    """The whole-solve kernel in each non-parity mode at the headline (B =
    65,536, tout 400, f64): K2 and budget 32 (K3 + K4) through
    make_fused_solve, each bit for bit the eager solve of the same mode
    (the states mixed_headline and fast_f64 computed; the fast_math
    combinations with "single" and "refined" solved here), every lane
    SUCCESS; the bare-launch time of each mode in turns with parity's, the
    K3/K4 launches' times, each mode's registers and spills and its bound;
    then a float32-state leg at B = 4,096 to MODES_F32_TOUT, K2 and budget 7
    against the eager float32 solve of each mode."""
    eager = {"single": ("mixed", mixed["single"]["result"], mixed["single"]["wall_s"]),
             "refined": ("mixed", mixed["refined"]["result"], mixed["refined"]["wall_s"]),
             "fast_math": ("headline", fast["result"], fast["wall_s"])}
    inputs = {"mixed": mixed_inputs(B), "headline": ensemble_inputs(B)}
    for mode in ("fast_math_single", "fast_math_refined"):
        opts = FUSED_MODES[mode]
        res = {}
        wall = wall_s(lambda: res.update(out=run_mode(*inputs["headline"], "cuda", TOUT, opts)))
        eager[mode] = ("headline", res["out"], wall)
    tol = tol_sv(1e-4, ATOL, device="cuda")
    # parity's bare launch in turns with the modes'
    st_par = ensemble_init(roberts_factory, *inputs["headline"], device="cuda")
    p_par = on_card(inputs["headline"][0])
    starts = {}
    for mode, (which, _, _) in eager.items():
        params, yy0, yp0 = inputs[which]
        starts[mode] = (ensemble_init(roberts_factory, params, yy0, yp0, device="cuda",
                                      opts=FUSED_MODES[mode]), on_card(params))
    bare = {m: [] for m in ("parity",) + tuple(eager)}
    # one launch each first: the first launch of a library just loaded is
    # cold (10-70 ms on the H100)
    for mode in eager:
        bare_launch_ms(*starts[mode], opts=FUSED_MODES[mode])
    for _ in range(3):
        bare["parity"].append(bare_launch_ms(st_par, p_par))
        for mode in eager:
            bare[mode].append(bare_launch_ms(*starts[mode], opts=FUSED_MODES[mode]))
    parity_ptxas = solve_kernel_ptxas()
    rows = {}
    for mode, (which, (est, etret, eist), eager_wall) in eager.items():
        opts = FUSED_MODES[mode]
        st0, p_b = starts[mode]
        k2 = fused_solve.make_fused_solve(roberts_factory, tol, opts)
        k34 = fused_solve.make_fused_solve(roberts_factory, tol, opts, attempt_budget=32)
        times = mode_launch_times(opts, st0, p_b, 32)
        # the main path: K2, then budget 32, each through the entry point
        fused_solve.reset_launch_counts()
        st, tret, ist = k2(st0, p_b, TOUT)
        sb, tb, ib = k34(st0, p_b, TOUT)
        torch.cuda.synchronize()
        launches = {k: fused_solve.MODE_LAUNCHES.get((k, mode, "roberts"), 0)
                    for k in ("solve", "init", "cont")}
        other = {k: c for k, c in fused_solve.MODE_LAUNCHES.items() if k[1] != mode}
        diff_k2 = first_difference(st, est, {"tret": tret, "istate": ist},
                                   {"tret": etret, "istate": eist})
        diff_k34 = first_difference(sb, est, {"tret": tb, "istate": ib},
                                    {"tret": etret, "istate": eist})
        err = max(max_abs_diff(st, est), max_abs_diff(sb, est))
        walls = [wall_s(lambda: k2(st0, p_b, TOUT)) for _ in range(3)]
        totals = counter_totals(st)
        bound, bound_by = solve_bound(st0, mode_ops(totals, opts, torch.float64), opts)
        # K3 and K4's bounds: the work of the average launch of each kind
        per_launch_ops = {dt: n / len(times) for dt, n in
                          mode_ops(totals, opts, torch.float64).items()}
        bound_34, by_34 = solve_bound(st0, per_launch_ops, opts)
        ptxas = solve_kernel_ptxas(opts)
        n_ok = int((ist == C.SUCCESS).sum())
        occ = fused_solve.occupancy(torch.float64, opts)
        rows[mode] = {
            "solve": {"launches": launches["solve"], "ms": statistics.median(bare[mode]),
                      "plain_ms": eager_wall * 1e3, "bound_ms": bound, "bound_by": bound_by,
                      "max_abs_err": err},
            "init": {"launches": launches["init"], "ms": times[0], "plain_ms": eager_wall * 1e3,
                     "bound_ms": bound_34, "bound_by": by_34, "max_abs_err": err},
            "cont": {"launches": launches["cont"], "ms": statistics.mean(times[1:]),
                     "plain_ms": eager_wall * 1e3, "bound_ms": bound_34, "bound_by": by_34,
                     "max_abs_err": err},
        }
        emit("fused_modes", mode=mode, batch=B, tout=TOUT, dtype="float64", inputs=which,
             lanes_success=n_ok, first_difference_k2=diff_k2, first_difference_k3_k4=diff_k34,
             max_abs_err=err, launches=launches, other_modes_launched=str(other),
             bare_launch_ms=bare[mode], parity_bare_launch_ms=bare["parity"],
             k3_ms=times[0], k4_ms=times[1:], fused_walls_s=walls, eager_wall_s=eager_wall,
             eager_over_fused=eager_wall / statistics.median(walls), bound_ms=bound,
             bound_by=bound_by, ops={str(k): v for k, v in mode_ops(totals, opts,
                                                                     torch.float64).items()},
             ptxas=ptxas, parity_ptxas=parity_ptxas, occupancy=occ, lu_dtype=str(st.lu.dtype),
             **totals)
        check(diff_k2 is None, f"fused_modes {mode}: K2 {diff_k2} != the eager mode")
        check(diff_k34 is None, f"fused_modes {mode}: budget 32 {diff_k34} != the eager mode")
        check(n_ok == B, f"fused_modes {mode}: {B - n_ok} lanes not SUCCESS")
        check(launches["solve"] == 1 and launches["init"] == 1 and launches["cont"] > 0,
              f"fused_modes {mode}: launches {launches}")
        check(not other, f"fused_modes {mode}: another mode's kernel launched: {other}")
        check(ptxas.get("spill_stores", 0) == 0, f"fused_modes {mode}: the kernel spills: {ptxas}")

    # float32 states at B = 4,096 to MODES_F32_TOUT: K2 and budget 7
    # against the eager mode
    params, yy0, yp0 = ensemble_inputs(B_MODES_F32)
    tol32 = tol_sv(1e-4, ATOL, device="cuda", dtype=torch.float32)
    tout = MODES_F32_TOUT
    for mode, opts in FUSED_MODES.items():
        st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda",
                            dtype=torch.float32, opts=opts)
        est, etret, eist = make_ensemble_solve(roberts_factory, opts)(st0, params, tol32, tout)
        got = fused_solve.make_fused_solve(roberts_factory, tol32, opts)(st0, params, tout)
        bud = fused_solve.make_fused_solve(roberts_factory, tol32, opts, attempt_budget=7)(
            st0, params, tout)
        outs = {"tret": etret, "istate": eist}
        diff = [first_difference(g[0], est, {"tret": g[1], "istate": g[2]}, outs)
                for g in (got, bud)]
        n_ok = int((got[2] == C.SUCCESS).sum())
        emit("fused_modes_f32", mode=mode, batch=B_MODES_F32, tout=tout,
             first_difference_k2=diff[0], first_difference_budget7=diff[1], lanes_success=n_ok,
             nst=int(got[0].nst.sum()),
             max_abs_err=max(max_abs_diff(g[0], est) for g in (got, bud)))
        check(diff == [None, None], f"fused_modes_f32 {mode}: {diff} != the eager mode")
        check(n_ok == B_MODES_F32, f"fused_modes_f32 {mode}: lanes not SUCCESS")
    return rows


# ------------------------------------------------------------------ the mesh

MESH_RANKS = 2  # gloo ranks on the one card
MESH_HEAT_M = 16
# each problem's horizon: the BBD twin stops a decade earlier, its solve
# being the phase's longest (12.9 s on one rank to 0.01, against heat2d's
# 1.1 s; 20.6 s on each gloo rank)
MESH_HEAT_TOUTS = {"heat2d": 0.01, "bbd": 0.001}
MESH_FIELDS = ("yy", "yp", "phi", "tn", "hh", "kk") + COUNTERS


def mesh_heat_problems(device) -> dict:
    """heat2d m = 16 with its diagonal preconditioner, and with the BBD
    preconditioner in MESH_RANKS blocks (keep bandwidths 4, as
    tests/test_bbd_prec.py's sharded cases)."""
    base = heat2d_problem(MESH_HEAT_M, use_prec=False, device=device)
    bbd = make_bbd_prec(base.res, base.n, 4, 4, nblocks=MESH_RANKS)
    return {"heat2d": heat2d_problem(MESH_HEAT_M, use_prec=True, device=device),
            "bbd": IdaProblem(n=base.n, res=base.res, id=base.id, **bbd.hooks())}


def mesh_heat_solve(prob, device, tout, mesh=None):
    """``prob`` to ``tout`` on SPGMR from the C initial profile:
    unsharded, or its state vector over ``mesh``'s batch axis."""
    u0, up0 = heat2d_ic(MESH_HEAT_M)
    opts = IdaOptions(linear_solver="spgmr", mxstep=2000)
    st = init_state(prob, u0, up0, opts=opts, device=device)
    tol = tol_ss(1e-5, 1e-8, device=device)
    if mesh is None:
        return core_solve(st, prob, opts, tol, tout)
    st = mesh_lib.shard_state_vector(st, mesh, prob.n, problem=prob)
    return mesh_lib.sharded_solve(st, prob, opts, tol, tout, mesh=mesh)


def mesh_fields(st) -> dict:
    """The fields the mesh phase holds bit for bit, on the host."""
    return {f: getattr(st, f).cpu() for f in MESH_FIELDS}


def mesh_dp(mesh, refs: dict) -> dict:
    """This rank's share of the headline through ``EnsembleIDA(mesh=...)``
    (the user path: the whole batch's results come back on every rank), the
    same lanes through ``shard_ensemble`` + ``make_ensemble_solve`` with the
    collectives counted, the rank's lanes solved alone without a mesh, and
    K2 on the rank's shard; each held bit for bit against the unsharded
    runs of ``refs`` (the parent's eager solve and K2 launch)."""
    dev = mesh_lib.mesh_device(mesh)
    k, size = mesh_lib.axis_index(mesh, "batch"), mesh_lib.axis_size(mesh, "batch")
    part = slice(k * B // size, (k + 1) * B // size)
    params, yy0, yp0 = ensemble_inputs(B)
    tol = tol_sv(1e-4, ATOL, device=dev)
    small_lu.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = EnsembleIDA(roberts_factory, params, yy0, yp0, tol, mesh=mesh)
    tret, istate = ens.solve(TOUT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"factor": small_lu.FACTOR_LAUNCHES, "solve": small_lu.SOLVE_LAUNCHES}
    whole = ens.states
    ok_whole = (bool(np.array_equal(tret, refs["tret"].numpy()))
                and bool(np.array_equal(istate, refs["istate"].numpy()))
                and all(same(getattr(whole, f).cpu(), refs["eager"][f]) for f in MESH_FIELDS))

    st = mesh_lib.shard_ensemble(ensemble_init(roberts_factory, params, yy0, yp0, device=dev), mesh)
    p_loc = mesh_lib.shard_ensemble(torch.as_tensor(params, device=dev), mesh)
    mesh_lib.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_s, _, _ = make_ensemble_solve(roberts_factory)(st, p_loc, tol, TOUT)
    torch.cuda.synchronize()
    shard_wall = time.perf_counter() - t0
    coll = dict(mesh_lib.COLLECTIVES)
    st1, _, _ = run_ensemble(params[part], yy0[part], yp0[part], dev, TOUT)
    ok_shard = all(same(getattr(st_s, f), getattr(st1, f)) for f in MESH_FIELDS)
    ok_ens = all(same(x, y) for x, y in zip(mesh_fields(from_native(ens._native)).values(),
                                            mesh_fields(st1).values()))
    ok_eager = all(same(getattr(st_s, f).cpu(), refs["eager"][f][part]) for f in MESH_FIELDS)

    fused_solve.reset_launch_counts()
    k2 = fused_fn(dev)(st, p_loc.contiguous(), TOUT)[0]
    torch.cuda.synchronize()
    launches["fused_solve"] = fused_solve.launch_count("solve")
    ok_k2 = all(same(getattr(k2, f).cpu(), refs["k2"][f][part]) for f in MESH_FIELDS)
    return {"rank": dist.get_rank(), "lanes": part.stop - part.start, "wall_s": wall,
            "solve_wall_s": shard_wall, "launches": launches, "collectives_in_solve": coll,
            "whole_batch_equal_unsharded": ok_whole, "shard_equal_per_shard_run": ok_shard,
            "ensemble_ida_equal_per_shard_run": ok_ens, "shard_equal_unsharded": ok_eager,
            "k2_shard_equal_unsharded_k2": ok_k2}


def mesh_sharded_n(mesh, names=("heat2d", "bbd")) -> dict:
    """heat2d m = 16 and its BBD-blocked twin (``names`` of them) with the
    state vector over the ranks: counters, gathered yy and phi[0],
    collectives and walls."""
    dev = mesh_lib.mesh_device(mesh)
    out = {}
    for name, prob in mesh_heat_problems(dev).items():
        if name not in names:
            continue
        mesh_lib.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, tret, ist = mesh_heat_solve(prob, dev, MESH_HEAT_TOUTS[name], mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        coll = dict(mesh_lib.COLLECTIVES)
        out[name] = {"wall_s": wall, "collectives": coll, "istate": int(ist), "tret": float(tret),
                     "counters": {f: int(getattr(st, f)) for f in COUNTERS + ("nli", "nps")},
                     "yy": mesh_lib.gather(st.yy, mesh, "batch").cpu(),
                     "phi0": mesh_lib.gather(st.phi[0], mesh, "batch").cpu()}
    return out


# the food web sharded over N (idaFoodWeb_kry_p: a subgrid a rank, calc_ic,
# the block-diagonal preconditioner on each rank's own points): the IC once,
# then each case's four legs of bench.py::run_foodweb from it
MESH_FOOD_CASES = {"foodweb_sharded": {}, "foodweb_sharded_features": {},
                   "foodweb_sharded_single": {"ls_precision": "single"}}
MESH_FOOD_CENTRE = 2 * ((FOOD_M // 2) * FOOD_M + FOOD_M // 2)  # the prey row at (10, 10)
# the prey's rate there rises from 10.45 through this level at ~8e-4, before
# the first tout. The prey itself moves less than an ulp across the root
# finder's ttol, so a root of it lands on a zero of g at most levels and the
# next call returns CLOSE_ROOTS (C IDA's IDARcheck2)
MESH_FOOD_RATE_LEVEL = 11.5
MESH_FOOD_COUNTERS = KRYLOV + ("nre", "nsetups", "njtimes", "nge")


def mesh_food_problem(case: str, device):
    """The 20 x 20 food web; the features case with a root function (the
    prey's rate at the centre minus MESH_FOOD_RATE_LEVEL) and a quadrature
    (the total prey)."""
    prob = foodweb_problem(FOOD_M, FOOD_M, device=device)
    if case == "foodweb_sharded_features":
        p = MESH_FOOD_CENTRE
        prob = dataclasses.replace(
            prob, root=lambda t, yy, yp: yp[p:p + 1] - MESH_FOOD_RATE_LEVEL, nroots=1,
            quad=lambda t, yy, yp: yy[0::2].sum(0, keepdim=True), nquad=1)
    return prob


def k1_n2_launches() -> dict:
    """K1's N = 2 launches since the last reset, and how many took the group
    skeleton."""
    keys = {"factor": ("factor", "f64", 2), "solve": ("solve", "f64", 2),
            "solve_f32": ("solve", "f32", 2)}
    out = {k: small_lu.LAUNCHES[key] for k, key in keys.items()}
    out["group"] = {k: small_lu.GROUP_LAUNCHES[key] for k, key in keys.items()}
    return out


def mesh_foodweb(mesh=None, cases=tuple(MESH_FOOD_CASES), device="cuda") -> dict:
    """The food web with its state over ``mesh``'s batch axis, or on one
    rank (mesh None): calc_ic("ya_ydp") once, then each case's legs from
    that IC (constraints y >= 0 on every component in the features case; a
    root return resumed), with K1's launches, the collectives and the walls
    of each; the state's pdata after the first case's legs; on a mesh, K1
    on the rank's blocks held against its plain version. One rank runs on
    ``device``, a mesh's ranks on theirs."""
    dev = device if mesh is None else mesh_lib.mesh_device(mesh)
    tol = tol_ss(1e-5, 1e-5, device=dev)
    c0, cp0 = foodweb_ic(FOOD_M, FOOD_M)

    def whole(x):
        return (x if mesh is None else mesh_lib.gather(x, mesh, "batch")).cpu()

    def start(case):
        prob = mesh_food_problem(case, dev)
        opts = dataclasses.replace(foodweb_opts(), **MESH_FOOD_CASES[case])
        st = init_state(prob, c0, cp0, opts=opts, device=dev)
        if case == "foodweb_sharded_features":
            st = st._replace(constraints=torch.ones_like(st.constraints),
                             constraints_set=torch.ones_like(st.constraints_set))
        if mesh is not None:
            st = mesh_lib.shard_state_vector(st, mesh, prob.n, problem=prob)
        return prob, opts, st

    def timed_counts(fn):
        small_lu.reset_launch_counts()
        mesh_lib.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, k1_n2_launches(), dict(mesh_lib.COLLECTIVES)

    prob, opts, st = start("foodweb_sharded")
    if mesh is None:
        (st, ok), wall, _, coll = timed_counts(
            lambda: core_calc_ic(st, prob, opts, tol, IC_YA_YDP_INIT, FOOD_TOUTS[0]))
    else:
        (st, ok), wall, _, coll = timed_counts(lambda: mesh_lib.sharded_calc_ic(
            st, prob, opts, tol, "ya_ydp", FOOD_TOUTS[0], mesh=mesh))
    out = {"rank": dist.get_rank() if mesh is not None else None, "ic_ok": bool(ok),
           "ic_wall_s": wall, "ic_collectives": coll, "ic": [whole(st.phi[0]), whole(st.phi[1])]}
    for case in cases:
        prob, opts, cst = start(case)
        cst = cst._replace(phi=st.phi, yy=st.yy, yp=st.yp)

        def legs():
            nonlocal cst
            calls = []
            for tout in FOOD_TOUTS:
                for _ in range(4):
                    if mesh is None:
                        cst, tret, ist = core_solve(cst, prob, opts, tol, tout)
                    else:
                        cst, tret, ist = mesh_lib.sharded_solve(cst, prob, opts, tol, tout,
                                                                mesh=mesh)
                    calls.append({"tret": float(tret), "istate": int(ist),
                                  "counters": {f: int(getattr(cst, f))
                                               for f in MESH_FOOD_COUNTERS},
                                  "iroots": cst.iroots.cpu(), "yQ": cst.yQ.cpu()})
                    if not (int(ist) == C.ROOT_RETURN and float(tret) < tout):
                        break
            return calls

        calls, wall, launches, coll = timed_counts(legs)
        out[case] = {"calls": calls, "wall_s": wall, "launches": launches, "collectives": coll,
                     "yy": whole(cst.yy), "yp": whole(cst.yp)}
        if case == cases[0]:
            out[case]["pdata"] = [x.cpu() for x in cst.pdata]
            if mesh is not None:
                out[case]["k1"] = mesh_food_k1(cst, mesh)
    return out


def mesh_food_k1(st, mesh) -> dict:
    """K1 at N = 2 on this rank's blocks at ``st`` (its points, the cj of its
    last lsetup), factor and solve against their plain versions bit for bit
    (launches made after the path's counts were read)."""
    with sharding.use_mesh(mesh, state_axis="batch"):
        pts = foodweb.own_points(2 * FOOD_M * FOOD_M)
    blocks = foodweb.prec_blocks(FOOD_M, FOOD_M, st.cjold, st.yy, pts)
    rb = st.yy.reshape((-1, 2)).t().contiguous()
    f, g = small_lu.lu_factor(blocks), dense_lu.lu_factor_unrolled(blocks)
    x, y = small_lu.lu_solve(f, rb), dense_lu.lu_solve_unrolled(g, rb)
    torch.cuda.synchronize()
    return {"systems": blocks.shape[2], "bitwise_equal": same(f.lu, g.lu) and same(f.piv, g.piv)
            and same(x, y), "max_abs_err": max(float((f.lu - g.lu).abs().max()),
                                                float((x - y).abs().max()))}


def mesh_rank(rank: int, world: int, root: str, backend: str) -> None:
    """One rank of the mesh phase, started by torch.multiprocessing (spawn):
    a ``backend`` group of ``world`` ranks (rendezvous through a file under
    ``root``), the kernels loaded from the parent's build, its results saved
    under ``root``."""
    dist.init_process_group(backend, init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=world)
    try:
        mesh = mesh_lib.make_mesh(world)
        refs = torch.load(f"{root}/refs.pt", weights_only=False)
        out = {"dp": mesh_dp(mesh, refs)}
        # the BBD twin's blocks are MESH_RANKS: the gloo leg's ranks
        out["sharded_n"] = mesh_sharded_n(mesh, ("heat2d", "bbd") if backend == "gloo"
                                          else ("heat2d",))
        out["foodweb"] = mesh_foodweb(mesh, tuple(MESH_FOOD_CASES) if backend == "gloo"
                                      else ("foodweb_sharded",))
        torch.save(out, f"{root}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_spawn(root: str, world: int, backend: str):
    """Start the ranks (spawn, no join yet)."""
    return torch.multiprocessing.start_processes(mesh_rank, args=(world, root, backend),
                                                 nprocs=world, join=False, start_method="spawn")


def mesh_join(ctx, root: str, world: int) -> list:
    while not ctx.join():
        pass
    return [torch.load(f"{root}/rank{r}.pt", weights_only=False) for r in range(world)]


def mesh_check_sharded_n(single: dict, ranks: list, backend: str) -> None:
    """The ranks' sharded-N solves against the one-rank runs ``single``:
    counters and bits."""
    for name, ref in single.items():
        st = ref["st"]
        want = {f: int(getattr(st, f)) for f in COUNTERS + ("nli", "nps")}
        rows = [r["sharded_n"][name] for r in ranks]
        bitwise = [same(x["yy"], st.yy.cpu()) and same(x["phi0"], st.phi[0].cpu()) for x in rows]
        emit("mesh_sharded_n", problem=name, backend=backend, m=MESH_HEAT_M,
             tout=MESH_HEAT_TOUTS[name],
             ranks=len(rows), one_rank_wall_s=ref["wall_s"], one_rank_counters=want,
             walls_s=[x["wall_s"] for x in rows], counters=[x["counters"] for x in rows],
             collectives=[x["collectives"] for x in rows], bitwise_equal_one_rank=bitwise,
             max_abs_err=max(float((x["yy"] - st.yy.cpu()).abs().max()) for x in rows))
        check(ref["istate"] == C.SUCCESS and all(x["istate"] == C.SUCCESS for x in rows),
              f"{name}: a sharded-N solve failed")
        check(all(x["counters"] == want for x in rows), f"{name}: counters != the one-rank run")
        check(all(bitwise), f"{name}: sharded yy/phi[0] != the one-rank run")
        check(all(x["collectives"]["calls"] > 0 for x in rows), f"{name}: no collective")


def mesh_check_foodweb(single: dict, ranks: list, food: dict, backend: str) -> dict:
    """The ranks' sharded food web against the one-rank run ``single``: the
    IC, every call's counters, tret, istate, iroots and yQ, and yy/yp at the
    end bit for bit; each rank's pdata its slice of the one-rank pdata, K1 at
    N = 2 launched on each rank's shard and bit for bit its plain version
    there; nst/nli those of the ``foodweb`` phase (``food``). Returns each
    case's K1 launches a rank."""
    rows = [r["foodweb"] for r in ranks]
    launches = {}
    for x in rows:
        check(x["ic_ok"] and all(same(a, b) for a, b in zip(x["ic"], single["ic"])),
              f"{backend} rank {x['rank']}: the sharded IC != the one-rank IC")
        check(x["ic_collectives"]["calls"] == 3,
              f"{backend} rank {x['rank']}: the IC made {x['ic_collectives']} gathers, not 3")
    for case in rows[0]:
        if not case.startswith("foodweb_sharded"):
            continue
        ref = single[case]
        got = [x[case] for x in rows]
        bitwise = [len(g["calls"]) == len(ref["calls"])
                   and all(a["tret"] == b["tret"] and a["istate"] == b["istate"]
                           and a["counters"] == b["counters"] and same(a["iroots"], b["iroots"])
                           and same(a["yQ"], b["yQ"]) for a, b in zip(g["calls"], ref["calls"]))
                   and same(g["yy"], ref["yy"]) and same(g["yp"], ref["yp"]) for g in got]
        end = ref["calls"][-1]
        launches[case] = [g["launches"] for g in got]
        emit(f"mesh_{case}", backend=backend, ranks=len(got), grid=f"{FOOD_M}x{FOOD_M}",
             n=2 * FOOD_M * FOOD_M, touts=FOOD_TOUTS,
             statuses=[[c["istate"] for c in g["calls"]] for g in got],
             counters=end["counters"], yQ=[float(v) for v in end["yQ"]],
             root_returns=[c["tret"] for c in ref["calls"] if c["istate"] == C.ROOT_RETURN],
             one_rank_wall_s=ref["wall_s"], walls_s=[g["wall_s"] for g in got],
             ic_walls_s=[x["ic_wall_s"] for x in rows], one_rank_ic_wall_s=single["ic_wall_s"],
             collectives=[g["collectives"] for g in got],
             ic_collectives=[x["ic_collectives"] for x in rows],
             k1_launches=[g["launches"] for g in got], one_rank_k1_launches=ref["launches"],
             k1_on_shard=[g.get("k1") for g in got], bitwise_equal_one_rank=bitwise)
        check(all(bitwise), f"{backend} {case}: the sharded run != the one-rank run")
        check(all(c["istate"] in (C.SUCCESS, C.ROOT_RETURN) for c in ref["calls"])
              and ref["calls"][-1]["istate"] == C.SUCCESS, f"{case}: {ref['calls']}")
        key = "solve_f32" if "single" in case else "solve"
        check(all(g["launches"]["factor"] > 0 and g["launches"][key] > 0 for g in got),
              f"{backend} {case}: K1 N = 2 launches {[g['launches'] for g in got]}")
        check(all(g["collectives"]["calls"] > 0 for g in got), f"{backend} {case}: no collective")
        if case == "foodweb_sharded":
            want = {"nst": food["counters"]["nst"], "nli": food["counters"]["nli"]}
            check({k: end["counters"][k] for k in want} == want,
                  f"foodweb_sharded: nst/nli {end['counters']} != the foodweb phase's {want}")
            per = FOOD_M * FOOD_M // len(got)
            for k, g in enumerate(got):
                check(all(same(a, b[k * per:(k + 1) * per])
                          for a, b in zip(g["pdata"], ref["pdata"])),
                      f"{backend} rank {k}: pdata != its slice of the one-rank pdata")
                check(g["k1"]["bitwise_equal"] and g["k1"]["systems"] == per,
                      f"{backend} rank {k}: K1 on the shard != its plain version {g['k1']}")
        if case == "foodweb_sharded_features":
            check(any(c["istate"] == C.ROOT_RETURN for c in ref["calls"])
                  and end["counters"]["nge"] > 0 and float(end["yQ"][0]) > 0.0,
                  f"{case}: no root or no quadrature: {ref['calls']}")
    return launches


def phase_mesh(eager: dict, food: dict) -> dict:
    """``parallel/mesh.py`` on the card: a world of one under NCCL running
    the headline through ``EnsembleIDA(mesh=make_mesh(1))`` (bit for bit the
    slice phase's eager solve, K1's launches the same; K2 on the rank's
    shard bit for bit the unsharded K2); two gloo ranks on the one card with
    CUDA tensors (the headline's lanes split 32,768 a rank, each bit for bit
    its per-shard solve and the unsharded one, with no collective inside a
    rank's solve; heat2d m = 16 SPGMR and its BBD-blocked twin with the
    state vector over the ranks, bit for bit the one-rank runs, with their
    collectives and bytes; the 20 x 20 food web sharded over N,
    ``sharded_calc_ic`` then the four legs, with constraints, a root
    function and a quadrature, and under ``ls_precision="single"``, each bit
    for bit the one-rank run, K1 at N = 2 on each rank's 200 grid points);
    with more than one card, NCCL with one rank a card on the headline's
    lanes, heat2d and the food web."""
    est, etret, eistate = eager["result"]
    refs = {"eager": mesh_fields(est), "tret": etret.cpu(), "istate": eistate.cpu()}
    params, yy0, yp0 = ensemble_inputs(B)
    st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cuda")
    k2_full = fused_fn("cuda")(st0, on_card(params), TOUT)[0]
    refs["k2"] = mesh_fields(k2_full)
    ok_k2_eager = all(same(refs["k2"][f], refs["eager"][f]) for f in MESH_FIELDS)

    with tempfile.TemporaryDirectory() as root:
        torch.save(refs, f"{root}/refs.pt")
        t_spawn = time.perf_counter()
        ctx = mesh_spawn(root, MESH_RANKS, "gloo")

        # a world of one under NCCL, in this process, while the ranks start
        mesh1 = mesh_lib.make_mesh(1)
        backend = dist.get_backend()
        one = mesh_dp(mesh1, refs)
        dist.destroy_process_group()
        emit("mesh_one_rank", backend=backend, batch=B, tout=TOUT, k2_equal_eager=ok_k2_eager,
             slice_launches=eager["launches"], slice_wall_s=eager["wall_s"], **one)
        check(ok_k2_eager, "the unsharded K2 != the eager headline")
        check({k: one["launches"][k] for k in eager["launches"]} == eager["launches"],
              f"mesh of one: K1 launches {one['launches']} != the slice's {eager['launches']}")
        for key in ("whole_batch_equal_unsharded", "shard_equal_per_shard_run",
                    "ensemble_ida_equal_per_shard_run", "shard_equal_unsharded",
                    "k2_shard_equal_unsharded_k2"):
            check(one[key], f"mesh of one: {key} is false")

        # the one-rank runs of the sharded-N problems, while the ranks work
        single = {}
        for name, prob in mesh_heat_problems("cuda").items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, tret, ist = mesh_heat_solve(prob, "cuda", MESH_HEAT_TOUTS[name])
            torch.cuda.synchronize()
            single[name] = {"wall_s": time.perf_counter() - t0, "st": st, "tret": float(tret),
                            "istate": int(ist)}
        single_food = mesh_foodweb()
        ranks = mesh_join(ctx, root, MESH_RANKS)
        spawn_s = time.perf_counter() - t_spawn

    for r in ranks:
        dp = r["dp"]
        emit("mesh_dp_gloo", ranks=MESH_RANKS, **dp)
        check(dp["collectives_in_solve"]["calls"] == 0,
              f"rank {dp['rank']}: collectives inside the dp solve {dp['collectives_in_solve']}")
        for key in ("whole_batch_equal_unsharded", "shard_equal_per_shard_run",
                    "ensemble_ida_equal_per_shard_run", "shard_equal_unsharded",
                    "k2_shard_equal_unsharded_k2"):
            check(dp[key], f"rank {dp['rank']}: {key} is false")
    mesh_check_sharded_n(single, ranks, "gloo")
    food_launches = {"one_rank": {c: single_food[c]["launches"] for c in MESH_FOOD_CASES},
                     "gloo": mesh_check_foodweb(single_food, ranks, food, "gloo")}

    cards = torch.cuda.device_count()
    multi = None
    if cards > 1:
        with tempfile.TemporaryDirectory() as root:
            torch.save(refs, f"{root}/refs.pt")
            t0 = time.perf_counter()
            multi = mesh_join(mesh_spawn(root, cards, "nccl"), root, cards)
            nccl_s = time.perf_counter() - t0
        for r in multi:
            dp = r["dp"]
            emit("mesh_dp_nccl", ranks=cards, **dp)
            for key in ("whole_batch_equal_unsharded", "shard_equal_per_shard_run",
                        "ensemble_ida_equal_per_shard_run", "shard_equal_unsharded",
                        "k2_shard_equal_unsharded_k2"):
                check(dp[key], f"nccl rank {dp['rank']}: {key} is false")
            check(dp["collectives_in_solve"]["calls"] == 0,
                  f"nccl rank {dp['rank']}: collectives inside the dp solve")
        mesh_check_sharded_n({"heat2d": single["heat2d"]}, multi, "nccl")
        food_launches["nccl"] = mesh_check_foodweb(single_food, multi, food, "nccl")
        emit("mesh_multi_card", ran=True, ranks=cards, spawn_and_ranks_s=nccl_s)
        multi = [r["dp"] for r in multi]
    else:
        emit("mesh_multi_card", ran=False,
             reason=f"{cards} card: NCCL with one rank a card needs more than one")
    emit("mesh", spawn_and_ranks_s=spawn_s, gloo_ranks=MESH_RANKS, cards=cards)
    return {"one": one, "gloo": [r["dp"] for r in ranks], "multi": multi,
            "foodweb": food_launches}

# ------------------------------------------- fused_models: generated models
#
# The whole-solve kernel takes any batch-native factory with an analytic jac
# (ops/fused_model.py generates its model from the factory's torch code).
# Factories as a user writes them, with plain torch ops: Akzo Nobel
# (CHEMAKZO of the IVP Test Set, F. Mazzia and C. Magherini, Univ. of Bari:
# N = 6, y6 algebraic), Lorenz '63 with per-lane parameters, Roberts through
# a factory that is not models.roberts_factory (so its model is generated,
# held bit for bit against the hand-written one), and a zoo of every
# elementwise op the emitter compiles (the table of ops only).

AKZO_K = np.array([18.7, 0.58, 0.09, 0.42])  # k1..k4, per lane
AKZO_BIG_K, AKZO_KLA, AKZO_KS, AKZO_PCO2, AKZO_H = 34.4, 3.3, 115.83, 0.9, 737.0
AKZO_Y0 = np.array([0.444, 0.00123, 0.0, 0.007, 0.0, AKZO_KS * 0.444 * 0.007])
AKZO_TOUT = 180.0  # the test set's end point
AKZO_RTOL, AKZO_ATOL, AKZO_REF_RTOL = 1e-4, 1e-6, 1e-10
LORENZ = np.array([10.0, 28.0, 8.0 / 3.0])  # sigma, rho, beta
LORENZ_TOUT = 1.0
B_OPS = 4096  # random lanes of the table of ops
MODEL_BUDGET = 32


@functools.cache
def _akzo_id(device) -> torch.Tensor:
    return torch.tensor([True] * 5 + [False], device=device)


def akzo_factory(params):
    """CHEMAKZO: F = y' - f(y) on rows 1-5, F6 = Ks y1 y4 - y6; params [k1,
    k2, k3, k4] per lane."""
    k1, k2, k3, k4 = params[0], params[1], params[2], params[3]

    def res(t, yy, yp):
        s2 = torch.sqrt(yy[1])
        r1 = k1 * yy[0] ** 4 * s2
        r2 = k2 * yy[2] * yy[3]
        r3 = k2 / AKZO_BIG_K * yy[0] * yy[4]
        r4 = k3 * yy[0] * yy[3] ** 2
        r5 = k4 * yy[5] ** 2 * s2
        fin = AKZO_KLA * (AKZO_PCO2 / AKZO_H - yy[1])
        f = [-2.0 * r1 + r2 - r3 - r4, -0.5 * r1 - r4 - 0.5 * r5 + fin, r1 - r2 + r3,
             -r2 + r3 - 2.0 * r4, r2 - r3 + r5]
        return torch.stack([yp[i] - f[i] for i in range(5)]
                           + [AKZO_KS * yy[0] * yy[3] - yy[5]])

    def jac(t, cj, yy, yp, rr):
        y1, y2, y3, y4, y5, y6 = (yy[i] for i in range(6))
        s2 = torch.sqrt(y2)
        d1, d2 = 4.0 * k1 * y1 ** 3 * s2, k1 * y1 ** 4 * (0.5 / s2)  # r1 by y1, y2
        e3, e4 = k2 * y4, k2 * y3  # r2 by y3, y4
        g1, g5 = k2 / AKZO_BIG_K * y5, k2 / AKZO_BIG_K * y1  # r3 by y1, y5
        h1, h4 = k3 * y4 ** 2, 2.0 * k3 * y1 * y4  # r4 by y1, y4
        m2, m6 = k4 * y6 ** 2 * (0.5 / s2), 2.0 * k4 * y6 * s2  # r5 by y2, y6
        z = torch.zeros_like(y1)
        return torch.stack([
            torch.stack([cj + 2.0 * d1 + g1 + h1, 2.0 * d2, -e3, h4 - e4, g5, z]),
            torch.stack([0.5 * d1 + h1, cj + 0.5 * d2 + 0.5 * m2 + AKZO_KLA, z, h4, z, 0.5 * m6]),
            torch.stack([-(d1 + g1), -d2, cj + e3, e4, -g5, z]),
            torch.stack([2.0 * h1 - g1, z, e3, cj + e4 + 2.0 * h4, -g5, z]),
            torch.stack([g1, -m2, -e3, -e4, cj + g5, -m6]),
            torch.stack([AKZO_KS * y4, z, z, AKZO_KS * y1, z, -torch.ones_like(y1)]),
        ])

    return IdaProblem(n=6, res=res, jac=jac, id=_akzo_id(params.device))


def akzo_reference() -> tuple:
    """The nominal lane through the eager port on the CPU at rtol = atol =
    1e-10 (no step limit) to AKZO_TOUT: (yy, nst, istate, wall s). Run in a
    process of its own while the card works (phase_fused_models)."""
    torch.set_num_threads(1)
    params, yy0, yp0 = akzo_inputs(1)
    t0 = time.perf_counter()
    opts = IdaOptions(mxstep=1_000_000)
    st, _, ist = make_ensemble_solve(akzo_factory, opts)(
        ensemble_init(akzo_factory, params, yy0, yp0, device="cpu", opts=opts), params,
        tol_ss(AKZO_REF_RTOL, AKZO_REF_RTOL, device="cpu"), AKZO_TOUT)
    return st.yy[0].numpy(), int(st.nst[0]), int(ist[0]), time.perf_counter() - t0


def akzo_inputs(b: int):
    """k1..k4 x exp(linspace(-0.2, 0.2, b)), the last lane at the nominal
    rates; y'(0) = f(y(0)) on rows 1-5, 0 on the algebraic row."""
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, b)), AKZO_K)
    params[-1] = AKZO_K
    y1, y2, _, y4, _, y6 = AKZO_Y0
    k1, _, k3, k4 = params.T
    r1 = k1 * y1 ** 4 * np.sqrt(y2)
    r4 = k3 * y1 * y4 ** 2
    r5 = k4 * y6 ** 2 * np.sqrt(y2)
    fin = AKZO_KLA * (AKZO_PCO2 / AKZO_H - y2)
    yp0 = np.stack([-2.0 * r1 - r4, -0.5 * r1 - r4 - 0.5 * r5 + fin, r1, -2.0 * r4, r5,
                    np.zeros_like(r1)], axis=1)
    return params, np.tile(AKZO_Y0, (b, 1)), yp0


def lorenz_factory(params):
    """Lorenz '63, F = y' - f(y), params [sigma, rho, beta] per lane."""
    sigma, rho, beta = params[0], params[1], params[2]

    def res(t, yy, yp):
        x, y, z = yy[0], yy[1], yy[2]
        return torch.stack([yp[0] - sigma * (y - x), yp[1] - (x * (rho - z) - y),
                            yp[2] - (x * y - beta * z)])

    def jac(t, cj, yy, yp, rr):
        x, y, z = yy[0], yy[1], yy[2]
        zero = torch.zeros_like(x)
        return torch.stack([torch.stack([cj + sigma, -sigma, zero]),
                            torch.stack([z - rho, cj + 1.0, x]),
                            torch.stack([-y, -x, cj + beta])])

    return IdaProblem(n=3, res=res, jac=jac)


def lorenz_inputs(b: int):
    params = np.outer(np.exp(np.linspace(-0.05, 0.05, b)), LORENZ)
    yy0 = np.ones((b, 3))
    yp0 = np.stack([np.zeros(b), params[:, 1] - 2.0, 1.0 - params[:, 2]], axis=1)
    return params, yy0, yp0


def roberts_generated(params):
    """models.roberts_factory behind a factory of its own: its model is
    generated from the torch code, not the hand-written struct."""
    return roberts_factory(params)


def zoo_factory(params):
    """One row for each elementwise op the emitter compiles, plain torch:
    exp, log, sin, cos, rsqrt, abs (sgn in its jvp), reciprocal (c / x), a
    division by a Python number, pow at the exponents ATen's CUDA kernel
    takes apart (0.5, -0.5, 2, 3, -1, -2) and at 1.7; N = 16 = MAXN."""
    a, b = params[0], params[1]

    def terms(yy):
        y = [yy[i] for i in range(16)]
        pos = [torch.abs(v) + 0.25 for v in y]
        return [torch.exp(a * y[0]), torch.log(pos[1]), torch.sin(b * y[2]), torch.cos(y[3]),
                torch.rsqrt(pos[4]), 2.0 / pos[5], y[6] / 34.4, pos[7] ** 0.5, pos[8] ** -0.5,
                y[9] ** 2, y[10] ** 3, pos[11] ** -1, pos[12] ** -2, pos[13] ** 1.7,
                torch.sqrt(pos[14]) * a, -y[15] * b]

    def res(t, yy, yp):
        f = terms(yy)
        return torch.stack([yp[i] - f[i] * t for i in range(16)])

    def jac(t, cj, yy, yp, rr):
        f = terms(yy)
        z = torch.zeros_like(cj)
        return torch.stack([torch.stack([cj - f[i] * 0.5 if j == i else z for j in range(16)])
                            for i in range(16)])

    return IdaProblem(n=16, res=res, jac=jac)


def ops_zoo_factory(params):
    """One row for each op of the emitter's kinetics/neuron table, plain torch:
    tanh, sinh, cosh, tan, atan, expm1, log1p, maximum, minimum, clamp
    between numbers (both, clamp_min, clamp_max) and between tensors, and
    where over the comparisons and logic of masks (gt, ge, lt, le, eq, ne,
    &, |, ~, a mask cast to the dtype, masked_fill); their jvps bring in
    tanh_backward, logical_and and where; N = 16."""
    a, b = params[0], params[1]

    def terms(yy):
        y = [yy[i] for i in range(16)]
        mask = ((y[14] >= 0.0) & (y[14] != 0.5)) | (y[14] < -2.0)
        return [torch.tanh(a * y[0]), torch.sinh(y[1]), torch.cosh(y[2]), torch.tan(y[3]),
                torch.atan(b * y[4]), torch.expm1(y[5]), torch.log1p(torch.abs(y[6])),
                torch.maximum(y[7], a * y[8]), torch.minimum(y[8], b * y[9]),
                torch.clamp(y[9], -0.5, 0.5), torch.clamp_min(y[10], 0.0),
                torch.clamp(y[11], max=-0.0), torch.clamp(y[12], min=a - 1.0, max=b),
                torch.where(y[13] > a, y[13] * y[13], -y[13]),
                torch.where(mask & ~(y[14] > 3.0), y[14], 0.5 * y[14]),
                torch.where(y[15] <= b, torch.tanh(y[15]), (y[15] == 0.0).to(y[15].dtype))
                .masked_fill(y[15] == 1.0, 2.0)]

    # each op's value alone in res (and its tangent in J v), so that a
    # difference is the op's own
    def res(t, yy, yp):
        return torch.stack(terms(yy))

    def jac(t, cj, yy, yp, rr):
        f = terms(yy)
        z = torch.zeros_like(cj)
        return torch.stack([torch.stack([f[i] * cj if j == i else z for j in range(16)])
                            for i in range(16)])

    return IdaProblem(n=16, res=res, jac=jac)


# name -> (factory, nominal params, what the phase does with it)
GENERATED = {"roberts_generated": (roberts_generated, ROBERTS_PARAMS),
             "akzo": (akzo_factory, AKZO_K), "lorenz": (lorenz_factory, LORENZ),
             "zoo": (zoo_factory, np.array([0.3, 1.3])),
             "ops_zoo": (ops_zoo_factory, np.array([0.3, 1.3])),
             "roberts_quad": (quad_factory, ROBERTS_PARAMS),
             "morris_lecar": (morris_lecar_factory, np.array([I_NOMINAL]))}
# the lanes of the table of ops that hold special values (NaN, +-0, +-inf),
# one in SPECIAL_EVERY, in the models named here
SPECIAL_VALUES = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf])
SPECIAL_EVERY = 4
SPECIAL_MODELS = ("ops_zoo",)
MODEL_LIBS: dict = {}  # name -> FusedModel


def generated_models() -> dict:
    """The models of GENERATED, traced and emitted once (ops/fused_model.py)."""
    if not MODEL_LIBS:
        for name, (factory, p0) in GENERATED.items():
            p = torch.as_tensor(np.tile(p0[:, None], (1, 2)))
            MODEL_LIBS[name] = fused_model.model_of(factory, p)
    return MODEL_LIBS


def model_builds(pool) -> dict:
    """Submit the generated models' libraries to ``pool``: the parity
    library of each solved model, the "refined" ones of Akzo, the
    quadrature Roberts and Morris-Lecar, and the evaluation library of
    every model (the zoos' alone: N = 16)."""
    models = generated_models()
    jobs = {f"{m}/parity": (fused_solve.build, (False, "full", models[m]))
            for m in ("roberts_generated", "akzo", "lorenz", "roberts_quad", "morris_lecar")}
    jobs.update({f"{m}/refined": (fused_solve.build, (False, "refined", models[m]))
                 for m in ("akzo", "roberts_quad", "morris_lecar")})
    jobs.update({f"{m}/eval": (fused_solve.build_eval, (models[m],)) for m in models})
    jobs["roberts/eval"] = (fused_solve.build_eval, (fused_solve.ROBERTS,))
    return {k: pool.submit(fn, *args) for k, (fn, args) in jobs.items()}


def model_ops_per(model) -> dict:
    """:data:`OPS_PER` at ``model``'s N, with its own residual and Jacobian:
    the hand counts at N = 3 scaled by the loops' lengths (predict 22 a
    component, error_test 34, complete_step and the step's preamble 39, the
    LU solve N^2 + 2N, its factor m + 2 m^2 a column plus N pivot tests),
    the model's res, jac and jvp counted in its generated code (a
    statement an operation; pow, sqrt, rsqrt, exp, log, sin and cos 20)."""
    n = model.n
    counts = {}
    fns = ("res", "res_jvp", "jac") + (("quad",) if model.nq else ())
    for fn, nxt in zip(fns, fns[1:] + (None,)):
        body = model.header.split(f"static void {fn}(")[1]
        body = body.split(f"static void {nxt}(")[0] if nxt else body
        body = body.split("#else")[0]
        lines = [x for x in body.splitlines()
                 if x.strip().startswith(("const T e", "const S e"))]
        heavy = sum(1 for x in lines if any(f"model::{k}(" in x for k in (
            "pow_scalar", "pow_tensor", "rsqrt", "exp", "log", "sin", "cos", "tanh", "sinh",
            "cosh", "tan", "atan", "expm1", "log1p")) or "sqrt_of(" in x)
        counts[fn] = len(lines) + 19 * heavy
    factor = sum(m + 2 * m * m for m in range(n)) + n
    # an accepted step's quadratures (ida_lane.cuh accumulate_quad): mid and
    # half, and at each of the three nodes its time, the interpolation
    # (recurrences 25, the rows' products and sums 24 a component), quad
    # and a weight's product and sum a quadrature; then half times it, added
    quad = (4 + 3 * (2 + 25 + 24 * n + counts["quad"] + 2 * model.nq) + 2 * model.nq
            if model.nq else 0)
    return {"attempt": 12 + 22 * n + counts["res"] + 2 * n + 34 * n,
            "newton": (n * n + 2 * n) + 2 * n + (3 * n + 20) + 2,
            "newton_more": 24 + counts["res"] + 2 * n + 1,
            "lsetup": counts["jac"] + factor, "step": 39 * n + 2 + quad,
            "jvp": counts["res_jvp"], "quad": quad}


def model_launch_counts(model) -> dict:
    return {k: n for (k, _, m), n in fused_solve.MODE_LAUNCHES.items() if m == model.name}


def special_lanes(x: np.ndarray, shift: int) -> np.ndarray:
    """``x`` [rows, lanes] with one lane in SPECIAL_EVERY holding NaN, +0,
    -0, +inf or -inf, a different one in each row (``shift`` moves them)."""
    x = x.copy()
    lanes = np.arange(0, x.shape[1], SPECIAL_EVERY)
    for i in range(x.shape[0]):
        x[i, lanes] = SPECIAL_VALUES[(lanes // SPECIAL_EVERY + i + shift) % len(SPECIAL_VALUES)]
    return x


def model_ops_inputs(name: str, n: int, p0: np.ndarray, dtype, rng) -> tuple:
    """Random lanes of the table of ops for model ``name``: params around
    the nominal ones, t, cj, yy, yp and v (special values in the
    SPECIAL_MODELS' lanes; Akzo's yy positive; Morris-Lecar's V in
    [-80, 60] mV and w in [0, 1])."""
    def lanes(x):
        return torch.as_tensor(x, dtype=dtype, device="cuda").contiguous()

    params = p0[:, None] * np.exp(rng.uniform(-0.2, 0.2, (len(p0), B_OPS)))
    yy = rng.normal(size=(n, B_OPS)) * 0.3 + (0.5 if name == "akzo" else 0.0)
    if name == "akzo":
        yy = np.abs(yy)
    if name == "morris_lecar":
        yy = np.stack([rng.uniform(-80.0, 60.0, B_OPS), rng.uniform(0.0, 1.0, B_OPS)])
    yp, v = rng.normal(size=(n, B_OPS)), rng.normal(size=(n, B_OPS))
    if name in SPECIAL_MODELS:
        yy, yp, v = special_lanes(yy, 0), special_lanes(yp, 2), special_lanes(v, 4)
    return (lanes(params), lanes(rng.uniform(0.0, 5.0, B_OPS)),
            lanes(np.exp(rng.uniform(-3.0, 5.0, B_OPS))), lanes(yy), lanes(yp), lanes(v))


def phase_model_ops() -> dict:
    """The table of ops: each generated model's res, jac (at that residual),
    res_jvp (tangents (v, cj v)) and quad (a model with quadratures) on
    B_OPS random lanes through its evaluation kernel, bit for bit (the sign
    of a zero included, NaN equal to NaN) the eager problem's res,
    sys_jacobian, jtimes and quad on the same CUDA tensors, in float64 and
    float32; the SPECIAL_MODELS' lanes hold NaN, +-0 and +-inf too."""
    models = generated_models()
    rng = np.random.default_rng(15)
    table = {}
    for name, (factory, p0) in {**GENERATED, "roberts": (roberts_factory, ROBERTS_PARAMS)}.items():
        model = models.get(name, fused_solve.ROBERTS)
        for dtype in (torch.float64, torch.float32):
            args = model_ops_inputs(name, model.n, p0, dtype, rng)
            fused_solve.reset_launch_counts()
            got = fused_solve.eval_model(factory, *args)
            launches = fused_solve.EVAL_LAUNCHES.get(model.name, 0)
            want = fused_solve.eval_model_plain(factory, *args)
            torch.cuda.synchronize()
            row = {}
            for out, g, w in zip(("res", "jac", "jv", "quad"), got, want):
                if g is None and w is None:
                    continue
                eq = same_bits(g, w)
                zero = w == 0
                row[out] = {"values": int(g.numel()), "differ": int((~eq).sum()),
                            "finite": int(torch.isfinite(w).sum()),
                            "zeros": int(zero.sum()),
                            "negative_zeros": int((zero & torch.signbit(w)).sum()),
                            "zero_sign_differs": int((zero & (g == 0) & (torch.signbit(g)
                                                                        != torch.signbit(w))).sum()),
                            "max_abs_err": float(torch.nan_to_num(g - w).abs().max())}
            table[f"{name}/{str(dtype)[6:]}"] = {**row, "launches": launches}
    emit("fused_models_ops", lanes=B_OPS, table=table,
         special_lanes={"models": list(SPECIAL_MODELS), "every": SPECIAL_EVERY,
                        "values": [str(v) for v in SPECIAL_VALUES]},
         models={k: {"name": m.name, "n": m.n, "p": m.p, "nq": m.nq} for k, m in models.items()})
    for key, row in table.items():
        check(row["launches"] == 1, f"table of ops {key}: {row['launches']} evaluation launches")
        outs = ("res", "jac", "jv") + (("quad",) if models.get(key.split("/")[0],
                                                                fused_solve.ROBERTS).nq else ())
        for out in outs:
            check(row[out]["differ"] == 0, f"table of ops {key}/{out}: {row[out]['differ']} of "
                                           f"{row[out]['values']} values differ from the eager")
    return table


def budgeted_run(factory, model, tol, st0, p_b, tout, per, opts=IdaOptions(),
                 ops_of=None) -> dict:
    """``factory``'s budget-32 solve (K3, then K4 in place until no lane is
    CONTINUE), launch by launch through prepare_launch: each launch's
    CUDA-event ms and operations (from the counters' growth: ``ops_of(st)``,
    by default :func:`solve_ops` of the counters at ``per``); then the
    eager solve(max_attempts=32) call of the first launch and of the first
    continuation, timed (the plain versions of K3 and K4)."""
    ops_of = ops_of or (lambda st: solve_ops(counter_totals(st), per))
    bsz = st0.tn.shape[0]
    tol_in = fused_solve.tol_inputs(tol, model.n, bsz, st0.dtype, st0.phi.device)
    dst = fused_solve.empty_result(st0, opts, model)
    carry = fused_solve.new_carry(bsz, st0.dtype, st0.phi.device, True)
    runs = []

    def step(resume: bool) -> torch.Tensor:
        before = ops_of(dst) if resume else 0
        go = fused_solve.prepare_launch("cont" if resume else "init", dst if resume else st0, dst,
                                        p_b, tol_in, tout, carry, opts, model, MODEL_BUDGET)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        istate = go()
        ev[1].record()
        torch.cuda.synchronize()
        runs.append({"ms": ev[0].elapsed_time(ev[1]), "ops": ops_of(dst) - before})
        return istate

    fused_solve.run_until_done(step)
    p = p_b.t().contiguous()
    native = to_native(st0)
    inputs = fused_solve.lane_inputs(native, p, fused_solve._native_tol(tol, model.n), tout,
                                     model.n)
    tol_n, prob = TolControl(inputs[1], inputs[2]), factory(p)
    plain = []
    out = (native, None, None, None)
    for resume in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = core_solve(out[0], prob, opts, tol_n, inputs[3], max_attempts=MODEL_BUDGET,
                         resume_carry=out[3] if resume else None)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    return {"runs": runs, "plain_ms": plain}


def model_rows(name: str, model, st0, launches: dict, k2_ms: float, plain_ms: float,
               err: float, k34: dict, totals: dict, per: dict) -> dict:
    """The kernels line's K2, K3 and K4 rows of one generated model."""
    bound, by = solve_bound(st0, solve_ops(totals, per), model=model)
    init, cont = k34["runs"][0], k34["runs"][1:]
    b_init, by_init = solve_bound(st0, init["ops"], model=model)
    b_cont, by_cont = solve_bound(st0, statistics.mean(r["ops"] for r in cont), model=model)
    src = {"route": "cuda", "source": FUSED_SOURCE, "model": model.name,
           "model_source": "ida_tpu_torch/ops/fused_model.py", "library_ms": None}
    return {
        "solve": {"name": f"fused_solve_{name}", "replaces": REPLACES["fused_solve"], **src,
                  "launches": launches.get("solve", 0), "max_abs_err": err, "ms": k2_ms,
                  "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by},
        "init": {"name": f"fused_solve_init_{name}", "replaces": REPLACES["fused_solve_init"],
                 **src, "launches": launches.get("init", 0), "max_abs_err": err,
                 "ms": init["ms"], "plain_ms": k34["plain_ms"][0], "bound_ms": b_init,
                 "bound_by": by_init},
        "cont": {"name": f"fused_solve_cont_{name}", "replaces": REPLACES["fused_solve_cont"],
                 **src, "launches": launches.get("cont", 0), "max_abs_err": err,
                 "ms": statistics.mean(r["ms"] for r in cont), "plain_ms": k34["plain_ms"][1],
                 "bound_ms": b_cont, "bound_by": by_cont},
    }


def model_ptxas(model, opts: IdaOptions = IdaOptions()) -> dict:
    forms = solve_kernels_ptxas(opts, model)
    return {"f64": forms["f64_shared_tol"], "f32": forms["f32_shared_tol"],
            "spills": {k: v for k, v in forms.items()
                       if v.get("spill_stores", 0) or v.get("spill_loads", 0)}}


def add_ptxas(kinds: dict, ptxas: dict) -> None:
    """The f64 solve kernel's registers and spill stores on a model's K2,
    K3 and K4 rows (one kernel runs all three)."""
    for row in kinds.values():
        row.update(registers=ptxas["f64"].get("registers"),
                   spill_stores=ptxas["f64"].get("spill_stores", 0))


def solve_model(name: str, factory, model, inputs, tol, tout, dtype=torch.float64,
                opts: IdaOptions = IdaOptions(), all_success: bool = True,
                eager: tuple | None = None) -> dict:
    """One generated model's main path: the eager ensemble solve (wall; or
    ``eager``, its (result, wall) from an earlier phase on the same inputs),
    then K2 and budget 32 (K3 + K4) through make_fused_solve on the same
    CUDA tensors, the launches of that run counted; each bit for bit the
    eager result (and every lane SUCCESS with ``all_success``)."""
    params, yy0, yp0 = inputs
    st0 = ensemble_init(factory, params, yy0, yp0, device="cuda", dtype=dtype, opts=opts)
    p_b = on_card(params, dtype)
    res = {}
    if eager is None:
        wall = wall_s(lambda: res.update(eager=make_ensemble_solve(factory, opts)(
            st0, params, tol, tout)))
    else:
        res["eager"], wall = eager
    est, etret, eist = res["eager"]
    k2 = fused_solve.make_fused_solve(factory, tol, opts)
    k34 = fused_solve.make_fused_solve(factory, tol, opts, attempt_budget=MODEL_BUDGET)
    fused_solve.reset_launch_counts()
    st, tret, ist = k2(st0, p_b, tout)
    sb, tb, ib = k34(st0, p_b, tout)
    torch.cuda.synchronize()
    launches = model_launch_counts(model)
    others = {k: c for k, c in fused_solve.MODE_LAUNCHES.items() if k[2] != model.name}
    diff_k2 = first_difference(st, est, {"tret": tret, "istate": ist},
                               {"tret": etret, "istate": eist})
    diff_k34 = first_difference(sb, est, {"tret": tb, "istate": ib},
                                {"tret": etret, "istate": eist})
    n_ok = int((ist == C.SUCCESS).sum())
    out = {"name": name, "model": model.name, "batch": st0.tn.shape[0], "dtype": str(dtype)[6:],
           "mode": fused_solve.mode_name(opts), "tout": tout, "eager_wall_s": wall,
           "lanes_success": n_ok, "k2_first_difference": diff_k2,
           "k34_first_difference": diff_k34, "launches": launches,
           "max_abs_err": max(max_abs_diff(st, est), max_abs_diff(sb, est)),
           **counter_totals(st)}
    check(diff_k2 is None, f"{name} ({out['mode']}, {out['dtype']}): K2 {diff_k2} != eager")
    check(diff_k34 is None, f"{name} ({out['mode']}, {out['dtype']}): budget {MODEL_BUDGET} "
                            f"{diff_k34} != eager")
    check(launches.get("solve") == 1 and launches.get("init") == 1 and launches.get("cont", 0) > 0,
          f"{name}: launches of its library {launches}")
    check(not others, f"{name}: launches of another library {others}")
    check(n_ok == st0.tn.shape[0] or not all_success,
          f"{name}: {st0.tn.shape[0] - n_ok} lanes not SUCCESS")
    return {**out, "st0": st0, "p_b": p_b, "st": st, "tret": tret}


# what solve_model returns beside its line's fields
SOLVE_PRIVATE = ("st0", "p_b", "st", "tret")


def leg(out: dict) -> dict:
    """solve_model's result without its tensors: the fields of a line."""
    return {k: v for k, v in out.items() if k not in SOLVE_PRIVATE}


def phase_fused_models(eager: dict) -> dict:
    """Generated models in the whole-solve kernel (module notes above
    AKZO_K): the table of ops; the headline (B = 65,536, tout 400, f64)
    through the generated Roberts, bit for bit the hand-written library and
    the eager path, each library's bare K2 launch in turns; Akzo at B =
    65,536 to tout 180 (K2, budget 32 and "refined", each bit for bit the
    eager solve on the card; a float32 leg at B = 4,096; the nominal lane
    within WRMS 1 of the eager port's rtol 1e-10 run on the CPU); Lorenz
    at B = 4,096 to t = 1. Registers and spills of each library."""
    models = generated_models()
    # the Akzo reference on the CPU, in a process of its own meanwhile
    reference_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    reference = reference_pool.submit(akzo_reference)
    table = phase_model_ops()
    rows, legs, ptxas = {}, {}, {}

    # the headline through the generated Roberts
    gen = models["roberts_generated"]
    tol = tol_sv(1e-4, ATOL, device="cuda")
    head = solve_model("roberts_generated", roberts_generated, gen, ensemble_inputs(B), tol, TOUT)
    est, _, _ = eager["result"]
    hand = fused_fn("cuda")(head["st0"], head["p_b"], TOUT)
    torch.cuda.synchronize()
    vs_eager = first_difference(head["st"], est, {}, {})
    vs_hand = first_difference(head["st"], hand[0], {}, {})
    bare = {"roberts": [], "roberts_generated": []}
    for _ in range(3):
        bare["roberts"].append(bare_launch_ms(head["st0"], head["p_b"]))
        bare["roberts_generated"].append(bare_launch_ms(head["st0"], head["p_b"], model=gen))
    per = model_ops_per(gen)
    k34 = budgeted_run(roberts_generated, gen, tol, head["st0"], head["p_b"], TOUT, per)
    rows["roberts_generated"] = model_rows(
        "roberts_generated", gen, head["st0"], head["launches"],
        statistics.median(bare["roberts_generated"]), head["eager_wall_s"] * 1e3,
        head["max_abs_err"], k34, counter_totals(head["st"]), per)
    ptxas["roberts_generated"] = model_ptxas(gen)
    add_ptxas(rows["roberts_generated"], ptxas["roberts_generated"])
    legs["roberts_generated"] = leg(head)
    emit("fused_models_roberts", **legs["roberts_generated"], equals_eager_headline=vs_eager,
         equals_hand_written=vs_hand, bare_launch_ms=bare, ptxas=ptxas["roberts_generated"],
         hand_written_ptxas=solve_kernel_ptxas(), ops_per=per)
    check(vs_eager is None, f"generated Roberts: {vs_eager} != the eager headline")
    check(vs_hand is None, f"generated Roberts: {vs_hand} != the hand-written library")
    check(head["nst"] == 6261351, f"generated Roberts headline: {head['nst']} steps")

    # Akzo Nobel
    akzo = models["akzo"]
    tol_a = tol_ss(AKZO_RTOL, AKZO_ATOL, device="cuda")
    a = solve_model("akzo", akzo_factory, akzo, akzo_inputs(B), tol_a, AKZO_TOUT)
    bare_a = [bare_launch_ms(a["st0"], a["p_b"], fused_solve.tol_inputs(
        tol_a, 6, B, torch.float64, torch.device("cuda")), model=akzo, tout=AKZO_TOUT)
        for _ in range(3)]
    per = model_ops_per(akzo)
    k34 = budgeted_run(akzo_factory, akzo, tol_a, a["st0"], a["p_b"], AKZO_TOUT, per)
    rows["akzo"] = model_rows("akzo", akzo, a["st0"], a["launches"], statistics.median(bare_a),
                              a["eager_wall_s"] * 1e3, a["max_abs_err"], k34,
                              counter_totals(a["st"]), per)
    refined = solve_model("akzo", akzo_factory, akzo, akzo_inputs(B), tol_a, AKZO_TOUT,
                          opts=IdaOptions(ls_precision="refined"))
    f32 = solve_model("akzo", akzo_factory, akzo, akzo_inputs(B_SMALL),
                      tol_ss(AKZO_RTOL, AKZO_ATOL, device="cuda", dtype=torch.float32),
                      AKZO_TOUT, dtype=torch.float32, all_success=False)
    # the nominal lane (the last) against the eager port's rtol 1e-10 run on the CPU
    ref_yy, ref_nst, ref_istate, ref_wall = reference.result()
    reference_pool.shutdown()
    nominal = wrms_card_vs_cpu(a["st"].yy[-1].cpu(), torch.from_numpy(ref_yy), AKZO_RTOL,
                               AKZO_ATOL)
    ptxas["akzo"] = model_ptxas(akzo)
    add_ptxas(rows["akzo"], ptxas["akzo"])
    ptxas["akzo_refined"] = model_ptxas(akzo, IdaOptions(ls_precision="refined"))
    legs["akzo"] = leg(a)
    emit("fused_models_akzo", **legs["akzo"], bare_launch_ms=bare_a, per_launch_k34=k34,
         refined=leg(refined),
         f32=leg(f32),
         nominal_wrms_vs_rtol_1e10=nominal, reference_nst=ref_nst,
         reference_istate=ref_istate, reference_wall_s=ref_wall,
         y_nominal=a["st"].yy[-1].tolist(), y_reference=ref_yy.tolist(),
         ptxas=ptxas["akzo"], ptxas_refined=ptxas["akzo_refined"], ops_per=per)
    check(ref_istate == C.SUCCESS, f"akzo: the rtol 1e-10 reference returned {ref_istate}")
    check(nominal < 1.0, f"akzo: the nominal lane is WRMS {nominal} from the rtol 1e-10 run")

    # Lorenz '63
    lor = models["lorenz"]
    tol_l = tol_ss(1e-4, 1e-6, device="cuda")
    lz = solve_model("lorenz", lorenz_factory, lor, lorenz_inputs(B_SMALL), tol_l, LORENZ_TOUT)
    tol_in = fused_solve.tol_inputs(tol_l, 3, B_SMALL, torch.float64, torch.device("cuda"))
    bare_l = [bare_launch_ms(lz["st0"], lz["p_b"], tol_in, model=lor, tout=LORENZ_TOUT)
              for _ in range(3)]
    per = model_ops_per(lor)
    k34 = budgeted_run(lorenz_factory, lor, tol_l, lz["st0"], lz["p_b"], LORENZ_TOUT, per)
    rows["lorenz"] = model_rows("lorenz", lor, lz["st0"], lz["launches"],
                                statistics.median(bare_l), lz["eager_wall_s"] * 1e3,
                                lz["max_abs_err"], k34, counter_totals(lz["st"]), per)
    ptxas["lorenz"] = model_ptxas(lor)
    add_ptxas(rows["lorenz"], ptxas["lorenz"])
    legs["lorenz"] = leg(lz)
    emit("fused_models_lorenz", **legs["lorenz"], bare_launch_ms=bare_l, ops_per=per,
         ptxas=ptxas["lorenz"])
    emit("fused_models", models={k: m.name for k, m in models.items()}, rows=rows,
         spills={k: v["spills"] for k, v in ptxas.items()},
         registers={k: {"f64": v["f64"].get("registers"), "f32": v["f32"].get("registers")}
                    for k, v in ptxas.items()})
    return {"rows": rows, "table": table}


# ------------------------------------------- fused_quad_ops: quadratures and the new ops
#
# K2-K4 with quadratures in the lane (ida_lane.cuh accumulate_quad) and the
# ops of the emitter's kinetics/neuron table (tanh ... log1p, maximum, minimum,
# clamp, where over comparisons and logic). Morris-Lecar (models/morris_lecar.py,
# the Rinzel-Ermentrout Hopf set) needs both: tanh and cosh in its residual,
# its calcium charge and mean voltage as quadratures. Its eager solve on the
# card costs ~40 ms an attempt ("refined" ~115), host bound, so the horizon
# is 10 ms, not the 200 ms of two spikes (20.8 s and 60.4 s for the two eager
# solves there on an H100): the lanes above I ~ 150 make their
# first spike, the nominal one (I = 100, period ~85 ms) is rising to it, up to
# ~140 steps a lane. On that upstroke the solve's global error at rtol 1e-6
# is WRMS 4.9 (y) and 4.5 (get_quad) from the rtol 1e-10 run on the CPU, and
# ida_tpu's own rtol 1e-6 solve is as far from its rtol 1e-10 one
# (tests/test_torch_fused_quad.py): the nominal lane is held within WRMS 1 of
# the reference at ML_CHECK_SCALE times the run's tolerances.
ML_TOUT = 10.0
ML_RTOL, ML_ATOL, ML_REF_TOL = 1e-6, 1e-8, 1e-10
ML_CHECK_SCALE = 10.0


def ml_reference() -> tuple:
    """The nominal Morris-Lecar lane through the eager port on the CPU at
    rtol = atol = 1e-10 (no step limit) to ML_TOUT: (yy, get_quad at tret,
    nst, istate, wall s). Run in a process of its own while the card works."""
    torch.set_num_threads(1)
    params, yy0, yp0 = morris_lecar_inputs(1)
    t0 = time.perf_counter()
    opts = IdaOptions(mxstep=1_000_000)
    st, tret, ist = make_ensemble_solve(morris_lecar_factory, opts)(
        ensemble_init(morris_lecar_factory, params, yy0, yp0, device="cpu", opts=opts), params,
        tol_ss(ML_REF_TOL, ML_REF_TOL, device="cpu"), ML_TOUT)
    q = get_quad(to_native(st), morris_lecar_factory(torch.from_numpy(params.T)), tret)
    return (st.yy[0].numpy(), q[:, 0].numpy(), int(st.nst[0]), int(ist[0]),
            time.perf_counter() - t0)


def quad_of(st, factory, p_b, tret) -> torch.Tensor:
    """core/quad.py get_quad of a batch-leading result at ``tret``: [B, nq]."""
    return get_quad(to_native(st), factory(p_b.t().contiguous()), tret).t()


def phase_fused_quad_ops(eager: dict, quad_head: dict, table: dict) -> dict:
    """K2-K4 with quadratures and the new ops: (a) the quadrature headline
    (quad_factory, B = 65,536, tout 400, f64) through K2 and budget 32,
    every field and yQ bit for bit quadrature_headline's eager result, and
    get_quad on the K2 result IDA.get_quad's on one lane; "refined" and
    float32 at B = 4,096 against their eager modes; bare K2 of the
    hand-written, the generated and the quadrature Roberts in turns (what
    yQ adds), the hand-written library still 234 registers without spills;
    (b) Morris-Lecar at B = 65,536, I = linspace(0, 300) (the last lane
    nominal), rtol 1e-6, atol 1e-8, to ML_TOUT: K2, budget 32 and
    "refined" bit for bit the eager solve, every lane SUCCESS, the nominal
    lane's y and get_quad within WRMS 1 of the eager rtol 1e-10 run on the
    CPU at ML_CHECK_SCALE times the run's tolerances; (c) the table of ops
    (phase_model_ops) holds the new zoo, Morris-Lecar and the quadrature
    Roberts, special lanes included. Registers and spills of each library."""
    models = generated_models()
    reference_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    reference = reference_pool.submit(ml_reference)
    rows, legs, ptxas = {}, {}, {}

    # (a) the quadrature headline through K2-K4
    rq = models["roberts_quad"]
    tol = tol_sv(1e-4, ATOL, device="cuda")
    head = solve_model("roberts_quad", quad_factory, rq, ensemble_inputs(B), tol, TOUT,
                       eager=(quad_head["result"], quad_head["wall_s"]))
    lane = quad_head["lane"]
    q_k2 = quad_of(head["st"], quad_factory, head["p_b"], head["tret"])[lane].cpu().numpy()
    q_lane_same = bool(np.array_equal(q_k2, quad_head["ida_get_quad"]))
    bare = {"roberts": [], "roberts_generated": [], "roberts_quad": []}
    for _ in range(3):
        bare["roberts"].append(bare_launch_ms(head["st0"], head["p_b"]))
        bare["roberts_generated"].append(bare_launch_ms(head["st0"], head["p_b"],
                                                        model=models["roberts_generated"]))
        bare["roberts_quad"].append(bare_launch_ms(head["st0"], head["p_b"], model=rq))
    per = model_ops_per(rq)
    k34 = budgeted_run(quad_factory, rq, tol, head["st0"], head["p_b"], TOUT, per)
    rows["roberts_quad"] = model_rows(
        "roberts_quad", rq, head["st0"], head["launches"], statistics.median(bare["roberts_quad"]),
        head["eager_wall_s"] * 1e3, head["max_abs_err"], k34, counter_totals(head["st"]), per)
    refined = solve_model("roberts_quad", quad_factory, rq, ensemble_inputs(B_SMALL), tol, TOUT,
                          opts=IdaOptions(ls_precision="refined"))
    f32 = solve_model("roberts_quad", quad_factory, rq, ensemble_inputs(B_SMALL),
                      tol_sv(1e-4, ATOL, device="cuda", dtype=torch.float32), TOUT,
                      dtype=torch.float32, all_success=False)
    hand = solve_kernel_ptxas()
    ptxas["roberts_quad"] = model_ptxas(rq)
    ptxas["roberts_quad_refined"] = model_ptxas(rq, IdaOptions(ls_precision="refined"))
    add_ptxas(rows["roberts_quad"], ptxas["roberts_quad"])
    legs["roberts_quad"] = leg(head)
    emit("fused_quad_headline", **legs["roberts_quad"], get_quad_lane=lane,
         get_quad_k2=q_k2.tolist(), get_quad_equals_ida=q_lane_same, bare_launch_ms=bare,
         per_launch_k34=k34, refined=leg(refined), f32=leg(f32), ptxas=ptxas["roberts_quad"],
         ptxas_refined=ptxas["roberts_quad_refined"], hand_written_ptxas=hand, ops_per=per)
    check(q_lane_same, f"fused_quad_headline: get_quad of K2's lane {q_k2} != IDA.get_quad "
                       f"{quad_head['ida_get_quad']}")
    check(head["nst"] == 6261351, f"fused_quad_headline: {head['nst']} steps")
    check(hand.get("registers") == 234 and not hand.get("spill_stores", 0)
          and not hand.get("spill_loads", 0), f"the hand-written Roberts library: {hand}")

    # (b) Morris-Lecar
    ml = models["morris_lecar"]
    tol_m = tol_ss(ML_RTOL, ML_ATOL, device="cuda")
    m = solve_model("morris_lecar", morris_lecar_factory, ml, morris_lecar_inputs(B), tol_m,
                    ML_TOUT)
    tol_in = fused_solve.tol_inputs(tol_m, 2, B, torch.float64, torch.device("cuda"))
    bare_m = [bare_launch_ms(m["st0"], m["p_b"], tol_in, model=ml, tout=ML_TOUT)
              for _ in range(3)]
    per_m = model_ops_per(ml)
    k34_m = budgeted_run(morris_lecar_factory, ml, tol_m, m["st0"], m["p_b"], ML_TOUT, per_m)
    rows["morris_lecar"] = model_rows(
        "morris_lecar", ml, m["st0"], m["launches"], statistics.median(bare_m),
        m["eager_wall_s"] * 1e3, m["max_abs_err"], k34_m, counter_totals(m["st"]), per_m)
    refined_m = solve_model("morris_lecar", morris_lecar_factory, ml, morris_lecar_inputs(B),
                            tol_m, ML_TOUT, opts=IdaOptions(ls_precision="refined"))
    q_all = quad_of(m["st"], morris_lecar_factory, m["p_b"], m["tret"])
    ref_yy, ref_q, ref_nst, ref_istate, ref_wall = reference.result()
    reference_pool.shutdown()
    scale = (ML_CHECK_SCALE * ML_RTOL, ML_CHECK_SCALE * ML_ATOL)
    wrms_y = wrms_card_vs_cpu(m["st"].yy[-1].cpu(), torch.from_numpy(ref_yy), *scale)
    wrms_q = wrms_card_vs_cpu(q_all[-1].cpu(), torch.from_numpy(ref_q), *scale)
    wrms_y_run = wrms_card_vs_cpu(m["st"].yy[-1].cpu(), torch.from_numpy(ref_yy), ML_RTOL,
                                  ML_ATOL)
    nst = m["st"].nst
    ptxas["morris_lecar"] = model_ptxas(ml)
    ptxas["morris_lecar_refined"] = model_ptxas(ml, IdaOptions(ls_precision="refined"))
    add_ptxas(rows["morris_lecar"], ptxas["morris_lecar"])
    legs["morris_lecar"] = leg(m)
    emit("fused_morris_lecar", **legs["morris_lecar"], bare_launch_ms=bare_m,
         per_launch_k34=k34_m, refined=leg(refined_m),
         steps_a_lane={"min": int(nst.min()), "median": float(nst.double().median()),
                       "max": int(nst.max())},
         nominal_wrms_at_scale=wrms_y, nominal_quad_wrms_at_scale=wrms_q,
         nominal_wrms_at_run_tol=wrms_y_run, check_scale=ML_CHECK_SCALE,
         y_nominal=m["st"].yy[-1].tolist(), y_reference=ref_yy.tolist(),
         quad_nominal=q_all[-1].tolist(), quad_reference=ref_q.tolist(), reference_nst=ref_nst,
         reference_istate=ref_istate, reference_wall_s=ref_wall, ptxas=ptxas["morris_lecar"],
         ptxas_refined=ptxas["morris_lecar_refined"], ops_per=per_m)
    check(ref_istate == C.SUCCESS, f"morris_lecar: the rtol 1e-10 reference returned {ref_istate}")
    check(wrms_y < 1.0 and wrms_q < 1.0,
          f"morris_lecar: the nominal lane is WRMS {wrms_y} (y), {wrms_q} (get_quad) from the "
          f"rtol 1e-10 run at {ML_CHECK_SCALE}x the run's tolerances")

    # (c) the table of ops holds the new models
    new = [f"{m}/{dt}" for m in ("ops_zoo", "morris_lecar", "roberts_quad")
           for dt in ("float64", "float32")]
    check(all(k in table for k in new), f"the table of ops lacks {set(new) - set(table)}")
    emit("fused_quad_ops", models={k: models[k].name for k in ("roberts_quad", "morris_lecar",
                                                               "ops_zoo")},
         table={k: table[k] for k in new}, rows=rows,
         registers={k: {"f64": v["f64"].get("registers"), "f32": v["f32"].get("registers")}
                    for k, v in ptxas.items()},
         spills={k: v["spills"] for k, v in ptxas.items()})
    return {"rows": rows}


# ------------------------------------------------- band and Krylov in K2-K4


def _band(mu: int, ml: int, **kw) -> IdaOptions:
    return IdaOptions(linear_solver="band", band_mu=mu, band_ml=ml, **kw)


def _spgmr(**kw) -> IdaOptions:
    return IdaOptions(linear_solver="spgmr", **kw)


# the headline's legs (B = 65,536, f64, the headline's lanes and tolerances):
# the exact band (mu = ml = 2: Roberts' whole 3 x 3 Jacobian in band
# storage), an inexact one (mu = ml = 1: another step sequence) and SPGMR
# with its defaults (maxl 5, 5 restarts, MGS), by fused_solve.mode_name
LINEAR_HEADLINE = {"band2_2": _band(2, 2), "band1_1": _band(1, 1), "spgmr5": _spgmr()}
# the modes' legs at B_SMALL, Roberts
LINEAR_MODES = {"single_band1_1": _band(1, 1, ls_precision="single"),
                "single_spgmr5": _spgmr(ls_precision="single"),
                "spgmr5_bf16": _spgmr(krylov_storage="bfloat16"),
                "spgmr5_cgs2": _spgmr(krylov_gs="classical"),
                "fast_math_band2_2": _band(2, 2, fast_math=True),
                "fast_math_spgmr5": _spgmr(fast_math=True)}
# float32 states through the headline's libraries (their f32 entry points),
# and Morris-Lecar (quadratures, tanh and cosh) to ML_TOUT, at B_SMALL
LINEAR_F32 = ("band2_2", "spgmr5")
LINEAR_ML = ("band1_1", "spgmr5")
# the headline legs' horizons, TOUT but where PERF.md section 4 lists a cut:
# under band mu = ml = 1 (an inexact Newton matrix, 5-7x the steps) a lane
# meets mxstep = 500 before tout 4, so its legs stop at 0.4 (250-470 steps a
# lane); the legs at B_SMALL stop at LINEAR_MODES_TOUT (Morris-Lecar at
# ML_TOUT), to keep the phase's eager solves short: the second decade, where
# every lane takes more than MODEL_BUDGET attempts, so K4 runs (the first
# takes ~30), but where band mu = ml = 1 stops at 0.4 as above
LINEAR_TOUT = {"band2_2": TOUT, "band1_1": 0.4, "spgmr5": TOUT, "single_band1_1": 0.4}
LINEAR_MODES_TOUT = 4.0
LINEAR_COUNTERS = COUNTERS + ("nsetups", "nli", "nps", "ncfl", "njtimes")
# floating-point operations of the band and Krylov solvers beside OPS_PER
# (model_ops_per for a generated model), counted by hand from
# csrc/band_lu.cuh and csrc/ida_lane.cuh at N components (a division as one
# operation, sqrt as 20): a jvp of the residual (Roberts' M::res_jvp 17, a
# generated one's statements) and w = cj v N; the band lsetup's point (yy +
# 0, yp + cj * 0) 3 N; a GMRES basis column (v / s2 and s1 A v 2 N, the
# first Gram-Schmidt pass 4 N, the norm 2 N + 20, the column's scaling N,
# the new rotation 27, g 2), a cycle (s1 r N, its norm 2 N + 20, the first
# column N, the true residual 4 N + 20, the tolerance 22 a solve counted
# here) and a column's back substitution and correction (1 + 3 N); the
# passes against the earlier columns (j of them at column j) and the
# earlier rotations are data-dependent and left out, so the bound is low
def ops_krylov(n: int) -> dict:
    return {"column": 9 * n + 49, "cycle": 8 * n + 62, "correction": 1 + 3 * n}


def band_factor_ops(n: int, mu: int, ml: int) -> int:
    """csrc/band_lu.cuh band_factor_dev: each column's swap corrections
    (4 a window column), multipliers and rank-1 update."""
    smu, ops = mu + ml, 0
    for k in range(n):
        cols = min(smu + 1, n - k)
        ops += 4 * cols + ml + 2 * ml * (cols - 1)
    return ops


def band_solve_ops(n: int, mu: int, ml: int) -> int:
    """csrc/band_lu.cuh band_solve_dev: the swap corrections and the
    forward updates, then each row's products, their sum, the difference
    and the division."""
    fwd = sum(4 + 2 * min(ml, n - 1 - k) for k in range(n))
    back = 0
    for k in range(n):
        real = min(mu + ml, n - 1 - k)
        back += real + max(real - 1, 0) + 2
    return fwd + back


def linear_totals(st) -> dict:
    return {f: int(getattr(st, f).sum()) for f in LINEAR_COUNTERS}


def linear_ops(totals: dict, opts: IdaOptions, dtype: torch.dtype,
               model: fused_model.FusedModel = fused_solve.ROBERTS) -> dict:
    """:func:`solve_ops` of a solve of ``model`` under ``opts``' band or
    Krylov solver, by the type each part runs in (the factor and its
    solves, or the whole Krylov iteration, float32 under "single"; the jvps
    in the state's dtype, whose float64 parameters promote them): the dense
    LU's solve and the lsetup's Jacobian and factor taken out, the band
    Jacobian's colored jvps, the band factor and solve, or the Arnoldi work
    of the Krylov counters put in (ops_krylov)."""
    per = OPS_PER if model.header is None else model_ops_per(model)
    n = model.n
    jvp = (17 if model.header is None else per["jvp"]) + n
    base = (solve_ops(totals, per) - totals["nni"] * (n * n + 2 * n)
            - totals["nje"] * per["lsetup"])
    if opts.linear_solver == "band":
        colors = min(opts.band_mu + opts.band_ml + 1, n)
        lin = (totals["nje"] * band_factor_ops(n, opts.band_mu, opts.band_ml)
               + totals["nni"] * band_solve_ops(n, opts.band_mu, opts.band_ml))
        base += totals["nje"] * (colors * jvp + 3 * n)
    else:
        cycles = (totals["njtimes"] - totals["nli"]) // 2
        base += totals["njtimes"] * jvp
        kry = ops_krylov(n)
        lin = totals["nli"] * (kry["column"] + kry["correction"]) + cycles * kry["cycle"]
    narrow = torch.float32 if opts.ls_precision == "single" else dtype
    out = {dtype: base}
    out[narrow] = out.get(narrow, 0) + lin
    return out


def linear_library(opts: IdaOptions, model: fused_model.FusedModel = fused_solve.ROBERTS):
    """``build``'s arguments for ``opts``' library of ``model``."""
    return (opts.fast_math, opts.ls_precision, model, fused_solve.linear_of(opts))


def linear_builds(pool) -> dict:
    """Submit every library of the fused_linear phase to ``pool``."""
    ml = generated_models()["morris_lecar"]
    jobs = {m: linear_library(o) for m, o in {**LINEAR_HEADLINE, **LINEAR_MODES}.items()}
    jobs.update({f"morris_lecar/{m}": linear_library(LINEAR_HEADLINE[m], ml) for m in LINEAR_ML})
    return {k: pool.submit(fused_solve.build, *args) for k, args in jobs.items()}


def linear_rows(name: str, opts: IdaOptions, model, out: dict, k2_ms: list, k34: dict,
                ptxas: dict) -> dict:
    """The kernels line's K2, K3 and K4 rows of one band or Krylov library:
    the launches of its main-path run, bare-launch ms, the plain versions'
    ms, bounds by linear_ops, registers and spills, the -D flags."""
    totals = linear_totals(out["st"])
    ops = linear_ops(totals, opts, out["st0"].dtype, model)
    bound, by = solve_bound(out["st0"], ops, opts, model)
    total = sum(ops.values())
    init, cont = k34["runs"][0], k34["runs"][1:]

    def share(frac):
        return {dt: v * frac for dt, v in ops.items()}

    b_init, by_init = solve_bound(out["st0"], share(init["ops"] / total), opts, model)
    b_cont, by_cont = solve_bound(
        out["st0"], share(statistics.mean(r["ops"] for r in cont) / total), opts, model)
    src = {"route": "cuda", "source": FUSED_SOURCE, "model": model.name, "library_ms": None,
           "flags": list(fused_solve.mode_flags(*linear_library(opts)[:2],
                                                fused_solve.linear_of(opts))),
           "registers": ptxas.get("registers"), "spill_stores": ptxas.get("spill_stores", 0),
           "spill_loads": ptxas.get("spill_loads", 0)}
    launches, err = out["launches"], out["max_abs_err"]
    return {
        "solve": {"name": f"fused_solve_{name}", "replaces": REPLACES["fused_solve"], **src,
                  "launches": launches.get("solve", 0), "max_abs_err": err,
                  "ms": statistics.median(k2_ms), "plain_ms": out["eager_wall_s"] * 1e3,
                  "bound_ms": bound, "bound_by": by},
        "init": {"name": f"fused_solve_init_{name}", "replaces": REPLACES["fused_solve_init"],
                 **src, "launches": launches.get("init", 0), "max_abs_err": err,
                 "ms": init["ms"], "plain_ms": k34["plain_ms"][0], "bound_ms": b_init,
                 "bound_by": by_init},
        "cont": {"name": f"fused_solve_cont_{name}", "replaces": REPLACES["fused_solve_cont"],
                 **src, "launches": launches.get("cont", 0), "max_abs_err": err,
                 "ms": statistics.mean(r["ms"] for r in cont), "plain_ms": k34["plain_ms"][1],
                 "bound_ms": b_cont, "bound_by": by_cont},
    }


def linear_leg(name: str, opts: IdaOptions, factory, model, inputs, tol, tout,
               dtype=torch.float64, all_success: bool = True) -> dict:
    """One leg of fused_linear: solve_model (eager, then K2 and budget 32
    through make_fused_solve, each bit for bit the eager solve), then three
    bare K2 launches and the budgeted launches one by one (budgeted_run),
    with the library's ptxas line; returns the line's fields and the rows."""
    out = solve_model(name, factory, model, inputs, tol, tout, dtype, opts, all_success)
    modes = {m for _, m, _ in fused_solve.MODE_LAUNCHES}
    check(modes == {fused_solve.mode_name(opts)},
          f"fused_linear {name}: the main path launched the libraries {modes}")
    tol_in = fused_solve.tol_inputs(tol, model.n, out["st0"].tn.shape[0], dtype,
                                    torch.device("cuda"))
    k2_ms = [bare_launch_ms(out["st0"], out["p_b"], tol_in, opts, model, tout)
             for _ in range(3)]
    k34 = budgeted_run(factory, model, tol, out["st0"], out["p_b"], tout, OPS_PER, opts,
                       ops_of=lambda st: sum(linear_ops(linear_totals(st), opts, dtype,
                                                        model).values()))
    forms = solve_kernels_ptxas(opts, model)
    ptxas = forms["f64_shared_tol" if dtype == torch.float64 else "f32_shared_tol"]
    rows = linear_rows(name, opts, model, out, k2_ms, k34, ptxas)
    line = {**leg(out), **{k: v for k, v in linear_totals(out["st"]).items()},
            "bare_launch_ms": k2_ms, "k3_ms": k34["runs"][0]["ms"],
            "k4_ms": [r["ms"] for r in k34["runs"][1:]], "plain_k3_k4_ms": k34["plain_ms"],
            "bound_ms": rows["solve"]["bound_ms"], "bound_by": rows["solve"]["bound_by"],
            "flags": rows["solve"]["flags"], "ptxas": ptxas,
            "ptxas_all_forms": forms}
    return {"line": line, "rows": rows, "out": out}


# the legs whose canonical lane reaches 4e10: the exact band takes the dense
# solve's steps there; under band (1, 1) a decade meets mxstep from 40 on,
# and unpreconditioned SPGMR loses the lane from 4e6 on, in the eager solve
# and in ida_tpu's alike (PERF.md section 6)
LINEAR_CANONICAL_GATED = ("band2_2",)


def linear_canonical(name: str, opts: IdaOptions) -> dict:
    """The canonical lane (nominal rates) through ``opts``' K2, decade by
    decade to 4e10: its per-decade istate and steps, check_ans; for a leg of
    LINEAR_CANONICAL_GATED every decade SUCCESS, the dense canonical steps
    and check_ans WRMS < 1."""
    params = ROBERTS_PARAMS[None, :]
    st = ensemble_init(roberts_factory, params, ROBERTS_YY0[None], ROBERTS_YP0[None],
                       device="cuda", opts=opts)
    fn = fused_solve.make_fused_solve(roberts_factory, tol_sv(1e-4, ATOL, device="cuda"), opts)
    nst, codes = [], []
    for k in range(12):
        st, tret, istate = fn(st, params, 0.4 * 10**k)
        nst.append(int(st.nst[0]))
        codes.append(int(istate[0]))
    err = check_ans_wrms(st.yy[0].cpu().numpy())
    if name in LINEAR_CANONICAL_GATED:
        check(codes == [C.SUCCESS] * 12, f"fused_linear {name} canonical lane: istates {codes}")
        check(nst == CANONICAL_NST, f"fused_linear {name} canonical lane: nst {nst}")
        check(err < 1.0, f"fused_linear {name} canonical lane: check_ans WRMS {err}")
    return {"nst_per_decade": nst, "istate_per_decade": codes, "check_ans_wrms": err,
            "gated": name in LINEAR_CANONICAL_GATED,
            **{f: int(getattr(st, f)[0]) for f in LINEAR_COUNTERS}}


def phase_fused_linear() -> dict:
    """K2-K4 with the band and Krylov solvers (ida_lane.cuh SOLVER_BAND,
    SOLVER_SPGMR; one library a solver, mode and model): (a) the headline
    (B = 65,536, f64, LINEAR_TOUT) under band mu = ml = 2, band mu = ml = 1
    and spgmr, each K2 and budget 32 (K3 + K4) bit for bit the eager solve
    under the same options (same_bits on every field and counter, the Krylov
    counters among them), every lane SUCCESS, and the canonical lane through
    K2 to 4e10 within check_ans; (b) at B = 4,096 to LINEAR_MODES_TOUT (band
    mu = ml = 1 to 0.4): band "single",
    spgmr "single", a bfloat16 basis, CGS2, fast_math under each solver, a
    float32 state under each, and Morris-Lecar under band mu = ml = 1 and
    spgmr to ML_TOUT, each K2 and budget 32 bit for bit its eager solve.
    Each library's registers and spills, bare K2 launch, K3/K4 launches and
    bound (linear_ops); the kernels line's rows (linear_rows)."""
    models = generated_models()
    tol = tol_sv(1e-4, ATOL, device="cuda")
    rows, lines = {}, {}
    for name, opts in LINEAR_HEADLINE.items():
        got = linear_leg(name, opts, roberts_factory, fused_solve.ROBERTS, ensemble_inputs(B),
                         tol, LINEAR_TOUT.get(name, TOUT))
        rows[name], lines[name] = got["rows"], got["line"]
        lines[name]["canonical"] = linear_canonical(name, opts)
        emit("fused_linear", leg=name, **lines[name])
    for name, opts in LINEAR_MODES.items():
        got = linear_leg(name, opts, roberts_factory, fused_solve.ROBERTS,
                         ensemble_inputs(B_SMALL), tol, LINEAR_TOUT.get(name, LINEAR_MODES_TOUT))
        rows[name], lines[name] = got["rows"], got["line"]
        emit("fused_linear", leg=name, **lines[name])
    tol32 = tol_sv(1e-4, ATOL, device="cuda", dtype=torch.float32)
    for name in LINEAR_F32:
        got = linear_leg(name, LINEAR_HEADLINE[name], roberts_factory, fused_solve.ROBERTS,
                         ensemble_inputs(B_SMALL), tol32, LINEAR_MODES_TOUT,
                         torch.float32, all_success=False)
        lines[f"{name}_f32"] = got["line"]
        rows[name]["solve"]["launches_f32"] = got["rows"]["solve"]["launches"]
        rows[name]["solve"]["ms_f32"] = got["rows"]["solve"]["ms"]
        emit("fused_linear", leg=f"{name}_f32", **got["line"])
    ml = models["morris_lecar"]
    tol_m = tol_ss(ML_RTOL, ML_ATOL, device="cuda")
    for name in LINEAR_ML:
        got = linear_leg(f"morris_lecar_{name}", LINEAR_HEADLINE[name], morris_lecar_factory,
                         ml, morris_lecar_inputs(B_SMALL), tol_m, ML_TOUT)
        rows[f"morris_lecar_{name}"] = got["rows"]
        lines[f"morris_lecar_{name}"] = got["line"]
        emit("fused_linear", leg=f"morris_lecar_{name}", **got["line"])
    # none of these libraries launched another's kernels, and every one of
    # them ran its K2, K3 and K4 on the main path (solve_model checks each)
    emit("fused_linear_summary", legs=sorted(lines),
         registers={k: v["ptxas"].get("registers") for k, v in lines.items()},
         spill_stores={k: v["ptxas"].get("spill_stores", 0) for k, v in lines.items()},
         eager_wall_s={k: v["eager_wall_s"] for k, v in lines.items()},
         bare_launch_ms={k: statistics.median(v["bare_launch_ms"]) for k, v in lines.items()})
    return {"rows": rows}


def timed(phase, *args):
    """Run a phase and print how long it took."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit("phase_seconds", name=phase.__name__, seconds=time.perf_counter() - t0)
    return out


def main() -> None:
    smi = phase_device()
    timed(phase_build)
    lu = timed(phase_kernels)
    lu_t = timed(phase_kernels_t)
    # K1 at the later paths' shapes, while the profiler is fresh: late in
    # the run its windows of a few launches came back empty
    k1_modes = timed(phase_kernels_modes)
    eager = timed(phase_slice)
    timed(phase_card_vs_cpu)
    timed(phase_canonical)
    stages = timed(phase_fused_stages)
    fused = timed(phase_fused_slice, eager)
    budgeted = timed(phase_fused_budgeted)
    timed(phase_fused_f32)
    timed(phase_fused_canonical)
    rooted = timed(phase_roots_slice, eager)
    dense = timed(phase_dense_slice)
    timed(phase_dense_events)
    timed(phase_user_surface)
    start_prec_events()
    timed(phase_heat2d_spgmr)
    timed(phase_heat2d_batched)
    food = timed(phase_foodweb)
    food_b = timed(phase_foodweb_batched)
    n2 = timed(phase_kernels_n2, food_b)
    c_stages = timed(phase_constrained_stages)
    c_head = timed(phase_constrained_headline)
    quad = timed(phase_quadrature_headline, eager)
    resume = timed(phase_checkpoint_resume)
    adj = timed(phase_adjoint_batched)
    adj_c = timed(phase_adjoint_continuous, adj)
    sens = timed(phase_sensitivity_lane)
    timed(phase_band_heat2d)
    timed(phase_band_factor_100)
    timed(phase_bbd_heat2d)
    mixed = timed(phase_mixed_headline, eager, k1_modes)
    fast = timed(phase_fast_f64, eager)
    timed(phase_heat2d_mixed)
    food_m = timed(phase_foodweb_mixed)
    slider = timed(phase_slider_crank)
    timed(phase_stratified)
    timed(phase_profile_scopes, eager)
    modes = timed(phase_fused_modes, mixed, fast)
    models = timed(phase_fused_models, eager)
    quad_ops = timed(phase_fused_quad_ops, eager, quad, models["table"])
    linear = timed(phase_fused_linear)
    mesh = timed(phase_mesh, eager, food)

    # "launches" is the count of the eager headline (phase slice) for the LU
    # kernels and of the fused headline for the solve kernel; the counts of
    # the other paths stand beside them (the band and BBD paths run none of
    # these kernels)
    rows = [
        {"name": f"small_lu_{k}", "route": "cuda", "source": LU_SOURCE, "replaces": LU_REPLACES,
         "launches": eager["launches"][k], "launches_roots_slice": rooted["launches"][k],
         "launches_dense_slice": dense["launches"][k],
         "launches_constrained_headline": c_head["lu_launches"][k],
         "launches_quadrature_headline": quad["lu_launches"][k],
         "launches_checkpoint_resume": resume["lu_launches"][k],
         "launches_adjoint_batched": adj["launches"][k],
         "launches_adjoint_continuous": adj_c["launches"][k],
         "launches_fast_f64": fast["launches"][k],
         "launches_mesh_one_rank": mesh["one"]["launches"][k],
         "launches_mesh_gloo_ranks": [r["launches"][k] for r in mesh["gloo"]],
         "max_abs_err": lu[k]["max_abs_err"], "ms": lu[k]["ms"],
         "plain_ms": lu[k]["plain_ms"], "bound_ms": lu[k]["bound_ms"], "bound_by": "bytes",
         "library_ms": lu[k]["library_ms"]}
        for k in ("factor", "solve")
    ]
    # the transposed solve: the backward of every K1 solve under autograd;
    # its launches are those of adjoint_batched's backward (sensitivity_lane's
    # few-lane ones beside them). No TPU kernel
    # has a backward: ida_tpu's gradient differentiates the jnp arithmetic
    # of lu_solve_unrolled, which is what "replaces" names
    rows.append({"name": "small_lu_solve_t", "route": "cuda", "source": T_SOURCE,
                 "replaces": "ida_tpu/ops/dense_lu.py:146", "launches": adj["launches"]["solve_t"],
                 "launches_sensitivity_lane": sens["launches"].get("solve_t_f64_n3", 0), **lu_t})
    # K1 at N = 2 on the foodweb preconditioner's blocks: the launches of
    # the single foodweb run, with those of the batched one beside them
    # and each rank's on the sharded food web (two gloo ranks; one rank a
    # card under NCCL where there are several)
    mesh_food = mesh["foodweb"]

    def per_rank(leg, case, key):
        return [x[key] for x in mesh_food.get(leg, {}).get(case, [])]

    rows += [
        {"name": f"small_lu_{k}_n2_foodweb", "route": "cuda", "source": LU_SOURCE,
         "replaces": LU_REPLACES, "launches": food["launches"][k],
         "launches_foodweb_batched": food_b["launches"][k],
         "launches_mesh_foodweb_one_rank": mesh_food["one_rank"]["foodweb_sharded"][k],
         **{f"launches_mesh_{case}": per_rank("gloo", case, k)
            for case in MESH_FOOD_CASES if k == "factor" or "single" not in case},
         "launches_mesh_foodweb_sharded_nccl": per_rank("nccl", "foodweb_sharded", k),
         **n2[k]}
        for k in ("factor", "solve")
    ]
    # K1 at the later paths' shapes: float32 N = 3 (the mixed_headline's
    # "single" run, its "refined" run beside it), the float32 N = 2 solve of
    # foodweb_mixed, float64 N = 10 on slider-crank's one lane and N = 6 on
    # adjoint_continuous's 1,024 lanes (each with its skeleton, the parent
    # dispatch's time in the same turns and its floor)
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    few = ("skeleton", "parent_ms", "floor_copy_ms", "floor_empty_ms")
    for k in ("factor", "solve"):
        rows.append({"name": f"small_lu_{k}_f32_n3", "route": "cuda", "source": LU_SOURCE,
                     "replaces": LU_REPLACES,
                     "launches": mixed["single"]["launches"].get(f"{k}_f32_n3", 0),
                     "launches_refined": mixed["refined"]["launches"].get(f"{k}_f32_n3", 0),
                     **{x: k1_modes["f32_n3"][k][x] for x in keep}})
    rows.append({"name": "small_lu_solve_f32_n2_foodweb", "route": "cuda", "source": LU_SOURCE,
                 "replaces": LU_REPLACES, "launches": food_m["launches"].get("solve_f32_n2", 0),
                 "launches_mesh_foodweb_sharded_single":
                     per_rank("gloo", "foodweb_sharded_single", "solve_f32"),
                 **{x: k1_modes["f32_n2"][x] for x in keep}})
    for k in ("factor", "solve"):
        rows.append({"name": f"small_lu_{k}_n10_slider_crank", "route": "cuda",
                     "source": LU_SOURCE, "replaces": LU_REPLACES,
                     "launches": slider["launches"].get(f"{k}_f64_n10", 0),
                     "launches_group": slider["group_launches"].get(f"{k}_f64_n10", 0),
                     **{x: k1_modes["f64_n10"][k][x] for x in keep + few}})
    for k in ("factor", "solve"):
        rows.append({"name": f"small_lu_{k}_n6_adjoint_continuous", "route": "cuda",
                     "source": LU_SOURCE, "replaces": LU_REPLACES,
                     "launches": adj_c["launches"][f"{k}_n6"],
                     "launches_group": adj_c["launches"][f"{k}_n6_groups"],
                     **{x: k1_modes["f64_n6"][k][x] for x in keep + few}})
    rows.append({"name": "fused_solve", "route": "cuda", "source": FUSED_SOURCE,
                 "replaces": REPLACES["fused_solve"], "launches": fused["launches"],
                 "launches_dense_slice_scan_form": dense["scan_form_launches"],
                 "launches_constrained_headline": c_head["launches"]["k2"],
                 "launches_mesh_one_rank": mesh["one"]["launches"]["fused_solve"],
                 "launches_mesh_gloo_ranks": [r["launches"]["fused_solve"] for r in mesh["gloo"]],
                 "constrained_to_400_ms": c_head["k2_ms"],
                 "max_abs_err": fused["max_abs_err"], "ms": fused["ms"], "plain_ms": fused["plain_ms"],
                 "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"], "library_ms": None})
    for kind in ("init", "cont"):
        rows.append({"name": f"fused_solve_{kind}", "route": "cuda", "source": FUSED_SOURCE,
                     "replaces": REPLACES[f"fused_solve_{kind}"], **budgeted[kind],
                     "launches_constrained_headline": c_head["launches"][kind],
                     "library_ms": None})
    # the whole-solve kernel in each non-parity mode (fused_modes)
    for mode, kinds in modes.items():
        for kind, row in kinds.items():
            base = "fused_solve" if kind == "solve" else f"fused_solve_{kind}"
            rows.append({"name": f"{base}_{mode}", "route": "cuda", "source": FUSED_SOURCE,
                         "replaces": REPLACES[base], **row, "library_ms": None})
    # the whole-solve kernel with each generated model (fused_models)
    for name, kinds in {**models["rows"], **quad_ops["rows"]}.items():
        rows += [kinds["solve"], kinds["init"], kinds["cont"]]
    # the whole-solve kernel with the band and Krylov solvers (fused_linear),
    # a library a solver, mode and model; its -D flags on each row
    for name, kinds in linear["rows"].items():
        rows += [kinds["solve"], kinds["init"], kinds["cont"]]
    for stage, t in stages["times"].items():
        rows.append({"name": f"fused_stage_{stage}", "route": "cuda", "source": FUSED_SOURCE,
                     "replaces": REPLACES["stage"], "launches": stages["launches"][stage],
                     "launches_constrained_stages": c_stages["launches"].get(stage, 0),
                     "max_abs_err": stages["max_abs_err"][stage], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None})
    emit("profiler_counts", windows=[{"kernel": k, "recorded": c, "launched": n}
                                     for k, c, n in PROFILER_COUNTS])
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


def main_mesh() -> None:
    """``python3 chip_smoke.py mesh``: the build, the slice, the foodweb and
    the mesh phases alone (on a host with four cards the mesh phase's NCCL
    leg runs, one rank a card)."""
    smi = phase_device()
    timed(phase_build)
    eager = timed(phase_slice)
    timed(phase_mesh, eager, timed(phase_foodweb))
    print(smi, flush=True)


def main_fused_models() -> None:
    """``python3 chip_smoke.py fused_models``: the libraries it needs, the
    slice (the eager headline it is held against) and the fused_models
    phase alone."""
    smi = phase_device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(12) as pool:
        libs = [pool.submit(small_lu.build), pool.submit(fused_solve.build)]
        libs += list(model_builds(pool).values())
        for f in libs:
            f.result()
    emit("build", seconds=time.perf_counter() - t0)
    timed(phase_fused_models, timed(phase_slice))
    print(smi, flush=True)


def main_fused_quad_ops() -> None:
    """``python3 chip_smoke.py fused_quad_ops``: the libraries it needs, the
    slice, the quadrature headline (the eager results it is held against),
    the table of ops and the fused_quad_ops phase alone."""
    smi = phase_device()
    t0 = time.perf_counter()
    models = generated_models()
    with ThreadPoolExecutor(12) as pool:
        libs = [pool.submit(small_lu.build), pool.submit(fused_solve.build)]
        libs += [pool.submit(fused_solve.build, False, mode, models[m])
                 for m in ("roberts_generated", "roberts_quad", "morris_lecar")
                 for mode in ("full", "refined") if m != "roberts_generated" or mode == "full"]
        libs += [pool.submit(fused_solve.build_eval, m) for m in models.values()]
        libs.append(pool.submit(fused_solve.build_eval, fused_solve.ROBERTS))
        for f in libs:
            f.result()
    emit("build", seconds=time.perf_counter() - t0)
    eager = timed(phase_slice)
    quad = timed(phase_quadrature_headline, eager)
    table = timed(phase_model_ops)
    timed(phase_fused_quad_ops, eager, quad, table)
    print(smi, flush=True)


def main_fused_linear() -> None:
    """``python3 chip_smoke.py fused_linear``: the libraries it needs and the
    fused_linear phase alone, then its kernels line."""
    smi = phase_device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(16) as pool:
        libs = list(linear_builds(pool).values())
        for f in libs:
            f.result()
    emit("build", seconds=time.perf_counter() - t0)
    linear = timed(phase_fused_linear)
    rows = [r for kinds in linear["rows"].values() for r in kinds.values()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["mesh"]:
        main_mesh()
    elif sys.argv[1:] == ["fused_models"]:
        main_fused_models()
    elif sys.argv[1:] == ["fused_quad_ops"]:
        main_fused_quad_ops()
    elif sys.argv[1:] == ["fused_linear"]:
        main_fused_linear()
    else:
        main()
