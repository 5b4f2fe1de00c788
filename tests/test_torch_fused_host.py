"""The whole-solve kernel's device code, built for the HOST and held against
the eager port on the CPU, bit for bit.

``csrc/fused_solve.cu`` (with ``ida_lane.cuh``, ``small_lu.cuh`` and
``torch_pow.cu``) is compiled with the host's C++ compiler: the CUDA
keywords are defined away, each ``kernel<<<grid, threads, 0,
stream>>>(...)`` becomes a loop over blocks and threads, and
``-ffp-contract=off`` keeps every operation
rounded once, as ``-fmad=false`` does on the card. On the CPU the eager
port calls the C library's ``pow`` and an IEEE ``sqrt``, as the host build
does, so in float64 the two must agree in every bit. This checks the
device code's logic, its pointer table (``ops.fused_solve.STATE_FIELDS``)
and the wrapper's budgeted host loop in the CPU tests; the kernel itself
runs only on a GPU (tests/test_torch_cuda_kernels.py, ``chip_smoke.py``).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ida_tpu_torch import constants as C
from ida_tpu_torch.core.solve import TASK_ONE_STEP
from ida_tpu_torch.core.solve import solve as core_solve
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.ops import fused_solve, fused_stages
from ida_tpu_torch.ops._build import CSRC
from ida_tpu_torch.parallel import ensemble_init, from_native, make_ensemble_solve, to_native
from ida_tpu_torch.tol_control import TolControl, tol_sv

torch.set_num_threads(1)

ATOL = [1e-8, 1e-6, 1e-6]
CANONICAL_NST = [29, 43, 68, 95, 126, 161, 202, 250, 293, 325, 348, 362]

_STUB = r"""
#pragma once
#include <math.h>
#include <cmath>
#include <algorithm>
using std::min; using std::max; using std::isfinite;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct HostDim { unsigned x = 0; };
static thread_local HostDim blockIdx, threadIdx, blockDim;
inline int cudaGetLastError() { return 0; }
"""
_PRELUDE = r"""
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
#include <cuda_runtime.h>
template <class F, class... A>
void host_launch(unsigned grid, unsigned threads, F f, A... a) {
  blockDim.x = threads;
  for (unsigned g = 0; g < grid; ++g)
    for (unsigned t = 0; t < threads; ++t) { blockIdx.x = g; threadIdx.x = t; f(a...); }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("fused_host")
    (out / "cuda_runtime.h").write_text(_STUB)
    src, n = re.subn(r"(\w+<[^;{}]*?>)<<<([^,]+), ([^,]+), 0, \(cudaStream_t\)stream>>>\(",
                     r"host_launch(\2, \3, \1, ", (CSRC / "fused_solve.cu").read_text())
    assert n == 2  # the solve kernel and the stage kernel
    (out / "fused_solve_host.cpp").write_text(_PRELUDE + src)
    (out / "torch_pow_host.cpp").write_text(_PRELUDE + (CSRC / "torch_pow.cu").read_text())
    lib_path = out / "libfused_solve_host.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(out),
         "-I", str(CSRC), "-o", str(lib_path), str(out / "fused_solve_host.cpp"),
         str(out / "torch_pow_host.cpp")],
        capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib_path))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """Route the wrappers' launches to the host build, on CPU tensors."""
    fused_solve.bind(host_lib)
    monkeypatch.setattr(fused_solve, "build", lambda: {"lib": host_lib})
    monkeypatch.setattr(fused_solve, "stream_of", lambda t: 0)
    monkeypatch.setattr(fused_solve, "state_refs", lambda native: fused_solve.StateRefs(
        **{f: getattr(native, f).data_ptr() for f in fused_solve.STATE_FIELDS}))
    fused_stages._bind.cache_clear()
    yield
    fused_stages._bind.cache_clear()
    fused_solve.reset_launch_counts()
    fused_stages.reset_launch_counts()


def _kernel_solve(st_b, params, tout, opts, budget=None):
    native = fused_solve.native_clone(st_b)
    p = torch.as_tensor(params).t().contiguous()
    inputs = fused_solve.lane_inputs(native, p, tol_sv(1e-4, ATOL, device="cpu"), tout, 3)
    tret, istate = fused_solve._solve_cuda(native, inputs, opts, 0, budget)
    return from_native(native), tret, istate


def _differ(a, b):
    return [f for f, x in zip(a._fields, a) if isinstance(x, torch.Tensor)
            and not torch.equal(x, getattr(b, f))]


def _stress_inputs(b=16, seed=5):
    rng = np.random.default_rng(seed)
    params = np.outer(np.exp(rng.uniform(-3, 3, b)), ROBERTS_PARAMS) * np.exp(
        rng.uniform(-1, 1, (b, 3)))
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu")
    lane = torch.arange(b)
    tstop = torch.where(lane % 3 == 0, 37.5, 0.0).double()
    st = st._replace(tstop=tstop, tstop_set=tstop > 0,
                     hmax_inv=torch.where(lane % 4 == 1, 1 / 20.0, 0.0).double(),
                     hin=torch.where(lane % 5 == 2, 1e-6, 0.0).double())
    return params, st


@pytest.mark.parametrize("opts", [
    IdaOptions(),
    IdaOptions(maxord=3, mxstep=60, suppressalg=True, maxnlsit=3),
    IdaOptions(maxncf=2, maxnef=2, mxstep=200),
], ids=["default", "maxord3-mxstep60-suppressalg", "maxncf2-maxnef2"])
def test_host_build_is_bitwise_the_eager_solve(on_host, opts):
    # heterogeneous lanes with tstop, hmax and hin set on some: a first
    # call to tout 4, then a continuing call to 400, unbudgeted and with a
    # budget of 3 attempts a launch
    params, st0 = _stress_inputs()
    st_e = st_k = st0
    codes = set()
    for tout in (4.0, 400.0):
        ref = make_ensemble_solve(roberts_factory, opts)(st_e, params,
                                                         tol_sv(1e-4, ATOL, device="cpu"), tout)
        got = _kernel_solve(st_k, params, tout, opts)
        budgeted = _kernel_solve(st_k, params, tout, opts, budget=3)
        assert _differ(got[0], ref[0]) == []
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        assert _differ(budgeted[0], got[0]) == [] and torch.equal(budgeted[2], got[2])
        codes |= set(ref[2].tolist())
        st_e, st_k = ref[0], got[0]
    assert C.TSTOP_RETURN in codes


def test_host_build_budgeted_launches_are_the_eager_budgeted_calls(on_host):
    # after every launch of the budgeted kernel (K3, then K4) the state and
    # the 9-field carry are bit for bit those of the eager
    # solve(max_attempts=3) call the launch stands for; a first solve to
    # tout 4, then a continuing one to 40
    params, st0 = _stress_inputs()
    p = torch.as_tensor(params).t().contiguous()
    problem, opts = roberts_factory(p), IdaOptions()
    native, eager_st = fused_solve.native_clone(st0), to_native(st0)
    for tout in (4.0, 40.0):
        inputs = fused_solve.lane_inputs(native, p, tol_sv(1e-4, ATOL, device="cpu"), tout, 3)
        tol = TolControl(inputs[1], inputs[2])
        carry = fused_solve.new_carry(16, torch.float64, "cpu", True)
        eager = (eager_st, None, None, None)

        def step(resume):
            nonlocal eager
            istate = fused_solve.launch("cont" if resume else "init", native, inputs, carry,
                                        opts, 0, 3)
            eager = core_solve(eager[0], problem, opts, tol, inputs[3], max_attempts=3,
                               resume_carry=eager[3] if resume else None)
            assert _differ(native, eager[0]) == [], (tout, resume)
            for f, want in zip(fused_solve.CARRY_FIELDS, eager[3]):
                assert torch.equal(carry[f], want.to(carry[f].dtype)), (tout, resume, f)
            return istate

        assert fused_solve.run_until_done(step) > 3
        eager_st = eager[0]


def test_host_build_gives_the_canonical_lane(on_host):
    params = ROBERTS_PARAMS[None]
    st = ensemble_init(roberts_factory, params, ROBERTS_YY0[None], ROBERTS_YP0[None], device="cpu")
    nst = []
    for k in range(12):
        st, tret, istate = _kernel_solve(st, params, 0.4 * 10**k, IdaOptions())
        assert int(istate[0]) == C.SUCCESS
        nst.append(int(st.nst[0]))
    assert nst == CANONICAL_NST
    assert {f: int(getattr(st, f)[0]) for f in ("nst", "nre", "nje", "nni", "netf", "ncfn")} == {
        "nst": 362, "nre": 537, "nje": 60, "nni": 537, "netf": 15, "ncfn": 0}


@pytest.fixture(scope="module")
def mid_flight_cpu():
    params = np.outer(np.exp(np.linspace(-0.5, 0.5, 16)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (16, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu")
    tol = tol_sv(1e-4, ATOL, device="cpu")
    fn = make_ensemble_solve(roberts_factory, itask=TASK_ONE_STEP)
    snaps = {"init": to_native(st)}
    for k in range(1, 9):
        st, _, _ = fn(st, params, tol, 400.0)
        if k in (1, 8):
            snaps[f"step{k}"] = to_native(st)
    snaps["hh_x16"] = snaps["step8"]._replace(hh=snaps["step8"].hh * 16.0)
    return torch.from_numpy(params.T).contiguous(), tol, snaps


@pytest.mark.parametrize("stage", sorted(fused_stages.STAGES))
def test_host_build_of_each_stage_is_bitwise_its_eager_stage(on_host, mid_flight_cpu, stage):
    params, tol, snaps = mid_flight_cpu
    for name in ["init"] if stage == "prologue" else ["step1", "step8", "hh_x16"]:
        st = snaps[name]
        if stage in ("nls", "error_test", "complete_step"):
            st, _ = fused_stages.plain_stage("set_coeffs", st, params, tol, 400.0)
            st = st._replace(tn=st.tn + st.hh)
        launch, got_st, got = fused_stages.prepare_launch(stage, st, params, tol, 400.0)
        launch()
        ref_st, ref = fused_stages.plain_stage(stage, st, params, tol, 400.0)
        assert _differ(got_st, ref_st) == [], (name, stage)
        for k, v in ref.items():
            assert torch.equal(got[k].to(v.dtype), v), (name, stage, k)
