"""The whole-solve kernel's device code, built for the HOST and held against
the eager port on the CPU, bit for bit.

``csrc/fused_solve.cu`` (with ``ida_lane.cuh``, ``small_lu.cuh`` and
``rounded.cuh``) is compiled with the host's C++ compiler: the CUDA keywords
are defined away, the rounding intrinsics (``__dmul_rn`` ...) become the
plain operators, the block's dynamic shared memory becomes a static array
(the threads of a block run one after another, each on its own column), each
``kernel<<<grid, threads, shared, stream>>>(...)`` becomes a loop over blocks
and threads, and ``-ffp-contract=off`` keeps every operation rounded once, as
the intrinsics do on the card. On the CPU the eager port calls the C
library's ``pow`` and an IEEE ``sqrt``, as the host build does, so in float64
the two must agree in every bit. This checks the device code's logic, its
pointer tables and argument struct (``ops.fused_solve.STATE_FIELDS``,
``SolveArgs``), the batch-leading out-of-place entry and the wrapper's
budgeted host loop in the CPU tests; the kernel itself runs only on a GPU
(tests/test_torch_cuda_kernels.py, ``chip_smoke.py``). A bypass of the
rounding type cannot show here, where nothing contracts: on the card the
stage checks and the launch-by-launch check of ``chip_smoke.py`` catch it.
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

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

ATOL = [1e-8, 1e-6, 1e-6]
CANONICAL_NST = [29, 43, 68, 95, 126, 161, 202, 250, 293, 325, 348, 362]

_STUB = r"""
#pragma once
#include <math.h>
#include <cmath>
#include <cstddef>
#include <algorithm>
using std::min; using std::max; using std::isfinite;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
struct HostDim { unsigned x = 0; };
static thread_local HostDim blockIdx, threadIdx, blockDim;
inline int cudaGetLastError() { return 0; }
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __double2float_rn(double a) { return (float)a; }
"""
_PRELUDE = r"""
#define __device__
#define __global__
#define __shared__
#define __grid_constant__
#define __align__(x)
#define __forceinline__ inline
#define __launch_bounds__(...)
#include <cuda_runtime.h>
alignas(16) unsigned char ida_shared[227 * 1024];
template <class F, class... A>
void host_launch(unsigned grid, unsigned threads, F f, A... a) {
  blockDim.x = threads;
  for (unsigned g = 0; g < grid; ++g)
    for (unsigned t = 0; t < threads; ++t) { blockIdx.x = g; threadIdx.x = t; f(a...); }
}
"""


# (mode flags (ops.fused_solve.mode_flags), model) -> the host build of that
# mode and model
_HOST_BUILDS: dict = {}


def host_build(tmp_path_factory, flags: tuple = (),
               model: fused_solve.FusedModel = fused_solve.ROBERTS) -> ctypes.CDLL:
    """The host build of ``fused_solve.cu`` with the mode ``flags`` and the
    model (a generated one's header beside it, as ``ops.fused_solve.build``
    compiles it), compiled at its first use in the test process."""
    if (flags, model) in _HOST_BUILDS:
        return _HOST_BUILDS[flags, model]
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("fused_host")
    (out / "cuda_runtime.h").write_text(_STUB)
    if model.header is not None:
        (out / "ida_model.cuh").write_text(model.header)
    src, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), [^,]+, \(cudaStream_t\)stream>>>\(",
                     r"host_launch(\2, \3, \1, ", (CSRC / "fused_solve.cu").read_text())
    assert n == 3  # the solve kernel, the stage kernel and the model's evaluation
    (out / "fused_solve_host.cpp").write_text(_PRELUDE + src)
    lib_path = out / "libfused_solve_host.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(out),
         "-I", str(CSRC), *flags, *fused_solve.model_flags(model), "-o", str(lib_path),
         str(out / "fused_solve_host.cpp")],
        capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _HOST_BUILDS[flags, model] = fused_solve.bind(ctypes.CDLL(str(lib_path)))
    return _HOST_BUILDS[flags, model]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_build(tmp_path_factory)


@pytest.fixture
def on_host(host_lib, tmp_path_factory, monkeypatch):
    """Route the wrappers' launches to the host build of each mode and
    model, on CPU tensors."""
    monkeypatch.setattr(
        fused_solve, "build",
        lambda fast_math=False, ls_precision="full", model=fused_solve.ROBERTS,
        linear=fused_solve.DENSE: {
            "lib": host_build(tmp_path_factory,
                              fused_solve.mode_flags(fast_math, ls_precision, linear), model)})
    monkeypatch.setattr(fused_solve, "stream_of", lambda t: 0)
    monkeypatch.setattr(
        fused_solve, "state_refs",
        lambda st, batch_axis, opts=IdaOptions(), model=fused_solve.ROBERTS: fused_solve.StateRefs(
            **{f: getattr(st, f).data_ptr() for f in fused_solve.touched_fields(opts, model)}))
    fused_stages._bind.cache_clear()
    yield
    fused_stages._bind.cache_clear()
    fused_solve.reset_launch_counts()
    fused_stages.reset_launch_counts()


def _kernel_solve(st_b, params, tout, opts, budget=None, tol=None):
    """The kernel's entry as ``make_fused_solve`` drives it on the card:
    batch-leading in, out of place, tolerances by value."""
    p_b = torch.as_tensor(params).contiguous()
    bsz = st_b.tn.shape[0]
    tol_in = fused_solve.tol_inputs(tol or tol_sv(1e-4, ATOL, device="cpu"), 3, bsz,
                                    torch.float64, torch.device("cpu"))
    return fused_solve._solve_cuda(st_b, p_b, tol_in, tout, opts, fused_solve.ROBERTS, budget)


def _differ(a, b):
    return [f for f, x in zip(a._fields, a) if isinstance(x, torch.Tensor)
            and not torch.equal(x, getattr(b, f))]


def _stress_inputs(b=16, seed=5, opts=IdaOptions()):
    rng = np.random.default_rng(seed)
    params = np.outer(np.exp(rng.uniform(-3, 3, b)), ROBERTS_PARAMS) * np.exp(
        rng.uniform(-1, 1, (b, 3)))
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu", opts=opts)
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


# the arithmetic modes of IdaOptions the kernel compiles in: (fast_math,
# ls_precision)
MODES = [(fm, ls) for fm in (False, True) for ls in ("full", "single", "refined")]


def _mode_id(mode):
    return "-".join((["fast_math"] if mode[0] else []) + [mode[1]])


@pytest.mark.parametrize("budget", [None, 7], ids=["unbudgeted", "budget7"])
@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_host_build_is_bitwise_the_eager_mode(on_host, mode, budget):
    # the kernel source built in each mode is the eager solve under the
    # same options, bit for bit in every field (the float32 lu, the refined
    # mode's lsetup point): heterogeneous lanes with tstop, hmax and hin set
    # on some, a first call to tout 4, then a continuing call to 400
    opts = IdaOptions(fast_math=mode[0], ls_precision=mode[1])
    params, st0 = _stress_inputs(opts=opts)
    assert st0.lu.dtype == (torch.float64 if mode[1] == "full" else torch.float32)
    st_e = st_k = st0
    for tout in (4.0, 400.0):
        ref = make_ensemble_solve(roberts_factory, opts)(st_e, params,
                                                         tol_sv(1e-4, ATOL, device="cpu"), tout)
        fused_solve.reset_launch_counts()
        got = _kernel_solve(st_k, params, tout, opts, budget=budget)
        kinds = ("init", "cont") if budget else ("solve",)
        assert {k for k, _, _ in fused_solve.MODE_LAUNCHES} == set(kinds)
        assert {m for _, m, _ in fused_solve.MODE_LAUNCHES} == {fused_solve.mode_name(opts)}
        assert {m for _, _, m in fused_solve.MODE_LAUNCHES} == {"roberts"}
        assert _differ(got[0], ref[0]) == [], tout
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        st_e, st_k = ref[0], got[0]
    if mode[1] == "refined":
        assert bool((st_k.ls_cj != 0).all()) and st_k.ls_yy.shape == (16, 3)


def test_host_build_budgeted_launches_are_the_eager_budgeted_calls(on_host):
    # after every launch of the budgeted kernel (K3 out of place, then K4 in
    # place on its result) the state and the 9-field carry are bit for bit
    # those of the eager solve(max_attempts=3) call the launch stands for; a
    # first solve to tout 4, then a continuing one to 40
    _budgeted_launches_are_the_eager_calls(IdaOptions())


@pytest.mark.parametrize("mode", [(True, "full"), (False, "refined"), (True, "refined")],
                         ids=_mode_id)
def test_host_build_budgeted_launches_in_the_modes_are_the_eager_budgeted_calls(on_host, mode):
    # as above in the modes whose carry differs: under fast_math phi is
    # unscaled at every budget boundary, under "refined" the lsetup point
    # carries across launches
    _budgeted_launches_are_the_eager_calls(IdaOptions(fast_math=mode[0], ls_precision=mode[1]))


def _budgeted_launches_are_the_eager_calls(opts):
    params, st0 = _stress_inputs(opts=opts)
    p_b = torch.as_tensor(params).contiguous()
    p = p_b.t().contiguous()
    problem = roberts_factory(p)
    tol_in = fused_solve.tol_inputs(tol_sv(1e-4, ATOL, device="cpu"), 3, 16, torch.float64,
                                    torch.device("cpu"))
    src, eager_st = st0, to_native(st0)
    for tout in (4.0, 40.0):
        inputs = fused_solve.lane_inputs(eager_st, p, tol_sv(1e-4, ATOL, device="cpu"), tout, 3)
        tol = TolControl(inputs[1], inputs[2])
        carry = fused_solve.new_carry(16, torch.float64, "cpu", True)
        dst = fused_solve.empty_result(src, opts, fused_solve.ROBERTS)
        eager = (eager_st, None, None, None)

        def step(resume):
            nonlocal eager
            istate = fused_solve.launch("cont" if resume else "init", dst if resume else src, dst,
                                        p_b, tol_in, tout, carry, opts, fused_solve.ROBERTS, 3)
            eager = core_solve(eager[0], problem, opts, tol, inputs[3], max_attempts=3,
                               resume_carry=eager[3] if resume else None)
            assert _differ(to_native(dst), eager[0]) == [], (tout, resume)
            for f, want in zip(fused_solve.CARRY_FIELDS, eager[3]):
                assert torch.equal(carry[f], want.to(carry[f].dtype)), (tout, resume, f)
            return istate

        assert fused_solve.run_until_done(step) > 3
        src, eager_st = dst, eager[0]


@pytest.mark.parametrize("bsz", [1, 129, 200])
def test_host_build_takes_batches_that_do_not_fill_a_block(on_host, bsz):
    # 64 threads a block: one lane, one lane over two blocks, three blocks and a bit
    params = np.outer(np.exp(np.linspace(-0.3, 0.3, bsz)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (bsz, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu")
    ref = make_ensemble_solve(roberts_factory)(st0, params, tol_sv(1e-4, ATOL, device="cpu"), 0.4)
    got = _kernel_solve(st0, params, 0.4, IdaOptions())
    assert got[1].shape == got[2].shape == (bsz,)
    assert _differ(got[0], ref[0]) == []
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


@pytest.mark.parametrize("budget", [None, 3], ids=["unbudgeted", "budget3"])
def test_host_build_leaves_its_input_state_untouched(on_host, budget):
    # out of place: every input tensor keeps its bits; fields the solve never
    # touches pass through as the same tensors, the others are new ones
    params, st0 = _stress_inputs()
    before = [x.clone() if isinstance(x, torch.Tensor) else x for x in st0]
    got, _, _ = _kernel_solve(st0, params, 4.0, IdaOptions(), budget=budget)
    assert int(got.nst.sum()) > 0
    touched = fused_solve.touched_fields(IdaOptions(), fused_solve.ROBERTS)
    for f, x, was in zip(st0._fields, st0, before):
        if not isinstance(x, torch.Tensor):
            continue
        assert torch.equal(x, was, ), f
        assert (getattr(got, f) is x) == (f not in touched), f


def test_host_build_takes_per_lane_tolerances(on_host):
    # rtol [B] and atol [B, N] travel as tensors, not by value
    params, st0 = _stress_inputs()
    rng = np.random.default_rng(11)
    rtol = torch.from_numpy(1e-4 * np.exp(rng.uniform(-1, 1, 16)))
    atol = torch.from_numpy(np.array(ATOL) * np.exp(rng.uniform(-1, 1, (16, 3))))
    tol = TolControl(rtol, atol)
    assert fused_solve.tol_inputs(tol, 3, 16, torch.float64, torch.device("cpu")).rtol is None
    got = _kernel_solve(st0, params, 4.0, IdaOptions(), tol=tol)
    p = torch.as_tensor(params).t().contiguous()
    ref = core_solve(to_native(st0), roberts_factory(p), IdaOptions(),
                     TolControl(rtol, atol.t().contiguous()), torch.full((16,), 4.0).double())
    assert _differ(got[0], from_native(ref[0])) == []
    assert torch.equal(got[2], ref[2])
    plain = fused_solve.make_fused_solve(roberts_factory, tol)(st0, params, 4.0)
    assert _differ(plain[0], got[0]) == [] and torch.equal(plain[2], got[2])
    with pytest.raises(ValueError, match="tol must be"):
        fused_solve.tol_inputs(TolControl(rtol[:5], atol), 3, 16, torch.float64,
                               torch.device("cpu"))


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


_REAL_OPS = r"""
#include "rounded.cuh"
template <typename S>
static void real_ops(const S* a, const S* b, S* out, int n) {
  using R = ida::Real<S>;
  for (int i = 0; i < n; ++i) {
    R x, y;
    x.v = a[i];
    y.v = b[i];
    out[0 * n + i] = (x + y).v;
    out[1 * n + i] = (x - y).v;
    out[2 * n + i] = (x * y).v;
    out[3 * n + i] = (x / y).v;
    out[4 * n + i] = (-x).v;
    out[5 * n + i] = ida::absval(x).v;
    out[6 * n + i] = ida::sqrt_of(ida::absval(x)).v;
    out[7 * n + i] = R(0.1).v;
    out[8 * n + i] = (S)((x < y) + 2 * (x <= y) + 4 * (x == y) + 8 * (x != y) + 16 * (x > y)
                         + 32 * (x >= y) + 64 * ida::finite(x));
  }
}
extern "C" void real_ops_f64(const double* a, const double* b, double* out, int n) {
  real_ops<double>(a, b, out, n);
}
extern "C" void real_ops_f32(const float* a, const float* b, float* out, int n) {
  real_ops<float>(a, b, out, n);
}
"""
_OPS = ("add", "sub", "mul", "div", "neg", "abs", "sqrt", "const", "compare")


@pytest.fixture(scope="module")
def real_ops(tmp_path_factory):
    """ida::Real's operators (csrc/rounded.cuh, host build) on random pairs,
    with zeros, infinities, NaNs and subnormals among them: {dtype: (a, b,
    out[9, n])}."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("real_ops")
    (out / "cuda_runtime.h").write_text(_STUB)
    (out / "real_ops.cpp").write_text(_PRELUDE.split("alignas")[0] + _REAL_OPS)
    lib_path = out / "libreal_ops.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(out),
         "-I", str(CSRC), "-o", str(lib_path), str(out / "real_ops.cpp")],
        capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(7)
    results = {}
    for dt, name in ((np.float64, "real_ops_f64"), (np.float32, "real_ops_f32")):
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, np.finfo(dt).tiny / 4, 1.0], dt)
        a = np.concatenate([(rng.normal(size=2000) * 10.0 ** rng.integers(-30, 30, 2000)).astype(dt),
                            np.repeat(special, len(special))])
        b = np.concatenate([(rng.normal(size=2000) * 10.0 ** rng.integers(-30, 30, 2000)).astype(dt),
                            np.tile(special, len(special))])
        res = np.empty((len(_OPS), a.size), dt)
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        fn.restype = None
        fn(a.ctypes.data, b.ctypes.data, res.ctypes.data, a.size)
        results[dt] = (a, b, res)
    return results


@pytest.mark.parametrize("dt", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("op", _OPS)
def test_rounding_type_operator_is_numpys(real_ops, op, dt):
    # each operator of ida::Real rounds once, as numpy's (IEEE) does, bit for
    # bit, NaN for NaN
    a, b, res = real_ops[dt]
    with np.errstate(all="ignore"):
        want = {
            "add": lambda: a + b, "sub": lambda: a - b, "mul": lambda: a * b,
            "div": lambda: a / b, "neg": lambda: -a, "abs": lambda: np.abs(a),
            "sqrt": lambda: np.sqrt(np.abs(a)), "const": lambda: np.full_like(a, dt(0.1)),
            "compare": lambda: ((a < b) + 2 * (a <= b) + 4 * (a == b) + 8 * (a != b)
                                + 16 * (a > b) + 32 * (a >= b) + 64 * np.isfinite(a)).astype(dt),
        }[op]()
    got = res[_OPS.index(op)]
    assert want.dtype == got.dtype
    bits = np.uint64 if dt == np.float64 else np.uint32
    same = (got.view(bits) == want.view(bits)) | (np.isnan(got) & np.isnan(want))
    assert bool(same.all()), (op, a[~same][:3], b[~same][:3], got[~same][:3], want[~same][:3])
