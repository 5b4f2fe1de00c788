"""``ida_tpu_torch.ops.make_fused_solve`` on CPU tensors, where it runs its
plain version (the eager ``core.solve``, with the budgeted host loop when a
budget is given), against the JAX package:

* f32, B=8, tout 0.4, unbudgeted and with ``attempt_budget=6``, against
  ``ida_tpu.ops.fused_solve.make_fused_solve(..., tile=4, interpret=True)``
  as tests/test_fused_solve.py runs it: istate and tret exactly, yy to
  rtol 2e-2 / atol 1e-6 (that file's own tolerance between the kernel and
  the default path). nst is held to one step per lane: the jitted f32 JAX
  solve (the kernel and the default path alike) contracts multiply-adds
  into FMAs, and at this input one lane takes one step more there than in
  the JAX solve run op by op;
* f32 and f64 against the JAX ``core_solve`` run op by op: bit for bit.

Both JAX runs are pinned (tests/make_torch_refs.py, ``fused_solve_jax``).

Then the wrapper's contract: what it raises on, counters that only kernel
launches move, the batch-leading layout and dtypes it returns, and the stage
list of the K5 harness against the stage kernels that
``csrc/fused_solve.cu`` exports (the kernels themselves run only on a GPU;
see tests/test_torch_cuda_kernels.py).
"""

import ctypes
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YY0
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.ops.fused_solve import make_fused_solve as jmake_fused_solve
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu.tol_control import tol_sv as jtol_sv
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.core.state import IdaOptions, IdaState, init_state
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.ops import fused_solve, fused_stages, make_fused_solve
from ida_tpu_torch.parallel import ensemble_init, make_ensemble_solve, to_native
from ida_tpu_torch.tol_control import TolControl, tol_ss, tol_sv
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

B = 8
ATOL32 = [1e-6, 1e-6, 1e-6]
ATOL = [1e-8, 1e-6, 1e-6]
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn")
CU = pathlib.Path(fused_solve.__file__).resolve().parent.parent / "csrc" / "fused_solve.cu"


def _inputs(b, scale=None):
    scale = np.linspace(0.9, 1.1, b) if scale is None else scale
    params = np.outer(scale, ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


def _port_fused(dtype, budget, atol, tout=0.4, b=B, scale=None):
    params, yy0, yp0 = _inputs(b, scale)
    st = ensemble_init(troberts, params, yy0, yp0, device="cpu", dtype=dtype)
    tol = tol_sv(1e-4, atol, device="cpu", dtype=dtype)
    return st, make_fused_solve(troberts, tol, attempt_budget=budget)(st, params, tout)


def _jax_fused_f32(budget):
    """The JAX package's fused Pallas kernel in interpret mode, f32, tile 4."""
    dtype = jnp.float32
    params, yy0, yp0 = (jnp.asarray(a, dtype) for a in _inputs(B))
    tol = jtol_sv(1e-4, jnp.asarray(ATOL32, dtype), dtype=dtype)
    opts = JOptions()
    states = jensemble_init(jroberts, params, yy0, yp0, dtype=dtype, opts=opts)
    fused = jmake_fused_solve(jroberts, tol, opts, tile=4, interpret=True,
                              attempt_budget=budget)
    st, tret, ist = fused(states, params, 0.4)
    return {"nst": np.asarray(st.nst), "yy": np.asarray(st.yy), "tret": np.asarray(tret),
            "istate": np.asarray(ist)}


def _jax_op_by_op(name):
    """The JAX batch-native core_solve, B=8 to tout 0.4, op by op, with the
    tolerances of the f32 comparison above (float32) or of the port's slice
    (float64)."""
    dtype = jnp.dtype(name)
    atol = ATOL32 if name == "float32" else ATOL
    params, yy0, yp0 = (jnp.asarray(a, dtype) for a in _inputs(B))
    st = jensemble_init(jroberts, params, yy0, yp0, dtype=dtype, opts=JOptions())
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), st)
    tol = JTol(jnp.full((B,), 1e-4, dtype), jnp.tile(jnp.asarray(atol, dtype)[:, None], (1, B)))
    with jax.disable_jit():
        jst, jtret, jist = jsolve(st, jroberts(params.T), JOptions(), tol,
                                  jnp.full((B,), 0.4, dtype))
    return {"state": {f: np.asarray(getattr(jst, f))
                      for f in COUNTERS + ("yy", "yp", "phi", "psi", "hh", "tn", "kused")},
            "tret": np.asarray(jtret), "istate": np.asarray(jist)}


# what the pinned references (jax_fused_solve_live) are computed from
REF_INPUTS = {"b": B, "atol32": ATOL32, "atol": ATOL, "inputs": _inputs(B), "tout": 0.4,
              "budgets": [None, 6]}


def jax_fused_solve_live():
    return {"fused_f32": {str(b): _jax_fused_f32(b) for b in (None, 6)},
            "op_by_op": {name: _jax_op_by_op(name) for name in ("float32", "float64")}}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX runs, pinned (tests/make_torch_refs.py, ``fused_solve_jax``)."""
    return load("fused_solve_jax", REF_INPUTS)


@pytest.fixture(params=[None, 6], ids=["unbudgeted", "budget6"])
def jax_fused_f32(request, jax_refs):
    return request.param, jax_refs["fused_f32"][str(request.param)]


def test_plain_version_matches_the_jax_fused_kernel_f32(jax_fused_f32):
    budget, ref = jax_fused_f32
    _, (st, tret, ist) = _port_fused(torch.float32, budget, ATOL32)
    np.testing.assert_array_equal(ist.numpy(), ref["istate"])
    np.testing.assert_array_equal(tret.numpy(), ref["tret"])
    assert np.abs(st.nst.numpy() - ref["nst"]).max() <= 1
    np.testing.assert_allclose(st.yy.numpy(), ref["yy"], rtol=2e-2, atol=1e-6)


@pytest.fixture(params=["float32", "float64"])
def jax_op_by_op(request, jax_refs):
    """The JAX batch-native core_solve, B=8 to tout 0.4, op by op (pinned),
    with the tolerances of the f32 comparison above (f32) or of the port's
    slice (f64)."""
    atol = ATOL32 if request.param == "float32" else ATOL
    return getattr(torch, request.param), atol, jax_refs["op_by_op"][request.param]


@pytest.mark.parametrize("budget", [None, 6], ids=["unbudgeted", "budget6"])
def test_plain_version_is_bitwise_the_op_by_op_reference(jax_op_by_op, budget):
    dtype, atol, ref = jax_op_by_op
    _, (st, tret, ist) = _port_fused(dtype, budget, atol)
    assert bool((ist == C.SUCCESS).all())
    np.testing.assert_array_equal(ist.numpy(), ref["istate"])
    np.testing.assert_array_equal(tret.numpy(), ref["tret"])
    for f in COUNTERS + ("yy", "yp", "phi", "psi", "hh", "tn", "kused"):
        np.testing.assert_array_equal(
            getattr(st, f).numpy(), np.moveaxis(ref["state"][f], -1, 0), err_msg=f)


@pytest.mark.parametrize("budget", [None, 1, 7])
def test_plain_version_is_the_eager_ensemble_solve(budget):
    # heterogeneous lanes to tout 400: the fused entry point's plain version
    # (budgeted or not) is bit for bit the eager ensemble solve
    scale = np.exp(np.linspace(-1.0, 1.0, 6))
    st0, (st, tret, ist) = _port_fused(torch.float64, budget, ATOL, tout=400.0, b=6, scale=scale)
    params = _inputs(6, scale)[0]
    ref = make_ensemble_solve(troberts)(st0, params, tol_sv(1e-4, ATOL, device="cpu"), 400.0)
    assert torch.equal(tret, ref[1]) and torch.equal(ist, ref[2])
    for f, x in zip(ref[0]._fields, ref[0]):
        if isinstance(x, torch.Tensor):
            assert torch.equal(getattr(st, f), x), f


def test_launch_counters_stay_at_zero_on_the_cpu():
    fused_solve.reset_launch_counts()
    fused_stages.reset_launch_counts()
    _port_fused(torch.float64, 3, ATOL)
    st = to_native(ensemble_init(troberts, *_inputs(2), device="cpu"))
    fused_stages.run_stage("prologue", st, torch.from_numpy(_inputs(2)[0].T),
                           tol_sv(1e-4, ATOL, device="cpu"), 0.4)
    assert not fused_solve.MODE_LAUNCHES
    assert not any(fused_stages.STAGE_LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_returns_the_batch_leading_layout_and_the_input_dtypes(dtype):
    st0, (st, tret, ist) = _port_fused(dtype, None, ATOL, b=3)
    assert tret.shape == ist.shape == (3,) and tret.dtype == dtype and ist.dtype == torch.int32
    for f, x in zip(st0._fields, st0):
        if isinstance(x, torch.Tensor):
            y = getattr(st, f)
            assert (y.shape, y.dtype) == (x.shape, x.dtype), f
    # the input state is not changed
    assert int(st0.nst.sum()) == 0 and int(st.nst.sum()) > 0


def _call(factory=troberts, dtype=torch.float64, device="cpu", budget=None):
    params, yy0, yp0 = _inputs(2)
    st = ensemble_init(troberts, params, yy0, yp0, device="cpu", dtype=dtype)
    if device != "cpu":
        st = type(st)(*(x.to(device) if isinstance(x, torch.Tensor) else x for x in st))
    tol = tol_sv(1e-4, ATOL, device=device, dtype=dtype)
    return make_fused_solve(factory, tol, attempt_budget=budget)(st, params, 0.4)


def _with_roots(params):
    return dataclasses.replace(troberts(params), nroots=2, root=lambda t, yy, yp: yy[:2])


def test_raises_on_a_factory_without_a_compiled_in_model():
    # a factory without an analytic jac has no model the kernel can compile
    # in (ida_tpu's kernel cannot take one either); any other factory's is
    # generated (tests/test_torch_fused_models.py)
    with pytest.raises(NotImplementedError, match="no analytic jac"):
        _call(factory=lambda p: dataclasses.replace(troberts(p), jac=None))


def _spgmr_call(factory):
    params, yy0, yp0 = _inputs(B)
    opts = IdaOptions(linear_solver="spgmr")
    st = ensemble_init(troberts, params, yy0, yp0, device="cpu", opts=opts)
    return make_fused_solve(factory, tol_sv(1e-4, ATOL, device="cpu"), opts)(st, params, 0.4)


def test_raises_on_a_factory_with_its_own_jtimes_under_spgmr():
    # the Krylov path would call a factory's own Jacobian-times-vector, which
    # the kernel does not compile in: refused on either device, naming the
    # ROADMAP item that lifts it; the direct solvers never call it
    def factory(p):
        prob = troberts(p)
        return dataclasses.replace(prob, jtimes_fn=lambda jdata, t, cj, yy, yp, v: prob.jtimes(
            t, cj, yy, yp, v))

    with pytest.raises(NotImplementedError, match="jtimes_fn.*ROADMAP.md.* item 22"):
        _spgmr_call(factory)
    params, yy0, yp0 = _inputs(B)
    st = ensemble_init(troberts, params, yy0, yp0, device="cpu")
    got = make_fused_solve(factory, tol_sv(1e-4, ATOL, device="cpu"))(st, params, 0.4)
    assert bool((got[2] == C.SUCCESS).all())


def test_raises_on_a_preconditioned_factory_under_spgmr():
    # likewise a preconditioner (prec_setup/prec_solve/prec_zero)
    def factory(p):
        return dataclasses.replace(
            troberts(p), prec_setup=lambda t, cj, yy, yp, rr: (cj,),
            prec_solve=lambda pdata, r, cj: r, prec_zero=lambda: (torch.zeros(()),))

    with pytest.raises(NotImplementedError, match="preconditioner.*ROADMAP.md.* item 22"):
        _spgmr_call(factory)


def test_raises_on_rootfinding():
    with pytest.raises(NotImplementedError, match="nroots"):
        _call(factory=_with_roots)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_raises_on_a_dtype_the_kernel_does_not_take(dtype):
    with pytest.raises(TypeError):
        _call(dtype=dtype)


def test_raises_on_a_device_neither_cpu_nor_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        _call(device="meta")


def test_raises_on_a_budget_below_one():
    with pytest.raises(ValueError):
        make_fused_solve(troberts, tol_sv(1e-4, ATOL, device="cpu"), attempt_budget=0)


def test_stage_list_matches_the_stage_kernels_of_the_source():
    exported = set(re.findall(r"^IDA_STAGE_BOTH\((\w+),", CU.read_text(), re.M))
    assert exported == set(fused_stages.STAGES)
    assert set(fused_stages.STAGE_LAUNCHES) == set(fused_stages.STAGES)


def test_state_fields_match_the_kernels_pointer_table():
    src = (CU.parent / "ida_lane.cuh").read_text()
    block = re.search(r"#define IDA_STATE_FIELDS\(X\)(.*?)\n\n", src, re.S).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", block)) == fused_solve.STATE_FIELDS
    assert set(fused_solve.STATE_FIELDS) <= set(IdaState._fields)
    # the refined mode's lsetup point, last; [B, 0] ls_yy/ls_yp outside it
    assert fused_solve.STATE_FIELDS[-4:] == ("ls_tn", "ls_cj", "ls_yy", "ls_yp")
    assert ctypes.sizeof(fused_solve.StateRefs) == 8 * len(fused_solve.STATE_FIELDS)
    for ls, lu in (("full", torch.float64), ("single", torch.float32), ("refined", torch.float32)):
        opts = IdaOptions(ls_precision=ls)
        st = ensemble_init(troberts, *_inputs(2), device="cpu", opts=opts)
        assert st.lu.dtype == fused_solve._expected_dtype("lu", torch.float64, opts) == lu
        assert st.ls_yy.shape == ((2, 3) if ls == "refined" else (2, 0))


@pytest.mark.parametrize("stage", sorted(fused_stages.STAGES))
def test_stage_plain_version_runs_and_returns_every_slot(stage):
    params, yy0, yp0 = _inputs(3)
    st = to_native(ensemble_init(troberts, params, yy0, yp0, device="cpu"))
    p = torch.from_numpy(params.T).contiguous()
    tol = tol_sv(1e-4, ATOL, device="cpu")
    if stage != "prologue":
        st, _ = fused_stages.run_stage("prologue", st, p, tol, 0.4)
    out_st, out = fused_stages.run_stage(stage, st, p, tol, 0.4)
    spec = fused_stages.STAGES[stage]
    assert set(out) == set(spec.floats) | set(spec.ints)
    assert all(v.shape == (3,) for v in out.values())
    assert out_st.phi.shape == st.phi.shape


def test_attempt_stage_is_one_loop_attempt_of_the_solve():
    # after the prologue, an attempt (fresh step) then its completion gives
    # the state of a one-attempt budgeted solve
    params, yy0, yp0 = _inputs(3)
    st = to_native(ensemble_init(troberts, params, yy0, yp0, device="cpu"))
    p = torch.from_numpy(params.T).contiguous()
    tol = tol_sv(1e-4, ATOL, device="cpu")
    ref, _, _, _ = tsolve(st, troberts(p), IdaOptions(), TolControl(
        torch.full((3,), 1e-4, dtype=torch.float64),
        torch.tensor(ATOL, dtype=torch.float64)[:, None].expand(3, 3)), 0.4, max_attempts=1)
    s1, o1 = fused_stages.run_stage("prologue", st, p, tol, 0.4)
    s1 = s1._replace(kk=torch.ones_like(s1.kk), psi=torch.where(
        torch.arange(6)[:, None] == 0, s1.hh, s1.psi), cj=1.0 / s1.hh)
    s2, o2 = fused_stages.run_stage("attempt", s1, p, tol, 0.4, {"saved_t": s1.tn})
    assert torch.equal(o2["success"].bool(), torch.ones(3, dtype=torch.bool))
    s3, _ = fused_stages.run_stage("complete_step", s2, p, tol, 0.4,
                                   {"err_k": o2["err_k"], "err_km1": o2["err_km1"], "ck": o2["ck"]})
    for f in ("phi", "psi", "hh", "kk", "nst", "nni", "nre"):
        assert torch.equal(getattr(s3, f), getattr(ref, f)), f


def test_the_kernel_is_one_translation_unit_with_inlined_pow():
    # no source is compiled apart for pow; the solve is built with nvcc's
    # default contraction and rounds through csrc/rounded.cuh; every device
    # function is inlined into its kernel
    csrc = CU.parent
    assert not (csrc / "torch_pow.cu").exists()
    assert fused_solve.BUILD_FLAGS == ("-fmad=true",)
    lane = (csrc / "ida_lane.cuh").read_text()
    assert "torch_pow" not in lane + CU.read_text()
    assert "__noinline__" not in lane + CU.read_text()
    assert "::pow(" in (csrc / "rounded.cuh").read_text()
    assert '#include "rounded.cuh"' in (csrc / "small_lu.cuh").read_text()


@pytest.mark.parametrize("made,run", [("full", "single"), ("single", "refined"),
                                      ("refined", "full")])
def test_a_state_made_for_another_mode_is_refused(made, run):
    # the lu dtype and the refined mode's lsetup point follow the options
    # the state was made with; the kernel would write ls_yy past a [B, 0]
    # field, so the entry point checks the layout on either device
    params, yy0, yp0 = _inputs(2)
    st = ensemble_init(troberts, params, yy0, yp0, device="cpu",
                       opts=IdaOptions(ls_precision=made))
    fn = make_fused_solve(troberts, tol_sv(1e-4, ATOL, device="cpu"),
                          IdaOptions(ls_precision=run))
    with pytest.raises(ValueError, match="ensemble_init"):
        fn(st, params, 0.4)


def test_solve_args_mirror_the_kernels_argument_struct():
    block = re.search(r"struct IdaSolveArgs \{(.*?)\};", CU.read_text(), re.S).group(1)
    names = re.findall(r"(\w+)(?:, (\w+))?;", block)
    flat = [n for pair in names for n in pair if n]
    assert flat == ["in", "out", "params", "tol", "carry", "opts", "B", "budget"]
    assert [f for f, _ in fused_solve.SolveArgs._fields_] == [
        "src", "dst", "params", "tol", "carry", "opts", "B", "budget"]
    lane = (CU.parent / "ida_lane.cuh").read_text()
    assert f"constexpr int MAXN = {fused_solve.MAXN};" in lane
    assert [f for f, _ in fused_solve.TolArgs._fields_] == [
        "rtol", "atol", "tout", "rtol_lanes", "atol_lanes"]
    assert ctypes.sizeof(fused_solve.TolArgs) == 8 * (fused_solve.MAXN + 4)
    # the two pointer tables, with the four lsetup-point fields each
    assert fused_solve.SolveArgs.dst.offset == ctypes.sizeof(fused_solve.StateRefs)
    # the modes: the macros the source reads, and its ls_precision codes
    src = CU.read_text()
    assert "#define IDA_FAST_MATH 0" in src and "#define IDA_LS_PRECISION 0" in src
    assert "constexpr int LS_FULL = 0, LS_SINGLE = 1, LS_REFINED = 2;" in lane
    assert fused_solve.LS_CODES == {"full": 0, "single": 1, "refined": 2}
    assert fused_solve.mode_flags() == ()
    assert fused_solve.mode_flags(True, "refined") == ("-DIDA_FAST_MATH=1",
                                                       "-DIDA_LS_PRECISION=2")


@pytest.mark.parametrize("form", ["scalar", "vector", "per-lane-rtol", "per-lane-atol"])
def test_tolerances_travel_by_value_unless_per_lane(form):
    cpu, f64 = torch.device("cpu"), torch.float64
    rtol = torch.tensor(1e-4, dtype=f64)
    atol = torch.tensor(ATOL, dtype=f64)
    if form == "scalar":
        t = fused_solve.tol_inputs(TolControl(rtol, torch.tensor(1e-6, dtype=f64)), 3, 5, f64, cpu)
        assert (t.rtol, t.atol, t.rtol_lanes) == (1e-4, (1e-6,) * 3, None)
    elif form == "vector":
        t = fused_solve.tol_inputs(TolControl(rtol.float(), atol), 3, 5, f64, cpu)
        assert t.rtol == float(np.float32(1e-4)) and t.atol == tuple(ATOL) and t.atol_lanes is None
    else:
        lanes = TolControl(rtol.expand(5), atol) if form == "per-lane-rtol" else TolControl(
            rtol, atol.expand(5, 3))
        t = fused_solve.tol_inputs(lanes, 3, 5, f64, cpu)
        assert t.rtol is None and t.rtol_lanes.shape == (5,) and t.atol_lanes.shape == (5, 3)
        assert t.rtol_lanes.is_contiguous() and t.atol_lanes.is_contiguous()
    with pytest.raises(ValueError, match="tol must be"):
        fused_solve.tol_inputs(TolControl(rtol, atol[:2]), 3, 5, f64, cpu)


@pytest.mark.parametrize("ls_precision", ["full", "single", "refined"])
def test_result_allocation_covers_the_touched_fields_only(ls_precision):
    # the lsetup point (ls_tn, ls_cj, ls_yy, ls_yp) is the kernel's only
    # under "refined"; in the other modes it passes through
    opts = IdaOptions(ls_precision=ls_precision)
    st = ensemble_init(troberts, *_inputs(2), device="cpu", opts=opts)
    out = fused_solve.empty_result(st, opts, fused_solve.ROBERTS)
    touched = fused_solve.touched_fields(opts, fused_solve.ROBERTS)
    assert set(fused_solve.LS_FIELDS) <= set(touched) if ls_precision == "refined" else (
        not set(fused_solve.LS_FIELDS) & set(touched))
    for f, x in zip(st._fields, st):
        if isinstance(x, torch.Tensor):
            y = getattr(out, f)
            assert (y is x) == (f not in touched), f
            assert (y.shape, y.dtype, y.device) == (x.shape, x.dtype, x.device), f


@pytest.mark.parametrize("entry", ["ensemble_init", "init_state", "tol_ss", "tol_sv"])
def test_entry_points_name_the_card_by_default(entry):
    # device=None is the current CUDA device; without one the entry point
    # raises, it never carries on on the CPU
    params, yy0, yp0 = _inputs(2)
    calls = {
        "ensemble_init": lambda **kw: ensemble_init(troberts, params, yy0, yp0, **kw).phi,
        "init_state": lambda **kw: init_state(
            troberts(torch.as_tensor(params[0])), yy0[0], yp0[0], **kw).phi,
        "tol_ss": lambda **kw: tol_ss(1e-4, 1e-6, **kw).atol,
        "tol_sv": lambda **kw: tol_sv(1e-4, ATOL, **kw).atol,
    }
    assert calls[entry](device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert calls[entry]().is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()
