"""The mixed-precision modes of the port against ``ida_tpu``
(tests/test_mixed_precision.py, tests/test_band_ls.py): ``ls_precision``
"single" (the Jacobian, the LU or band factor and solve, or the whole Krylov
iteration in float32) and "refined" (the dense factor stored in float32,
each solve refined once against the Jacobian applied as a jvp of the
residual), and ``krylov_storage="bfloat16"``.

* Roberts against ``ida_tpu`` run op by op (``jax.disable_jit``), one lane
  through ``IDA`` and B = 4 lanes batch-native: every counter exactly and
  the states bit for bit (the JAX runs pinned: ``mixed_modes_op_by_op``).
  Jitted, XLA:CPU contracts multiply-adds into FMAs; in these modes that
  moves step counts over 12 decades (``ida_tpu``
  jitted: "single" 437 steps, op by op 433, the port 433), so the 12-decade
  runs are held to ``ida_tpu``'s own acceptance gates and to the jitted run
  within the integration tolerance.
* heat2d 5 x 5 (N = 25: ``sum0`` adds as ``ida_tpu``'s sequential order)
  through the Krylov and band paths against the jitted ``ida_tpu``.
* The modes round-trip through checkpoints both ways, and differentiate in
  reverse and forward mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu as jida
import ida_tpu_torch as port
from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.models import roberts_factory as jax_roberts_factory
from ida_tpu.models import roberts_problem as jax_roberts
from ida_tpu.models.heat2d import heat2d_problem as jax_heat2d
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu_torch import IdaOptions, IdaSolveStatus
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.models import (
    ROBERTS_PARAMS,
    ROBERTS_YP0,
    ROBERTS_YY0,
    heat2d_ic,
    heat2d_problem,
    roberts_factory,
    roberts_problem,
)
from ida_tpu_torch.parallel import ensemble_init, to_native
from ida_tpu_torch.sensitivity import adjoint_gradient
from ida_tpu_torch.tol_control import TolControl, tol_sv
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

RTOL = 1e-4
ATOL = [1e-8, 1e-6, 1e-6]
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn", "nsetups")
CANONICAL_NST = [29, 43, 68, 95, 126, 161, 202, 250, 293, 325, 348, 362]
CHECK_ANS = np.array([5.2083474251394888e-08, 2.0833390772616859e-13, 9.9999994791631752e-01])
OBO_DECADES = 1  # op-by-op JAX costs ~0.3 s an attempt: 29 steps
HEAT_M = 5
HEAT_TOUTS = (0.01, 0.04, 0.16)


def _port_ida(mode, with_roots=False):
    return port.IDA(roberts_problem(with_roots=with_roots, device="cpu"), ROBERTS_YY0,
                    ROBERTS_YP0, tol_sv(RTOL, ATOL, device="cpu"),
                    IdaOptions(ls_precision=mode), device="cpu")


def _jax_ida(mode, with_roots=False):
    return jida.IDA(jax_roberts(with_roots=with_roots), ROBERTS_YY0, ROBERTS_YP0,
                    jida.tol_sv(RTOL, jnp.asarray(ATOL)),
                    options=jida.IdaOptions(ls_precision=mode))


def _decades(ida, n, jax_side=False):
    nst, t = [], 0.4
    for _ in range(n):
        tret, status = ida.solve(t)
        assert status == (jida.IdaSolveStatus.Success if jax_side else IdaSolveStatus.Success)
        nst.append(int(ida.get_num_steps()))
        t *= 10.0
    return nst


def _counters(st) -> dict:
    return {k: np.asarray(getattr(st, k)).tolist() for k in COUNTERS}


# ------------------------------------------ dense modes, op by op, exact


DENSE_FIELDS = ("yy", "yp", "phi", "lu", "piv", "ls_yy", "ls_yp", "ls_tn", "ls_cj", "hh")
ENSEMBLE_B = 4


def _ensemble_inputs(b=ENSEMBLE_B):
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, b)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


def _jax_dense_op_by_op(mode):
    """ida_tpu's IDA over OBO_DECADES, op by op: steps a decade, counters
    and the fields DENSE_FIELDS of the state."""
    jax_ida = _jax_ida(mode)
    with jax.disable_jit():
        jax_nst = _decades(jax_ida, OBO_DECADES, jax_side=True)
    return {"nst": jax_nst, "counters": _counters(jax_ida.state),
            "state": {f: np.asarray(getattr(jax_ida.state, f)) for f in DENSE_FIELDS}}


def _jax_ensemble_op_by_op(mode):
    """ida_tpu's batch-native core_solve of ENSEMBLE_B lanes to 0.4, op by op."""
    params, yy0, yp0 = _ensemble_inputs()
    b = ENSEMBLE_B
    jopts = JOptions(ls_precision=mode)
    jst = jensemble_init(jax_roberts_factory, jnp.asarray(params), jnp.asarray(yy0),
                         jnp.asarray(yp0), opts=jopts)
    jst = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), jst)
    jtol = JTol(jnp.full((b,), 1e-4), jnp.tile(jnp.asarray(ATOL)[:, None], (1, b)))
    with jax.disable_jit():
        jst, jtret, jist = jsolve(jst, jax_roberts_factory(jnp.asarray(params.T)), jopts, jtol,
                                  jnp.asarray(0.4))
    return {"istate": np.asarray(jist), "tret": np.asarray(jtret), "counters": _counters(jst),
            "state": {f: np.asarray(getattr(jst, f)) for f in ("yy", "lu", "ls_yy")}}


# what the pinned op-by-op references (jax_modes_op_by_op_live) are made from
OBO_REF_INPUTS = {"yy0": ROBERTS_YY0, "yp0": ROBERTS_YP0, "rtol": RTOL, "atol": ATOL,
                  "decades": OBO_DECADES, "ensemble": _ensemble_inputs()}


def jax_modes_op_by_op_live():
    return {mode: {"dense": _jax_dense_op_by_op(mode), "ensemble": _jax_ensemble_op_by_op(mode)}
            for mode in ("single", "refined")}


@pytest.fixture(scope="module")
def obo_refs():
    """The op-by-op JAX runs, pinned (tests/make_torch_refs.py,
    ``mixed_modes_op_by_op``)."""
    return load("mixed_modes_op_by_op", OBO_REF_INPUTS)


@pytest.mark.parametrize("mode", ["single", "refined"])
def test_dense_mode_is_ida_tpus_op_by_op(mode, obo_refs):
    ref = obo_refs[mode]["dense"]
    ida = _port_ida(mode)
    assert _decades(ida, OBO_DECADES) == ref["nst"]
    assert _counters(ida.state) == ref["counters"]
    for f in DENSE_FIELDS:
        got, want = getattr(ida.state, f).numpy(), ref["state"][f]
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert ida.state.lu.dtype == torch.float32
    assert tuple(ida.state.ls_yy.shape) == ((3,) if mode == "refined" else (0,))


@pytest.mark.parametrize("mode", ["single", "refined"])
def test_ensemble_mode_is_ida_tpus_op_by_op(mode, obo_refs):
    # B = 4 lanes of roberts_factory, whose float64 rate constants promote
    # the "single" Jacobian to float64 before its trailing cast
    ref = obo_refs[mode]["ensemble"]
    b = ENSEMBLE_B
    params, yy0, yp0 = _ensemble_inputs()
    opts = IdaOptions(ls_precision=mode)
    st = to_native(ensemble_init(roberts_factory, params, yy0, yp0, device="cpu", opts=opts))
    tol = TolControl(torch.full((b,), 1e-4, dtype=torch.float64),
                     torch.tensor(ATOL, dtype=torch.float64)[:, None].expand(3, b))
    st, tret, ist = tsolve(st, roberts_factory(torch.from_numpy(params.T.copy())), opts, tol, 0.4)
    assert ist.tolist() == ref["istate"].tolist() == [C.SUCCESS] * b
    assert np.array_equal(tret.numpy(), ref["tret"])
    assert _counters(st) == ref["counters"]
    for f in ("yy", "lu", "ls_yy"):
        got, want = getattr(st, f).numpy(), ref["state"][f]
        assert got.dtype == want.dtype and np.array_equal(got, want), f


# ------------------------- 12 decades with roots: ida_tpu's acceptance


def _run_roberts(ida, jax_side=False):
    ok = jida.IdaSolveStatus if jax_side else IdaSolveStatus
    roots, outputs = [], []
    iout, tout = 0, 0.4
    while iout < 12:
        tret, status = ida.solve(tout)
        if status == ok.Root:
            roots.append((float(tret), tuple(int(r) for r in ida.get_root_info())))
        elif status == ok.Success:
            outputs.append((float(tret), np.asarray(ida.get_yy()).copy()))
            iout += 1
            tout *= 10.0
        else:
            raise AssertionError(f"unexpected status {status}")
    return ida, roots, outputs


@pytest.fixture(scope="module")
def roberts12():
    """The port's "full", "single" and "refined" runs and ida_tpu's jitted
    "single" and "refined" runs (:func:`jax_roberts12_live`, pinned by
    tests/make_torch_refs.py), 12 decades with roots."""
    runs = {m: _run_roberts(_port_ida(m, with_roots=True)) for m in ("full", "single", "refined")}
    return {**runs, **load("mixed_roberts12_jax", REF_INPUTS)}


# what the pinned reference (jax_roberts12_live) is computed from: the runs
# of _jax_ida and _run_roberts, which the port's runs share
REF_INPUTS = {"yy0": ROBERTS_YY0, "yp0": ROBERTS_YP0, "rtol": RTOL, "atol": ATOL,
              "modes": ("single", "refined"), "with_roots": True}


def jax_roberts12_live():
    """ida_tpu's jitted "single" and "refined" runs, 12 decades with roots:
    {"jax_<mode>": (steps, roots, outputs)}."""
    runs = {}
    for m in ("single", "refined"):
        ida, roots, outputs = _run_roberts(_jax_ida(m, with_roots=True), jax_side=True)
        runs["jax_" + m] = (int(ida.get_num_steps()), roots, outputs)
    return runs


def _wrms(y, ref):
    ewt = 1.0 / (1e-4 * np.abs(ref) + 10.0 * np.array(ATOL))
    return float(np.sqrt(np.mean((ewt * (y - ref)) ** 2)))


@pytest.mark.parametrize("kw", [dict(linear_solver="spgmr"), dict(linear_solver="band")],
                         ids=["spgmr", "band"])
def test_refined_requires_dense(kw):
    with pytest.raises(ValueError, match="dense"):
        IdaOptions(ls_precision="refined", **kw)


# ------------------------------------------------ heat2d: Krylov, band


def _heat_opts(**kw):
    return dict(linear_solver="spgmr", mxstep=5000, **kw)


def _heat(pkg, problem, opts, **dev):
    u0, up0 = heat2d_ic(HEAT_M)
    ida = pkg.IDA(problem, u0, up0, pkg.tol_ss(1e-5, 1e-8, **dev), pkg.IdaOptions(**opts), **dev)
    out = []
    for t in HEAT_TOUTS:
        tret, status = ida.solve(t)
        assert status.name == "Success"
        out.append(np.asarray(ida.get_yy()).copy())
    return ida, out


HEAT_CASES = {
    "full": _heat_opts(),
    "single": _heat_opts(ls_precision="single"),
    "single_bf16": _heat_opts(ls_precision="single", krylov_storage="bfloat16"),
    "single_compute": _heat_opts(ls_precision="single", krylov_storage="compute"),
    "band_full": dict(linear_solver="band", band_mu=HEAT_M, band_ml=HEAT_M),
    "band_single": dict(linear_solver="band", band_mu=HEAT_M, band_ml=HEAT_M,
                        ls_precision="single"),
}


def _stats(ida):
    return {k: int(getattr(ida, "get_num_" + k)()) for k in
            ("steps", "lin_iters", "prec_solves", "nonlin_solv_conv_fails", "jac_evals",
             "res_evals")}


HEAT_JAX_CASES = ("single", "single_bf16")
# what the pinned jitted runs (jax_heat_live) are computed from
HEAT_REF_INPUTS = {"m": HEAT_M, "touts": HEAT_TOUTS, "cases": {k: HEAT_CASES[k]
                                                             for k in HEAT_JAX_CASES}}


def jax_heat_live():
    """ida_tpu's jitted runs of the mixed heat2d cases: counters and states."""
    out = {}
    for k in HEAT_JAX_CASES:
        jax_ida, jout = _heat(jida, jax_heat2d(HEAT_M), HEAT_CASES[k])
        out[k] = {"stats": _stats(jax_ida), "out": jout}
    return out


@pytest.fixture(scope="module")
def heat_runs():
    """Each case through the port, and ida_tpu's jitted runs of the mixed
    ones (pinned: tests/make_torch_refs.py, ``mixed_heat2d_jax``)."""
    runs = {k: _heat(port, heat2d_problem(HEAT_M, device="cpu"), o, device="cpu")
            for k, o in HEAT_CASES.items()}
    runs.update({"jax_" + k: v for k, v in load("mixed_heat2d_jax", HEAT_REF_INPUTS).items()})
    return runs


@pytest.mark.parametrize("case", ["single", "single_bf16"])
def test_heat2d_mode_matches_ida_tpu(heat_runs, case):
    # the same counters as ida_tpu's jitted run, and states within 1e-6 of
    # max |u| (float32 Krylov corrections; FMA contraction moves their
    # last bits)
    ida, out = heat_runs[case]
    ref = heat_runs["jax_" + case]
    assert _stats(ida) == ref["stats"]
    for u, ju in zip(out, ref["out"]):
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-6 * np.abs(ju).max())


def test_heat2d_spgmr_single_vs_full(heat_runs):
    # the float32 Krylov iteration inside the float64 Newton loop gives the
    # full-precision trajectory well inside rtol 1e-5
    ida_f, out_f = heat_runs["full"]
    ida_s, out_s = heat_runs["single"]
    for uf, us in zip(out_f, out_s):
        np.testing.assert_allclose(us, uf, atol=2e-5)
    assert ida_s.get_num_lin_iters() > 0 and ida_s.get_num_prec_solves() > 0
    assert ida_s.get_num_steps() <= 2 * ida_f.get_num_steps()
    assert ida_s.get_num_nonlin_solv_conv_fails() <= 5


def test_heat2d_spgmr_bf16_basis_storage(heat_runs):
    # a bfloat16 basis keeps GMRES convergent enough for the same
    # trajectory inside the tolerance; "compute" storage is "single" exactly
    ida_f, out_f = heat_runs["full"]
    ida_h, out_h = heat_runs["single_bf16"]
    for uf, uh in zip(out_f, out_h):
        np.testing.assert_allclose(uh, uf, atol=5e-5)
    assert ida_h.get_num_steps() <= 2 * ida_f.get_num_steps()
    assert ida_h.get_num_nonlin_solv_conv_fails() <= 10
    ida_s, out_s = heat_runs["single"]
    ida_c, out_c = heat_runs["single_compute"]
    assert _stats(ida_c) == _stats(ida_s)
    for us, uc in zip(out_s, out_c):
        np.testing.assert_array_equal(uc, us)


def test_band_single_vs_full(heat_runs):
    # tests/test_band_ls.py::test_band_ls_mixed_precision: the float32 band
    # factor and solve keep the trajectory; the factor is stored float32
    ida_f, out_f = heat_runs["band_full"]
    ida_s, out_s = heat_runs["band_single"]
    for uf, us in zip(out_f, out_s):
        np.testing.assert_allclose(us, uf, atol=2e-5)
    assert ida_s.state.lu.dtype == torch.float32 and ida_f.state.lu.dtype == torch.float64


def test_spgmr_storage_dtype_rounds_the_basis():
    # spgmr_solve(storage_dtype=bfloat16) on a small diagonal system: the
    # solution to the tolerance, and another one than the float64 basis's
    from ida_tpu_torch.ops.spgmr import spgmr_solve

    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.uniform(1.0, 3.0, size=(12, 2)))
    b = torch.from_numpy(rng.normal(size=(12, 2)))
    tol = torch.tensor(1e-6, dtype=torch.float64)
    full = spgmr_solve(lambda v: d * v, b, tol, maxl=12)
    bf16 = spgmr_solve(lambda v: d * v, b, tol, maxl=12, storage_dtype=torch.bfloat16)
    assert bool(full.converged.all()) and bool(bf16.converged.all())
    assert bf16.x.dtype == torch.float64
    np.testing.assert_allclose(bf16.x.numpy(), (b / d).numpy(), rtol=1e-4, atol=1e-6)
    assert not torch.equal(bf16.x, full.x)


# ------------------------------------------- checkpoints and derivatives


def _adjoint(mode):
    return adjoint_gradient(
        roberts_factory, ROBERTS_PARAMS, lambda p: torch.tensor(ROBERTS_YY0),
        lambda p: p[0] * torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float64),
        tol_sv(1e-4, ATOL, device="cpu"), 0.4, lambda y: y.sum() + y[1] * 1e4,
        opts=IdaOptions(ls_precision=mode, unroll_newton=True), max_attempts=60, device="cpu")


FWD_V = np.array([1.0, 0.0, 0.0])
FWD_REF_INPUTS = {"params": ROBERTS_PARAMS, "yy0": ROBERTS_YY0, "rtol": 1e-4, "atol": ATOL,
                  "tout": 0.4, "tangent": FWD_V, "ls_precision": "refined"}


def jax_forward_refined_live():
    """``ida_tpu``'s forward sensitivity under "refined" (jitted, ~20 s)."""
    from ida_tpu import sensitivity as jsens

    jy, jdy = jsens.forward_sensitivity(
        jax_roberts_factory, jnp.asarray(ROBERTS_PARAMS), lambda p: jnp.asarray(ROBERTS_YY0),
        lambda p: p[0] * jnp.array([-1.0, 1.0, 0.0]), jida.tol_sv(1e-4, jnp.asarray(ATOL)), 0.4,
        jnp.asarray(FWD_V), JOptions(ls_precision="refined"))
    return {"y": np.asarray(jy), "dy": np.asarray(jdy)}


@pytest.mark.parametrize("kw", [dict(ls_precision="double"), dict(krylov_storage="float16"),
                                dict(ls_precision="Single")], ids=lambda k: str(k))
def test_unknown_mode_strings_raise(kw):
    with pytest.raises(ValueError):
        IdaOptions(**kw)


def test_state_sizes_follow_the_mode():
    prob = roberts_problem(device="cpu")
    for mode, lu_dt, n_ls in (("full", torch.float64, 0), ("single", torch.float32, 0),
                              ("refined", torch.float32, 3)):
        st = port.init_state(prob, ROBERTS_YY0, ROBERTS_YP0, device="cpu",
                             opts=IdaOptions(ls_precision=mode))
        assert st.lu.dtype == lu_dt and tuple(st.ls_yy.shape) == (n_ls,), mode
        assert st.phi.dtype == torch.float64
    st = port.init_state(prob, ROBERTS_YY0, ROBERTS_YP0, device="cpu",
                         opts=IdaOptions(linear_solver="spgmr", ls_precision="single"))
    assert tuple(st.lu.shape) == (0, 0) and st.lu.dtype == torch.float64
