"""Quadratures in the whole-solve kernel (K2-K4), on the CPU.

``ida_tpu``'s fused Pallas kernel runs the whole ``core_solve`` of a factory
with quadratures, ``yQ`` included; so does the port's ``make_fused_solve``,
whose kernel integrates the generated ``quad`` after every accepted step
(``csrc/ida_lane.cuh`` ``accumulate_quad``, in ``core/quad.py``'s order of
operations). Here, with the kernel source built for the host
(tests/test_torch_fused_host.py ``host_build``):

* the quadrature Roberts (quadratures [y1 + y2 + y3, y1], B = 8 to tout
  400) and Morris-Lecar (``models/morris_lecar.py``: tanh and cosh in its
  residual, the calcium charge and int V dt as quadratures, B = 8 to 10 ms)
  are bit for bit the eager ``core.solve`` in every field, ``yQ``
  included, in parity, with a budget of 6 attempts a launch and under
  ``ls_precision="refined"``;
* the port's plain version (the eager solve behind ``make_fused_solve`` on
  CPU tensors) meets ``ida_tpu``'s ``make_fused_solve(..., tile=4,
  interpret=True)``, f32, B = 8: statuses and ``tret`` equal, ``yy`` and
  ``yQ`` (through ``get_quad`` at ``tret``) at rtol 2e-2 / atol 1e-6; and
  ``ida_tpu``'s ``core_solve`` run op by
  op in f64: Roberts with ``quad = y1`` to 0.4 bit for bit (every counter,
  y and yQ),
  Morris-Lecar (its twin written in ``jax.numpy`` from the same code) within
  the tolerance, where only ``tanh``/``cosh``'s last bits differ (XLA's
  against the C library's). The JAX runs are pinned
  (tests/make_torch_refs.py, ``fused_quad_jax``);
* the nominal Morris-Lecar lane's distance from an rtol 1e-10 solve, which
  ``chip_smoke.py`` holds at ``ML_CHECK_SCALE`` times the run's
  tolerances, is the method's: ``ida_tpu``'s jitted rtol 1e-6 solve reads
  it against its rtol 1e-10 solve (pinned), and the port's lane, within WRMS
  1e-3 of ``ida_tpu``'s, reads it to 0.1%;
* the entry's pointer table carries ``yQ`` for a model with quadratures only.

The card's build is held against the eager path on the card by
``chip_smoke.py``'s ``fused_quad_ops`` phase and the ``cuda`` tests.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (ML_ATOL, ML_CHECK_SCALE, ML_REF_TOL, ML_RTOL, ML_TOUT,
                         quad_factory)
from ida_tpu.core.quad import get_quad as jget_quad
from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.models import roberts_factory as jroberts_factory
from ida_tpu.ops.fused_solve import make_fused_solve as jmake_fused_solve
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.problem import IdaProblem as JProblem
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu.tol_control import tol_ss as jtol_ss
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.quad import get_quad
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.models.morris_lecar import (morris_lecar_equations, morris_lecar_factory,
                                               morris_lecar_inputs)
from ida_tpu_torch.ops import fused_solve
from ida_tpu_torch.parallel import ensemble_init, to_native
from ida_tpu_torch.tol_control import tol_ss, tol_sv
from make_torch_refs import load
from test_torch_fused_models import SOLVES, _differ, _kernel_solve, on_host  # noqa: F401
from test_torch_fused_models import host_build, roberts_inputs

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

B = 8
RTOL_F32, ATOL_F32 = 1e-4, 1e-6  # the f32 interpret-mode runs
JAX_TOUT = {"roberts_quad": 0.4, "morris_lecar": 2.0}  # the interpret-mode kernel's horizon


def jquad_factory(params):
    return dataclasses.replace(
        jroberts_factory(params),
        quad=lambda t, yy, yp: jnp.stack([yy[0] + yy[1] + yy[2], yy[0]]), nquad=2)


def quad_y1_factory(params):
    return dataclasses.replace(roberts_factory(params),
                               quad=lambda t, yy, yp: yy[:1], nquad=1)


def jquad_y1_factory(params):
    return dataclasses.replace(jroberts_factory(params),
                               quad=lambda t, yy, yp: yy[:1], nquad=1)


def jmorris_lecar_factory(params):
    res, jac, quad = morris_lecar_equations(params[0], jnp.stack, jnp.tanh, jnp.cosh, jnp.sinh)
    return JProblem(n=2, res=res, jac=jac, quad=quad, nquad=2)


# name -> (factory, its JAX twin, inputs, tolerance (rtol, atol), tout)
MODELS = {
    "roberts_quad": (quad_factory, jquad_factory, roberts_inputs, (1e-4, [1e-8, 1e-6, 1e-6]),
                     400.0),
    "morris_lecar": (morris_lecar_factory, jmorris_lecar_factory, morris_lecar_inputs,
                     (1e-6, 1e-8), ML_TOUT),
}


def _tol(rtol, atol, **kw):
    return tol_ss(rtol, atol, **kw) if np.ndim(atol) == 0 else tol_sv(rtol, atol, **kw)


@pytest.mark.parametrize("name", MODELS)
def test_host_build_with_quadratures_is_bitwise_the_eager_solve(on_host, name):
    # f64, B = 8 to the model's tout: the generated model's kernel against
    # make_fused_solve's plain version (the eager core.solve, with the same
    # budgeted host loop) in each of parity, budget 6 and "refined": every
    # field, yQ among them
    factory, _, inputs, (rtol, atol), tout = MODELS[name]
    params, yy0, yp0 = inputs(B)
    tol = _tol(rtol, atol, device="cpu")
    for solve, (opts, budget) in SOLVES.items():
        st0 = ensemble_init(factory, params, yy0, yp0, device="cpu", opts=opts)
        fused_solve.reset_launch_counts()
        model, got = _kernel_solve(factory, st0, params, tol, tout, opts, budget)
        ref = fused_solve.make_fused_solve(factory, tol, opts, attempt_budget=budget)(
            st0, params, tout)
        assert model.nq == 2 and tuple(got[0].yQ.shape) == (B, 2), solve
        assert _differ(got[0], ref[0]) == [], solve
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]), solve
        assert bool((ref[2] == C.SUCCESS).all()) and int(ref[0].nst.min()) > 15, solve
        assert not torch.equal(got[0].yQ, st0.yQ), solve
        kinds = {"init", "cont"} if budget else {"solve"}
        assert {(k, m) for k, _, m in fused_solve.MODE_LAUNCHES} == {
            (k, model.name) for k in kinds}, solve
    if name == "roberts_quad":
        # the integral of y1 + y2 + y3 = 1 is the time: yQ[0] = tn
        np.testing.assert_allclose(ref[0].yQ[:, 0].numpy(), ref[0].tn.numpy(), rtol=1e-9)


def _jax_fused(name):
    """ida_tpu's fused kernel (interpret mode, tile 4), f32, B = 8."""
    _, jfactory, inputs, _, _ = MODELS[name]
    params, yy0, yp0 = (jnp.asarray(a, jnp.float32) for a in inputs(B))
    states = jensemble_init(jfactory, params, yy0, yp0, dtype=jnp.float32)
    fused = jmake_fused_solve(jfactory, jtol_ss(RTOL_F32, ATOL_F32, dtype=jnp.float32), tile=4,
                              interpret=True)
    st, tret, ist = fused(states, params, JAX_TOUT[name])
    native = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), st)
    q = jget_quad(native, jfactory(params.T), tret)
    return {"nst": np.asarray(st.nst), "yy": np.asarray(st.yy), "yQ": np.asarray(st.yQ),
            "get_quad": np.asarray(q).T, "tret": np.asarray(tret), "istate": np.asarray(ist)}


def _jax_op_by_op(jfactory, inputs, rtol, atol, tout, b):
    """ida_tpu's batch-native core_solve run op by op (jax.disable_jit), f64."""
    params, yy0, yp0 = (jnp.asarray(a) for a in inputs(b))
    states = jensemble_init(jfactory, params, yy0, yp0)
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    n = yy0.shape[1]
    tol = JTol(jnp.full((b,), rtol), jnp.broadcast_to(jnp.asarray(atol, jnp.float64).reshape(
        (-1, 1)), (n, b)))
    with jax.disable_jit():
        st, tret, ist = jsolve(st, jfactory(params.T), JOptions(), tol, jnp.full((b,), tout))
    return {"nst": np.asarray(st.nst), "yy": np.asarray(st.yy), "yp": np.asarray(st.yp),
            "yQ": np.asarray(st.yQ), "tn": np.asarray(st.tn), "tret": np.asarray(tret),
            "istate": np.asarray(ist)}


# Roberts with quad = y1 to 0.4 (one decade) on the headline's nominal
# rates; Morris-Lecar's four lanes to 2 ms
OBO = {"roberts_y1": (quad_y1_factory, jquad_y1_factory, lambda b: roberts_inputs(b),
                      (1e-4, [1e-8, 1e-6, 1e-6]), 0.4, 2),
       "morris_lecar": (morris_lecar_factory, jmorris_lecar_factory, morris_lecar_inputs,
                        (1e-6, 1e-8), 2.0, 4)}

# the nominal Morris-Lecar lane (I = 100) to ML_TOUT at the run's tolerances
# and at chip_smoke.py's reference tolerance (rtol = atol = 1e-10)
ML_NOMINAL_TOLS = {"run": (ML_RTOL, ML_ATOL), "reference": (ML_REF_TOL, ML_REF_TOL)}

# what the pinned references (fused_quad_jax_live) are computed from
REF_INPUTS = {"b": B, "rtol_f32": RTOL_F32, "atol_f32": ATOL_F32, "tout": JAX_TOUT,
              "inputs": {k: MODELS[k][2](B) for k in MODELS},
              "op_by_op": {k: {"inputs": v[2](v[5]), "tol": v[3], "tout": v[4]}
                           for k, v in OBO.items()},
              "ml_nominal": {"inputs": morris_lecar_inputs(1), "tols": ML_NOMINAL_TOLS,
                             "tout": ML_TOUT}}


def _jax_ml_nominal(rtol, atol):
    """ida_tpu's jitted core_solve of the nominal Morris-Lecar lane to
    ML_TOUT, f64, no step limit: y and get_quad at tret."""
    params, yy0, yp0 = (jnp.asarray(a) for a in morris_lecar_inputs(1))
    states = jensemble_init(jmorris_lecar_factory, params, yy0, yp0)
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    tol = JTol(jnp.full((1,), rtol), jnp.full((2, 1), atol))
    prob = jmorris_lecar_factory(params.T)
    st, tret, ist = jax.jit(lambda s: jsolve(s, prob, JOptions(mxstep=1_000_000), tol,
                                             jnp.full((1,), ML_TOUT)))(st)
    return {"yy": np.asarray(st.yy[:, 0]), "get_quad": np.asarray(jget_quad(st, prob, tret)[:, 0]),
            "nst": np.asarray(st.nst[0]), "istate": np.asarray(ist[0])}


def fused_quad_jax_live():
    return {"fused": {name: _jax_fused(name) for name in MODELS},
            "op_by_op": {name: _jax_op_by_op(v[1], v[2], *v[3], v[4], v[5])
                         for name, v in OBO.items()},
            "ml_nominal": {k: _jax_ml_nominal(*tol) for k, tol in ML_NOMINAL_TOLS.items()}}


@pytest.fixture(scope="module")
def jax_refs():
    return load("fused_quad_jax", REF_INPUTS)


def test_plain_version_meets_ida_tpus_fused_kernel_with_quadratures(jax_refs):
    # f32, B = 8, tile 4: the port's make_fused_solve on CPU tensors (its
    # plain version) against ida_tpu's kernel in interpret mode
    for name, (factory, _, inputs, _, _) in MODELS.items():
        ref = jax_refs["fused"][name]
        params, yy0, yp0 = inputs(B)
        st0 = ensemble_init(factory, params, yy0, yp0, device="cpu", dtype=torch.float32)
        tol = tol_ss(RTOL_F32, ATOL_F32, device="cpu", dtype=torch.float32)
        st, tret, ist = fused_solve.make_fused_solve(factory, tol)(st0, params, JAX_TOUT[name])
        assert bool((ist == C.SUCCESS).all()), name
        np.testing.assert_array_equal(ist.numpy(), ref["istate"], err_msg=name)
        np.testing.assert_array_equal(tret.numpy(), ref["tret"], err_msg=name)
        np.testing.assert_allclose(st.yy.numpy(), ref["yy"], rtol=2e-2, atol=1e-6, err_msg=name)
        # yQ holds the integral to the last step's end tn, which the two
        # solves' step sequences put apart: compare it at tret (get_quad)
        q = get_quad(to_native(st), factory(torch.as_tensor(params.T, dtype=torch.float32)), tret)
        np.testing.assert_allclose(q.numpy().T, ref["get_quad"], rtol=2e-2, atol=1e-6,
                                   err_msg=name)
        assert (np.abs(st.nst.numpy() - ref["nst"]) <= 3).all(), name


def test_plain_version_is_ida_tpus_op_by_op_core_solve_with_quadratures(jax_refs):
    # f64: Roberts with quad = y1 bit for bit (every counter, y, yQ);
    # Morris-Lecar within the tolerance (XLA's tanh and cosh against the C
    # library's, the last bits apart)
    for name, (factory, _, inputs, (rtol, atol), tout, b) in OBO.items():
        ref = jax_refs["op_by_op"][name]
        params, yy0, yp0 = inputs(b)
        st0 = ensemble_init(factory, params, yy0, yp0, device="cpu")
        tol = _tol(rtol, atol, device="cpu")
        st, tret, ist = fused_solve.make_fused_solve(factory, tol)(st0, params, tout)
        got = {"nst": st.nst.numpy(), "yy": st.yy.numpy().T, "yQ": st.yQ.numpy().T,
               "tret": tret.numpy(), "istate": ist.numpy()}
        assert bool((ist == C.SUCCESS).all()), name
        np.testing.assert_array_equal(got["istate"], ref["istate"], err_msg=name)
        np.testing.assert_array_equal(got["tret"], ref["tret"], err_msg=name)
        if name == "roberts_y1":
            for k in ("nst", "yy", "yQ"):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert (np.abs(got["nst"] - ref["nst"]) <= 1).all()
            np.testing.assert_allclose(got["yy"], ref["yy"], rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(got["yQ"], ref["yQ"], rtol=1e-6, atol=1e-8)


def _wrms(y, ref, rtol, atol):
    """chip_smoke.py's WRMS of ``y`` against ``ref`` under ``ref``'s weights."""
    return float(np.sqrt(np.mean(((y - ref) / (rtol * np.abs(ref) + atol)) ** 2)))


def test_morris_lecar_nominal_lane_error_is_the_methods(jax_refs):
    # chip_smoke.py holds the card's nominal Morris-Lecar lane against the
    # port's rtol 1e-10 run at ML_CHECK_SCALE times the run's tolerances:
    # ida_tpu's own rtol 1e-6 solve is as far from its rtol 1e-10 one, so the
    # error is the method's (local error control on the upstroke), and the
    # port's rtol 1e-6 lane on the CPU is ida_tpu's and reads the same distance
    ref = jax_refs["ml_nominal"]
    assert int(ref["reference"]["istate"]) == C.SUCCESS == int(ref["run"]["istate"])
    params, yy0, yp0 = morris_lecar_inputs(1)
    st0 = ensemble_init(morris_lecar_factory, params, yy0, yp0, device="cpu")
    st, tret, ist = fused_solve.make_fused_solve(morris_lecar_factory, _tol(
        ML_RTOL, ML_ATOL, device="cpu"))(st0, params, ML_TOUT)
    q = get_quad(to_native(st), morris_lecar_factory(torch.from_numpy(params.T)), tret)
    assert int(ist[0]) == C.SUCCESS
    port = {"yy": st.yy[0].numpy(), "get_quad": q[:, 0].numpy()}
    for k in ("yy", "get_quad"):
        want = ref["reference"][k]
        jax_run = _wrms(ref["run"][k], want, ML_RTOL, ML_ATOL)
        port_run = _wrms(port[k], want, ML_RTOL, ML_ATOL)
        assert 1.0 < jax_run < ML_CHECK_SCALE, (k, jax_run)
        assert abs(port_run - jax_run) <= 1e-3 * jax_run, (k, port_run, jax_run)
        assert _wrms(port[k], ref["run"][k], ML_RTOL, ML_ATOL) < 1e-3, k


def test_the_entry_carries_yq_for_a_model_with_quadratures(tmp_path_factory):
    # the pointer table: yQ is touched (allocated in the result, passed to
    # the kernel) for a model with quadratures only; the evaluation entry
    # point's quad of each quadrature model, bit for bit the eager problem's
    params = torch.from_numpy(np.tile(ROBERTS_PARAMS[:, None], (1, 2)))
    rq = fused_solve.model_of(quad_factory, params)
    assert rq.nq == 2 and "static constexpr int NQ = 2;" in rq.header
    assert "static void quad(" in rq.header
    assert fused_solve.ROBERTS.nq == 0 and "yQ" in fused_solve.STATE_FIELDS
    for opts in (IdaOptions(), IdaOptions(ls_precision="refined")):
        assert "yQ" not in fused_solve.touched_fields(opts, fused_solve.ROBERTS)
        assert "yQ" in fused_solve.touched_fields(opts, rq)
    st = ensemble_init(quad_factory, roberts_inputs(4)[0], np.tile(ROBERTS_YY0, (4, 1)),
                       np.zeros((4, 3)), device="cpu")
    assert fused_solve.empty_result(st, IdaOptions(), fused_solve.ROBERTS).yQ is st.yQ
    assert fused_solve.empty_result(st, IdaOptions(), rq).yQ is not st.yQ
    rng = np.random.default_rng(11)
    for factory, p0, n in ((quad_factory, ROBERTS_PARAMS, 3),
                           (morris_lecar_factory, np.array([100.0]), 2)):
        lanes = 256
        model = fused_solve.model_of(factory, torch.from_numpy(np.tile(p0[:, None], (1, 2))))
        yy = (np.stack([rng.uniform(-80, 60, lanes), rng.uniform(0, 1, lanes)]) if n == 2
              else np.abs(rng.normal(size=(n, lanes))))
        args = (torch.from_numpy(p0[:, None] * np.exp(rng.uniform(-0.2, 0.2, (len(p0), lanes)))),
                torch.from_numpy(rng.uniform(0.0, 5.0, lanes)),
                torch.from_numpy(np.exp(rng.uniform(-3.0, 5.0, lanes))), torch.from_numpy(yy),
                *(torch.from_numpy(rng.normal(size=(n, lanes))) for _ in range(2)))
        out = [torch.empty(n, lanes, dtype=torch.float64),
               torch.empty(n, n, lanes, dtype=torch.float64),
               torch.empty(n, lanes, dtype=torch.float64),
               torch.empty(model.nq, lanes, dtype=torch.float64)]
        a = fused_solve.ModelEvalArgs(*(x.data_ptr() for x in args),
                                      *(x.data_ptr() for x in out[:3]), lanes, out[3].data_ptr())
        lib = host_build(tmp_path_factory, (), model)
        assert lib.fused_model_eval_f64(ctypes.byref(a), model.id, None) == 0
        a.quad = None  # a model with quadratures must be given somewhere to put them
        assert lib.fused_model_eval_f64(ctypes.byref(a), model.id, None) != 0
        want = fused_solve.eval_model(factory, *args)  # the plain version on CPU tensors
        for got, w in zip(out, want):
            assert torch.equal(got, w)
