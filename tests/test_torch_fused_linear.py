"""The band linear solver in the whole-solve kernel (K2-K4), on the CPU.

``ida_tpu``'s fused Pallas kernel traces the whole ``core_solve`` with the
caller's options, so it takes ``linear_solver="band"`` and ``"spgmr"``; the
port's kernel compiles them in (``csrc/ida_lane.cuh``: the band Jacobian from
``mu + ml + 1`` colored jvps of the model's ``res_jvp``, the band LU of
``csrc/band_lu.cuh``; SPGMR in tests/test_torch_fused_linear_krylov.py).
Here, with the kernel source built for the host (tests/test_torch_fused_host.py
``host_build``, the solver's ``-D`` flags from ``ops.fused_solve.mode_flags``):

* B = 8 heterogeneous Roberts lanes (tstop, hmax and hin set on some) to
  tout 0.4, f64: K2 and a budget of 6 attempts a launch (K3 + K4) bit for
  bit the port's eager solve under the same options, every field of the
  state (the band factor [B, 2*ml+mu+1, N] and its pivots among them),
  ``tret`` and ``istate``, for the exact band (mu = ml = 2, the whole 3 x 3
  Jacobian), an inexact one (mu = ml = 1: a different step sequence), and
  mu = ml = 1 under ``ls_precision="single"`` (float32 arguments and factor)
  and ``fast_math``;
* the port's float32 K2 against ``ida_tpu`` (f32, B = 8, band (1, 1) and
  spgmr): bit for bit its ``core_solve`` run op by op (``yy``, ``nst``), and
  against its kernel itself (``make_fused_solve(..., tile=4,
  interpret=True)``) the same ``istate`` in every lane and ``yy`` within
  WRMS 10 at the run's tolerances (``ida_tpu``'s cross-run bound: XLA:CPU
  contracts multiply-adds into FMAs). The contraction moves whole step
  sequences here: the kernel's ``nst`` is up to 22% (band) and 14% (spgmr)
  from ``ida_tpu``'s own op-by-op run, which the port's equals, so ``nst``
  is held to that run. The JAX runs are pinned (tests/make_torch_refs.py,
  ``fused_linear_jax``);
* the entry's contract: the launches counted under the solver's mode name,
  a state laid out for another solver refused.

The card's build is held against the eager path on the card by
``chip_smoke.py``'s ``fused_linear`` phase and the ``cuda`` tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.ops.fused_solve import make_fused_solve as jmake_fused_solve
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu.tol_control import tol_sv as jtol_sv
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.ops import fused_solve
from ida_tpu_torch.parallel import ensemble_init
from ida_tpu_torch.tol_control import tol_sv
from make_torch_refs import load
from test_torch_fused_host import ATOL, _differ, _stress_inputs, host_lib, on_host  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

B = 8
TOUT = 0.4
ATOL32 = [1e-6, 1e-6, 1e-6]  # the f32 runs against ida_tpu's kernel

BAND_CASES = {
    "band2_2": IdaOptions(linear_solver="band", band_mu=2, band_ml=2),
    "band1_1": IdaOptions(linear_solver="band", band_mu=1, band_ml=1),
    "band1_1-single": IdaOptions(linear_solver="band", band_mu=1, band_ml=1,
                                 ls_precision="single"),
    "band1_1-fast_math": IdaOptions(linear_solver="band", band_mu=1, band_ml=1, fast_math=True),
}


def kernel_solve(factory, st_b, params, tol, tout, opts, budget=None):
    """The kernel's entry as ``make_fused_solve`` drives it on the card, on
    the host build: batch-leading in, out of place, tolerances by value, in
    the state's dtype. Returns (model, (state, tret, istate))."""
    p_b = torch.as_tensor(params, dtype=st_b.dtype).contiguous()
    model = fused_solve.model_of(factory, p_b.t())
    tol_in = fused_solve.tol_inputs(tol, model.n, p_b.shape[0], st_b.dtype, torch.device("cpu"))
    return model, fused_solve._solve_cuda(st_b, p_b, tol_in, tout, opts, model, budget)


def assert_kernel_is_the_eager_solve(factory, params, st0, tol, tout, opts):
    """K2, then budget 6 (K3 + K4), each bit for bit the port's eager solve
    (``make_fused_solve``'s plain version on CPU tensors) under ``opts``,
    every launch counted under ``opts``' mode name; returns the eager result."""
    ref = fused_solve.make_fused_solve(factory, tol, opts)(st0, params, tout)
    for budget in (None, 6):
        fused_solve.reset_launch_counts()
        model, got = kernel_solve(factory, st0, params, tol, tout, opts, budget)
        assert _differ(got[0], ref[0]) == [], budget
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]), budget
        kinds = {"init", "cont"} if budget else {"solve"}
        assert set(fused_solve.MODE_LAUNCHES) == {
            (k, fused_solve.mode_name(opts), model.name) for k in kinds}, budget
    return ref


@pytest.mark.parametrize("case", BAND_CASES)
def test_band_kernel_is_bitwise_the_eager_band_solve(on_host, case):
    opts = BAND_CASES[case]
    params, st0 = _stress_inputs(b=B, opts=opts)
    rows = 2 * opts.band_ml + opts.band_mu + 1
    assert tuple(st0.lu.shape) == (B, rows, 3)
    assert st0.lu.dtype == (torch.float32 if opts.ls_precision == "single" else torch.float64)
    ref = assert_kernel_is_the_eager_solve(roberts_factory, params, st0,
                                           tol_sv(1e-4, ATOL, device="cpu"), TOUT, opts)
    assert bool((ref[2] == C.SUCCESS).all())
    # a factor and its pivots were written, and the Krylov counters passed
    # through untouched
    assert bool((ref[0].nje > 0).all()) and not torch.equal(ref[0].lu, st0.lu)
    assert int(ref[0].nli.sum()) == 0
    if opts.band_mu == 1:
        # the inexact band: far more steps than the whole Jacobian takes
        assert int(ref[0].nst.min()) > 20


def test_the_entry_refuses_a_state_laid_out_for_another_solver(on_host):
    # a dense state ([B, N, N] factor) under band options, and a band state
    # under other half-bandwidths
    params, st_dense = _stress_inputs(b=B)
    tol = tol_sv(1e-4, ATOL, device="cpu")
    with pytest.raises(ValueError, match="laid out for linear_solver='band'"):
        fused_solve.make_fused_solve(roberts_factory, tol, BAND_CASES["band1_1"])(
            st_dense, params, TOUT)
    _, st_band = _stress_inputs(b=B, opts=BAND_CASES["band2_2"])
    with pytest.raises(ValueError, match="ensemble_init"):
        fused_solve.make_fused_solve(roberts_factory, tol, BAND_CASES["band1_1"])(
            st_band, params, TOUT)
    assert fused_solve.mode_name(BAND_CASES["band1_1-single"]) == "single_band1_1"
    assert "-DIDA_BAND_ML=1" in fused_solve.mode_flags(False, "full", fused_solve.linear_of(
        BAND_CASES["band1_1"]))


# ida_tpu's kernel, interpret mode, f32: Roberts at B = 8 (rates 0.9-1.1 x
# nominal) to 0.4, band (1, 1) and spgmr (maxl 5, no preconditioner)
JAX_CASES = {"band1_1": {"linear_solver": "band", "band_mu": 1, "band_ml": 1},
             "spgmr": {"linear_solver": "spgmr"}}


def _inputs(b):
    params = np.outer(np.linspace(0.9, 1.1, b), ROBERTS_PARAMS)
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, np.tile(ROBERTS_YY0, (b, 1)), yp0


# what the pinned references (fused_linear_jax_live) are computed from
REF_INPUTS = {"b": B, "atol32": ATOL32, "rtol": 1e-4, "inputs": _inputs(B), "tout": TOUT,
              "tile": 4, "cases": JAX_CASES}


def _jax_fused_f32(case):
    dtype = jnp.float32
    opts = JOptions(**JAX_CASES[case])
    params, yy0, yp0 = (jnp.asarray(a, dtype) for a in _inputs(B))
    states = jensemble_init(jroberts, params, yy0, yp0, dtype=dtype, opts=opts)
    fused = jmake_fused_solve(jroberts, jtol_sv(1e-4, jnp.asarray(ATOL32, dtype), dtype=dtype),
                              opts, tile=4, interpret=True)
    st, tret, ist = fused(states, params, TOUT)
    return {"nst": np.asarray(st.nst), "yy": np.asarray(st.yy), "tret": np.asarray(tret),
            "istate": np.asarray(ist)}


def _jax_op_by_op_f32(case):
    """ida_tpu's batch-native core_solve of the same lanes, op by op."""
    dtype = jnp.float32
    opts = JOptions(**JAX_CASES[case])
    params, yy0, yp0 = (jnp.asarray(a, dtype) for a in _inputs(B))
    st = jensemble_init(jroberts, params, yy0, yp0, dtype=dtype, opts=opts)
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), st)
    tol = JTol(jnp.full((B,), 1e-4, dtype), jnp.tile(jnp.asarray(ATOL32, dtype)[:, None], (1, B)))
    with jax.disable_jit():
        jst, _, jist = jsolve(st, jroberts(params.T), opts, tol, jnp.full((B,), TOUT, dtype))
    return {"nst": np.asarray(jst.nst), "yy": np.asarray(jst.yy).T, "istate": np.asarray(jist)}


def fused_linear_jax_live():
    return {"fused": {case: _jax_fused_f32(case) for case in JAX_CASES},
            "op_by_op": {case: _jax_op_by_op_f32(case) for case in JAX_CASES}}


def test_float32_kernel_meets_ida_tpus_fused_kernel_with_band_and_krylov(on_host):
    refs = load("fused_linear_jax", REF_INPUTS)
    params, yy0, yp0 = _inputs(B)
    for case, kw in JAX_CASES.items():
        ref, obo = refs["fused"][case], refs["op_by_op"][case]
        opts = IdaOptions(**kw)
        st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu",
                            dtype=torch.float32, opts=opts)
        tol = tol_sv(1e-4, ATOL32, device="cpu", dtype=torch.float32)
        _, (st, tret, ist) = kernel_solve(roberts_factory, st0, params, tol, TOUT, opts)
        assert bool((ist == C.SUCCESS).all()), case
        np.testing.assert_array_equal(ist.numpy(), ref["istate"], err_msg=case)
        w = 1e-4 * np.abs(ref["yy"]) + np.array(ATOL32)
        wrms = np.sqrt(np.mean(((st.yy.numpy() - ref["yy"]) / w) ** 2, axis=1))
        assert (wrms <= 10.0).all(), (case, wrms)
        np.testing.assert_array_equal(st.yy.numpy(), obo["yy"], err_msg=case)
        np.testing.assert_array_equal(st.nst.numpy(), obo["nst"], err_msg=case)
        np.testing.assert_array_equal(ist.numpy(), obo["istate"], err_msg=case)
