"""The port's main path end to end: the batched Roberts ensemble through
``ensemble_init`` + ``make_ensemble_solve``, against the JAX package.

* B=8 to tout 0.4 and 400 against ``ida_tpu``'s batch-native ``core_solve``
  (as in tests/test_batch_native.py). Run op by op (``jax.disable_jit``),
  the JAX solve rounds every multiply and add separately, as the port and C
  IDA do: istate, tret and the counters must match exactly, yy/yp/phi to
  rtol 1e-12. Jitted, XLA:CPU contracts multiply-adds into FMAs, so there
  only istate, tret and the counters are held exactly (the jitted
  references in ``test_torch_slice_jitted.py``, a file of few tests, which
  queues after the files with the most tests).
* One lane, roots off, over 12 decades: the canonical per-decade step
  counts of C idaRoberts_dns exactly, and the trajectory against the native
  C++ oracle as in tests/test_native_oracle.py.
* dtype: f32 in gives f32 out for every float leaf, f64 gives f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core.solve import TASK_NORMAL, TASK_ONE_STEP
from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0, roberts_factory
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.parallel import ensemble_init, make_ensemble_solve
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils.convert import params_from_numpy, state_from_numpy, tol_from_numpy
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

B = 8
ATOL = [1e-8, 1e-6, 1e-6]
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn")
CANONICAL_NST = [29, 43, 68, 95, 126, 161, 202, 250, 293, 325, 348, 362]
RTOL = 1e-4


def _inputs(b):
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, b)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


def _jax_native():
    """Batch-native JAX states, problem and tolerances for B=8."""
    params, yy0, yp0 = _inputs(B)
    st = jensemble_init(roberts_factory, jnp.asarray(params), jnp.asarray(yy0), jnp.asarray(yp0))
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), st)
    prob = roberts_factory(jnp.asarray(params.T))
    tol = JTol(jnp.full((B,), RTOL), jnp.tile(jnp.asarray(ATOL)[:, None], (1, B)))
    return st, prob, tol


def _port_solve(tout, itask=TASK_NORMAL, steps=1):
    params, yy0, yp0 = _inputs(B)
    st = ensemble_init(troberts, params, yy0, yp0, device="cpu")
    fn = make_ensemble_solve(troberts, itask=itask)
    tol = tol_sv(RTOL, ATOL, device="cpu")
    for _ in range(steps):
        st, tret, istate = fn(st, params, tol, tout)
    return st, tret, istate


def _assert_exact(ref, got, tret_rtol=0.0):
    (jst, jtret, jist), (tst, ttret, tist) = ref, got
    np.testing.assert_array_equal(tist.numpy(), np.asarray(jist))
    np.testing.assert_allclose(ttret.numpy(), np.asarray(jtret), rtol=tret_rtol, atol=0)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)


@pytest.fixture(scope="module")
def jax_op_by_op():
    """:func:`jax_op_by_op_live`, pinned by tests/make_torch_refs.py."""
    return load("slice_op_by_op", REF_INPUTS)


# what the pinned reference (jax_op_by_op_live) is computed from
REF_INPUTS = {**dict(zip(("params", "yy0", "yp0"), _inputs(B))), "rtol": RTOL, "atol": ATOL, "touts": (0.4, 400.0)}


def jax_op_by_op_live():
    """The op-by-op JAX solve to 0.4, and from there on to 400: a return at
    tout interpolates and leaves the step sequence alone, so the second is
    the solve straight to 400 (the port's own two runs agree in every
    field), for the cost of the steps past 0.4."""
    st, prob, tol = _jax_native()
    refs = {}
    with jax.disable_jit():
        for tout in (0.4, 400.0):
            refs[tout] = jsolve(st, prob, JOptions(), tol, jnp.full((B,), tout), TASK_NORMAL)
            st = refs[tout][0]
    return refs


@pytest.mark.parametrize("tout", [0.4, 400.0])
def test_ensemble_matches_op_by_op_reference(jax_op_by_op, tout):
    ref = jax_op_by_op[tout]
    got = _port_solve(tout)
    assert bool((got[2] == C.SUCCESS).all())
    _assert_exact(ref, got)
    for f in ("yy", "yp", "phi"):
        a = np.moveaxis(np.asarray(getattr(ref[0], f)), -1, 0)
        np.testing.assert_allclose(getattr(got[0], f).numpy(), a, rtol=1e-12, atol=0, err_msg=f)


def test_returned_states_keep_the_batch_leading_layout():
    params, yy0, yp0 = _inputs(B)
    st0 = ensemble_init(troberts, params, yy0, yp0, device="cpu")
    st, tret, istate = _port_solve(0.4)
    assert tret.shape == istate.shape == (B,)
    for f in st._fields:
        if f != "pdata":
            assert getattr(st, f).shape == getattr(st0, f).shape, f
            assert getattr(st, f).dtype == getattr(st0, f).dtype, f


@pytest.fixture(scope="module")
def canonical_lane():
    """One lane at nominal params, roots off, solved decade by decade."""
    from ida_tpu.native import oracle_roberts_trajectory

    touts = [0.4 * 10**k for k in range(12)]
    params = ROBERTS_PARAMS[None, :]
    st = ensemble_init(troberts, params, ROBERTS_YY0[None], ROBERTS_YP0[None], device="cpu")
    fn = make_ensemble_solve(troberts)
    tol = tol_sv(1e-4, ATOL, device="cpu")
    rows = []
    for t in touts:
        st, tret, istate = fn(st, params, tol, t)
        rows.append((int(istate[0]), float(tret[0]), int(st.nst[0]), st.yy[0].numpy().copy()))
    return st, rows, touts, oracle_roberts_trajectory(touts)


def test_canonical_per_decade_steps(canonical_lane):
    _, rows, _, _ = canonical_lane
    assert [r[0] for r in rows] == [C.SUCCESS] * 12
    assert [r[2] for r in rows] == CANONICAL_NST


def test_canonical_statistics(canonical_lane):
    # C idaRoberts_dns without roots (tests/test_roberts_e2e.py:72-84)
    st, _, _, _ = canonical_lane
    stats = {f: int(getattr(st, f)[0]) for f in COUNTERS}
    assert stats == {"nst": 362, "nre": 537, "nje": 60, "nni": 537, "netf": 15, "ncfn": 0}


def test_trajectory_matches_native_oracle(canonical_lane):
    _, rows, touts, (ret, y_oracle, nst_oracle) = canonical_lane
    assert ret == 0
    assert nst_oracle.tolist() == CANONICAL_NST
    for k, t in enumerate(touts):
        assert rows[k][1] == t
        rel = np.max(np.abs((rows[k][3] - y_oracle[k]) / y_oracle[k]))
        assert rel < (1e-10 if t <= 4.0e4 else 1e-6), (t, rel)


def test_final_state_passes_check_ans(canonical_lane):
    # reference examples/roberts.rs:9-51 (tests/test_roberts_e2e.py:57-69)
    _, rows, _, _ = canonical_lane
    reference = np.array([5.2083474251394888e-08, 2.0833390772616859e-13, 9.9999994791631752e-01])
    ewt = 1.0 / (1e-4 * np.abs(reference) + 10.0 * np.array(ATOL))
    assert rows[-1][1] == 4.0e10
    assert np.sqrt(np.mean((ewt * (rows[-1][3] - reference)) ** 2)) < 1.0


def test_unbatched_lane_matches_batch_of_one():
    prob = troberts(torch.from_numpy(ROBERTS_PARAMS))
    tol = tol_sv(1e-4, ATOL, device="cpu")
    st = init_state(prob, ROBERTS_YY0, ROBERTS_YP0, device="cpu")
    one, tret, istate = tsolve(st, prob, IdaOptions(), tol, 4.0)
    assert one.tn.dim() == 0 and int(istate) == C.SUCCESS
    params = ROBERTS_PARAMS[None, :]
    sb = ensemble_init(troberts, params, ROBERTS_YY0[None], ROBERTS_YP0[None], device="cpu")
    batch, tret_b, _ = make_ensemble_solve(troberts)(sb, params, tol, 4.0)
    assert float(tret) == float(tret_b[0])
    for f in ("yy", "phi", "nst", "nni", "kused"):
        assert torch.equal(getattr(one, f), getattr(batch, f)[0]), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dtype_is_preserved(dtype):
    params, yy0, yp0 = _inputs(2)
    st = ensemble_init(troberts, params, yy0, yp0, device="cpu", dtype=dtype)
    tol = tol_sv(1e-4, ATOL, device="cpu", dtype=dtype)
    st, tret, istate = make_ensemble_solve(troberts)(st, params, tol, 0.4)
    assert bool((istate == C.SUCCESS).all())
    assert tret.dtype == dtype
    for f in st._fields:
        x = getattr(st, f)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            assert x.dtype == dtype, f


@pytest.mark.parametrize(
    "kwargs",
    [
        {"linear_solver": "band", "band_mu": 2, "band_ml": 2, "ls_precision": "single"},
        {"ls_precision": "single"},
        {"ls_precision": "refined"},
        {"linear_solver": "spgmr", "ls_precision": "single"},
        {"linear_solver": "spgmr", "krylov_storage": "bfloat16"},
        {"fast_math": True},
    ],
    ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()),
)
def test_mode_options_build_and_solve(kwargs):
    # the options that raised before they were ported: each builds, sizes
    # the state and solves the B = 8 ensemble to 0.4 (held against ida_tpu in
    # tests/test_torch_mixed_precision.py and test_torch_fast_math.py)
    params, yy0, yp0 = _inputs(B)
    tol = tol_sv(1e-4, ATOL, device="cpu")
    out = {}
    for opts in (IdaOptions(**kwargs), IdaOptions()):
        st = ensemble_init(troberts, params, yy0, yp0, device="cpu", opts=opts)
        st, tret, istate = make_ensemble_solve(troberts, opts)(st, params, tol, 0.4)
        assert bool((istate == C.SUCCESS).all()) and bool((tret == 0.4).all())
        out[opts == IdaOptions()] = st
    opts = IdaOptions(**kwargs)
    direct = opts.linear_solver != "spgmr" and opts.ls_precision != "full"
    assert out[False].lu.dtype == (torch.float32 if direct else torch.float64)
    # within the integration tolerance of the parity solve
    diff = (out[False].yy - out[True].yy).abs()
    assert bool((diff <= 1e-3 * out[True].yy.abs() + torch.tensor(ATOL)).all())
