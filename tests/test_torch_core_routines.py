"""The port's core routines against the JAX package's.

Two kinds of input:
* the golden C snapshots of tests/test_core_routines.py: those tests run
  unchanged, with the routine names they call pointed at the port (each
  call converts the JAX state to the port's, runs the port's routine and
  converts back), so the port meets the same C IDA golden values;
* states taken mid-run from a JAX B=8 Roberts ensemble (batch-native), fed
  through ``utils.convert`` to the port and, as they are, to the JAX
  routine run op by op. Integer fields must match exactly; floats use
  rtol 1e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_core_routines as golden
from ida_tpu.core import coeffs as jc
from ida_tpu.core import complete_step as jcs
from ida_tpu.core import error_test as je
from ida_tpu.core import interp as ji
from ida_tpu.core import nls as jn
from ida_tpu.core import step as jst
from ida_tpu.core.solve import TASK_ONE_STEP
from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.core.state import IdaState as JState
from ida_tpu.core.state import init_state as jinit
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory, roberts_problem
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu_torch.core import coeffs as tc
from ida_tpu_torch.core import complete_step as tcs
from ida_tpu_torch.core import error_test as te
from ida_tpu_torch.core import interp as ti
from ida_tpu_torch.core import nls as tn
from ida_tpu_torch.core import state as tstate
from ida_tpu_torch.core import step as tst
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.parallel import ensemble_init as tensemble_init
from ida_tpu_torch.problem import IdaProblem as TProblem
from ida_tpu_torch.utils.convert import params_from_numpy, state_from_numpy

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

RTOL = 1e-13
B = 8


def _to_numpy(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def to_port(st):
    return state_from_numpy(_to_numpy(st), device="cpu", batch="trailing")


def to_jax(st):
    return JState(**{f: () if f == "pdata" else jnp.asarray(getattr(st, f).numpy()) for f in st._fields})


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- init_state


def test_init_state_matches_jax_field_by_field():
    yy0 = np.array([1.0, 0.0, 0.0])
    yp0 = np.array([-0.04, 0.04, 0.0])
    ref = jinit(roberts_problem(with_roots=False), yy0, yp0)
    got = tstate.init_state(troberts(_t(ROBERTS_PARAMS)), yy0, yp0, device="cpu")
    for f in JState._fields:
        if f == "pdata":
            assert got.pdata == ()
            continue
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_ensemble_init_matches_jax_field_by_field():
    params = np.outer(np.linspace(0.9, 1.1, B), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (B, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    ref = jensemble_init(roberts_factory, jnp.asarray(params), jnp.asarray(yy0), jnp.asarray(yp0))
    got = tensemble_init(troberts, params, yy0, yp0, device="cpu")
    for f in JState._fields:
        if f == "pdata":
            continue
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# ----------------------------------------------- golden C snapshots, via port


def _port_problem(prob):
    return TProblem(n=prob.n, res=lambda *a: None, id=None if prob.id is None else _t(prob.id))


def _port_opts(opts):
    return tstate.IdaOptions(maxord=opts.maxord, suppressalg=opts.suppressalg)


def _set_coeffs(state):
    st, ck = tc.set_coeffs(to_port(state))
    return to_jax(st), jnp.asarray(ck.numpy())


def _predict(state):
    return to_jax(tc.predict(to_port(state)))


def _restore(state, saved_t):
    return to_jax(tc.restore(to_port(state), _t(saved_t)))


def _error_test(state, prob, opts, ck):
    st, r = te.error_test(to_port(state), _port_problem(prob), _port_opts(opts), _t(ck))
    return to_jax(st), je.ErrorTestResult(*(jnp.asarray(x.numpy()) for x in r))


def _complete_step(state, prob, opts, err_k, err_km1):
    st = tcs.complete_step(to_port(state), _port_problem(prob), _port_opts(opts), _t(err_k), _t(err_km1))
    return to_jax(st)


def _get_solution(state, t):
    st, ok = ti.get_solution(to_port(state), _t(t))
    return to_jax(st), jnp.asarray(ok.numpy())


GOLDEN = {
    "set_coeffs_1": lambda: golden.TestSetCoeffs().test1(),
    "set_coeffs_2": golden.test_set_coeffs_case2,
    "predict": golden.test_predict,
    "restore": golden.test_restore,
    "error_test_fails": lambda: golden.TestErrorTest().test1_fails(),
    "error_test_passes": lambda: golden.TestErrorTest().test2_passes(),
    "complete_step_1": lambda: golden.TestCompleteStep().test1(),
    "complete_step_2": lambda: golden.TestCompleteStep().test2(),
    "complete_step_3": lambda: golden.TestCompleteStep().test3(),
    "get_solution": golden.test_get_solution,
}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_snapshot_through_port(case, monkeypatch):
    for name, fn in [
        ("set_coeffs", _set_coeffs), ("predict", _predict), ("restore", _restore),
        ("error_test", _error_test), ("complete_step", _complete_step),
        ("get_solution", _get_solution),
    ]:
        monkeypatch.setattr(golden, name, fn)
    GOLDEN[case]()


# ------------------------------------------- mid-run states of a B=8 ensemble


@pytest.fixture(scope="module")
def midrun():
    """Batch-native JAX states after 3, 12 and 40 internal steps of a B=8
    Roberts ensemble (TASK_ONE_STEP toward t=400), with its problem/tol."""
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, B)), ROBERTS_PARAMS)
    yy0 = jnp.tile(jnp.asarray(ROBERTS_YY0), (B, 1))
    yp0 = jnp.asarray(params[:, :1] * np.array([-1.0, 1.0, 0.0]))
    st = jensemble_init(roberts_factory, jnp.asarray(params), yy0, yp0)
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), st)
    jprob = roberts_factory(jnp.asarray(params.T))
    tol = JTol(jnp.full((B,), 1e-4), jnp.tile(jnp.asarray([[1e-8], [1e-6], [1e-6]]), (1, B)))
    one = jax.jit(lambda s: jsolve(s, jprob, JOptions(), tol, jnp.full((B,), 400.0), TASK_ONE_STEP)[0])
    snaps = {}
    for k in range(1, 41):
        st = one(st)
        if k in (3, 12, 40):
            snaps[k] = st
    return snaps, jprob, troberts(params_from_numpy(params, device="cpu"))


def _assert_same(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


def _assert_state(js, ts, what):
    for f in JState._fields:
        if f != "pdata":
            _assert_same(getattr(js, f), getattr(ts, f), f"{what}.{f}")


def _mask():
    return np.array([True, False, True, True, False, True, True, True])


ROUTINES = [
    "set_coeffs", "set_coeffs_masked", "predict", "restore", "reset", "error_test",
    "complete_step", "get_solution", "nonlinear_solve", "handle_n_flag", "attempt_once",
]


@pytest.mark.parametrize("routine", ROUTINES)
@pytest.mark.parametrize("nsteps", [3, 12, 40])
def test_midrun_routine_matches_jax(midrun, nsteps, routine):
    snaps, jprob, tprob = midrun
    js = snaps[nsteps]
    ts = to_port(js)
    jo, to = JOptions(), tstate.IdaOptions()
    m = _mask()
    jm, tm = jnp.asarray(m), torch.from_numpy(m)
    if routine == "set_coeffs":
        (a, ack), (b, bck) = jc.set_coeffs(js), tc.set_coeffs(ts)
        _assert_state(a, b, routine)
        _assert_same(ack, bck, "ck")
    elif routine == "set_coeffs_masked":
        (a, _), (b, _) = jc.set_coeffs(js, mask=jm), tc.set_coeffs(ts, mask=tm)
        _assert_state(a, b, routine)
    elif routine == "predict":
        _assert_state(jc.predict(js, mask=jm), tc.predict(ts, mask=tm), routine)
    elif routine == "restore":
        saved = js.tn - 0.5 * js.hused
        _assert_state(jc.restore(js, saved, mask=jm), tc.restore(ts, _t(saved), mask=tm), routine)
    elif routine == "reset":
        _assert_state(jc.reset(js, mask=jm), tc.reset(ts, mask=tm), routine)
    elif routine == "error_test":
        ck = jnp.linspace(0.2, 1.2, B)
        (a, ar), (b, br) = je.error_test(js, jprob, jo, ck, mask=jm), te.error_test(ts, tprob, to, _t(ck), mask=tm)
        _assert_state(a, b, routine)
        for x, y, name in zip(ar, br, ar._fields):
            _assert_same(x, y, name)
    elif routine == "complete_step":
        err_k, err_km1 = jnp.linspace(0.01, 0.9, B), jnp.linspace(0.9, 0.01, B)
        ck = jnp.linspace(0.3, 0.4, B)
        a = jcs.complete_step(js, jprob, jo, err_k, err_km1, ck=ck, mask=jm)
        b = tcs.complete_step(ts, tprob, to, _t(err_k), _t(err_km1), ck=_t(ck), mask=tm)
        _assert_state(a, b, routine)
    elif routine == "get_solution":
        t = js.tn - 0.3 * js.hused
        (a, aok), (b, bok) = ji.get_solution(js, t), ti.get_solution(ts, _t(t))
        _assert_state(a, b, routine)
        _assert_same(aok, bok, "ok")
    elif routine == "handle_n_flag":
        kind = jnp.asarray([6, 1, 6, 2, 3, 4, 6, 1], jnp.int32)
        err_k, err_km1 = jnp.linspace(0.5, 3.0, B), jnp.linspace(2.0, 0.1, B)
        ncf = jnp.asarray([0, 1, 9, 2, 9, 9, 0, 3], jnp.int32)
        nef = jnp.asarray([0, 1, 2, 9, 0, 0, 9, 0], jnp.int32)
        a = jst._handle_n_flag(js, jo, kind, err_k, err_km1, ncf, nef, mask=jm)
        b = tst._handle_n_flag(ts, to, _t(kind), _t(err_k), _t(err_km1), _t(ncf), _t(nef), mask=tm)
        _assert_state(a[0], b[0], routine)
        for x, y, name in zip(a[1:], b[1:], ("ncf", "nef", "fatal")):
            _assert_same(x, y, name)
    else:
        # the Newton loops are lax.while_loops: run JAX op by op so XLA
        # cannot contract a multiply-add the port (and C IDA) round twice
        pre = jc.predict(jc.set_coeffs(js)[0])
        pre = pre._replace(tn=pre.tn + pre.hh)
        if routine == "nonlinear_solve":
            with jax.disable_jit():
                a, ast = jn.nonlinear_solve(pre, jprob, jo, active=jm)
            b, bst = tn.nonlinear_solve(to_port(pre), tprob, to, active=tm)
            _assert_state(a, b, routine)
            _assert_same(ast, bst, "nl_status")
        else:
            ncf = jnp.zeros((B,), jnp.int32)
            with jax.disable_jit():
                a = jst.attempt_once(js, jprob, jo, js.tn, ncf, ncf, active=jm)
            b = tst.attempt_once(ts, tprob, to, ts.tn, _t(ncf), _t(ncf), active=tm)
            _assert_state(a[0], b[0], routine)
            for x, y, name in zip(a[1:], b[1:], ("success", "fatal", "ck", "err_k", "err_km1", "ncf", "nef")):
                _assert_same(x, y, name)


# ------------------------------------------------- substrate: norms, helpers


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("name", ["wrms_norm", "wrms_norm_masked", "wrms_norm_bnd", "maybe_masked"])
def test_norms_match_jax(name):
    from ida_tpu import norms as jnorms
    from ida_tpu_torch import norms as tnorms

    x, w = _rand(1, 5, 3), np.abs(_rand(2, 5, 3)) * 1e4
    mask = np.array([True, False, True])
    if name == "wrms_norm":
        a, b = jnorms.wrms_norm(jnp.asarray(x), jnp.asarray(w)), tnorms.wrms_norm(_t(x), _t(w))
    elif name == "wrms_norm_masked":
        a = jnorms.wrms_norm_masked(jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask))
        b = tnorms.wrms_norm_masked(_t(x), _t(w), _t(mask))
    elif name == "wrms_norm_bnd":
        # [N, B] batch-native, reduced over the data axis, with the id mask
        xt, wt = x.T.copy(), w.T.copy()
        a = jnorms.wrms_norm_bnd(jnp.asarray(xt), jnp.asarray(wt), 3, 1, jnp.asarray(mask))
        b = tnorms.wrms_norm_bnd(_t(xt), _t(wt), 3, 1, _t(mask))
    else:
        a = jnorms.wrms_norm_maybe_masked(jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask), True)
        b = tnorms.wrms_norm_maybe_masked(_t(x), _t(w), _t(mask), True)
    _assert_same(a, b, name)


@pytest.mark.parametrize("name", ["take1", "take_row", "set_row", "set1", "tree_where", "masked_while_loop"])
def test_tree_helpers_match_jax(name):
    from ida_tpu import utils as jutils
    from ida_tpu_torch.utils import tree as tutils

    vec, mat = _rand(3, 6, B), _rand(4, 6, 3, B)
    idx = np.array([0, 5, 2, 3, 1, 4, 5, 0], np.int32)
    row, val = _rand(5, 3, B), _rand(6, B)
    if name == "take1":
        _assert_same(jutils.take1(jnp.asarray(vec), jnp.asarray(idx)), tutils.take1(_t(vec), _t(idx)), name)
    elif name == "take_row":
        _assert_same(jutils.take_row(jnp.asarray(mat), jnp.asarray(idx)), tutils.take_row(_t(mat), _t(idx)), name)
    elif name == "set_row":
        a = jutils.set_row(jnp.asarray(mat), jnp.asarray(idx), jnp.asarray(row))
        _assert_same(a, tutils.set_row(_t(mat), _t(idx), _t(row)), name)
    elif name == "set1":
        a = jutils.set1(jnp.asarray(vec), jnp.asarray(idx), jnp.asarray(val))
        _assert_same(a, tutils.set1(_t(vec), _t(idx), _t(val)), name)
    elif name == "tree_where":
        pred = _mask()
        a = jutils.tree_where(jnp.asarray(pred), (jnp.asarray(vec), jnp.asarray(idx)), (jnp.asarray(-vec), jnp.asarray(-idx)))
        b = tutils.tree_where(_t(pred), (_t(vec), _t(idx)), (_t(-vec), _t(-idx)))
        for x, y in zip(a, b):
            _assert_same(x, y, name)
    else:
        # each lane counts up to its own limit; finished lanes freeze
        limit = np.array([0, 3, 1, 7, 2, 5, 4, 6], np.int32)
        a = jutils.masked_while_loop(lambda c: c < jnp.asarray(limit), lambda c: c + 1, jnp.zeros(B, jnp.int32))
        b = tutils.masked_while_loop(lambda c: c < _t(limit), lambda c: c + 1, torch.zeros(B, dtype=torch.int32))
        _assert_same(a, b, name)
        np.testing.assert_array_equal(b.numpy(), limit)


def test_problem_ad_jacobian_and_jtimes_match_analytic_and_jax():
    params = np.outer(np.linspace(0.9, 1.1, B), ROBERTS_PARAMS).T.copy()
    yy, yp = np.abs(_rand(7, 3, B)), _rand(8, 3, B)
    cj, v = np.abs(_rand(9, B)) * 100.0, _rand(10, 3, B)
    analytic = troberts(_t(params))
    ad = TProblem(n=3, res=analytic.res)
    args = (_t(0.0), _t(cj), _t(yy), _t(yp), None)
    j_analytic = analytic.sys_jacobian(*args)
    np.testing.assert_allclose(ad.sys_jacobian(*args).numpy(), j_analytic.numpy(), rtol=1e-14, atol=0)
    jv = ad.jtimes(_t(0.0), _t(cj), _t(yy), _t(yp), _t(v))
    np.testing.assert_allclose(jv.numpy(), np.einsum("ijb,jb->ib", j_analytic.numpy(), v), rtol=1e-12)
    jprob = roberts_factory(jnp.asarray(params))
    ref = jprob.jtimes(0.0, jnp.asarray(cj), jnp.asarray(yy), jnp.asarray(yp), jnp.asarray(v))
    np.testing.assert_allclose(jv.numpy(), np.asarray(ref), rtol=1e-14, atol=0)
    _assert_same(jprob.res(0.0, jnp.asarray(yy), jnp.asarray(yp)), analytic.res(_t(0.0), _t(yy), _t(yp)), "res")
    _assert_same(jprob.jac(0.0, jnp.asarray(cj), jnp.asarray(yy), jnp.asarray(yp), None), j_analytic, "jac")


def test_tolerance_constructors_match_jax():
    from ida_tpu.tol_control import tol_ss as jtol_ss
    from ida_tpu.tol_control import tol_sv as jtol_sv
    from ida_tpu_torch.tol_control import tol_ss, tol_sv

    y = _rand(11, 3, B)
    for jt, tt in [
        (jtol_ss(1e-4, 1e-6), tol_ss(1e-4, 1e-6, device="cpu")),
        (jtol_sv(1e-4, jnp.asarray([1e-8, 1e-6, 1e-6])[:, None]), tol_sv(1e-4, [[1e-8], [1e-6], [1e-6]], device="cpu")),
    ]:
        _assert_same(jt.ewt_set(jnp.asarray(y)), tt.ewt_set(_t(y)), "ewt")


@pytest.mark.parametrize(
    "fast_math,h_scale,maxnef",
    [(False, 1.0, 10), (True, 1.0, 10), (False, 1e3, 10), (False, 1e3, 1)],
    ids=["parity", "fast_math", "error_test_retries", "error_test_fatal"],
)
def test_standalone_step_is_one_production_one_step_call(fast_math, h_scale, maxnef):
    # core.step.step, the standalone one-internal-step retry machine (the
    # solve loop calls attempt_once directly), advances a state exactly as
    # one production ONE_STEP call does, as tests/test_core_routines.py
    # holds ida_tpu's: after three ONE_STEP calls, step equals a fourth.
    # On the same snapshot it equals ida_tpu's step, run op by op so that
    # XLA contracts nothing into a multiply-add, bit for bit, also
    # where a step 1000x too long fails its error test and retries, and
    # where one failure is fatal (maxnef=1)
    from ida_tpu_torch import IDA, IdaOptions
    from ida_tpu_torch.core.step import step
    from ida_tpu_torch.models import ROBERTS_YP0 as TYP0
    from ida_tpu_torch.models import ROBERTS_YY0 as TYY0
    from ida_tpu_torch.models import roberts_problem as tproblem
    from ida_tpu_torch.solver import IdaTask
    from ida_tpu_torch.tol_control import tol_sv

    opts = IdaOptions(fast_math=fast_math, maxnef=maxnef)
    ida = IDA(tproblem(with_roots=False, device="cpu"), TYY0, TYP0,
              tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device="cpu"), opts, device="cpu")
    for _ in range(3):
        ida.solve(0.4, itask=IdaTask.OneStep)
    snap = ida.state
    snap = snap._replace(hh=snap.hh * h_scale)
    got = step(snap, ida.problem, opts)
    with jax.disable_jit():
        jgot = jst.step(to_jax(snap), roberts_problem(with_roots=False), JOptions(fast_math=fast_math, maxnef=maxnef))
    for f in JState._fields:
        if f != "pdata":
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jgot, f)), err_msg=f)
    if h_scale == 1.0:
        assert int(got.status) == 0
        ida.solve(0.4, itask=IdaTask.OneStep)
        ref = ida.state
        for f in ("nst", "kused", "tn", "hused", "phi", "ee", "hh", "kk", "nre", "nni", "netf"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    elif maxnef == 1:
        assert int(got.status) != 0 and int(got.netf) == int(snap.netf) + 1
    else:
        assert int(got.status) == 0 and int(got.netf) > int(snap.netf)
