"""The port's rooted solve over the whole Roberts run, one lane, against the
jitted JAX solve and the native C++ oracle (the per-function and op-by-op
checks are in tests/test_torch_roots.py).

* To 4e10 against the jitted JAX solve: counters, ``nge`` and ``iroots``
  exactly; the first root's time to rtol 1e-9, later floats to 1e-8 and
  1e-7 (XLA:CPU contracts multiply-adds inside jit and drifts as t grows).
* Root times against the native oracle with the tolerances of
  tests/test_root_oracle.py, with ``rootdir`` filtering, the zero-at-t0
  deactivation and CLOSE_ROOTS (their convergence with the tolerance in
  ``test_torch_roots_tolerance.py``, a file of one test, which queues
  last).
* The budgeted solve with roots: budget 7, resumed, equals no budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.core.state import init_state as jinit
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0
from ida_tpu.models import roberts_problem as jroberts_problem
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.models import roberts_problem as troberts_problem
from ida_tpu_torch.parallel import to_native
from ida_tpu_torch.problem import IdaProblem as TProblem
from ida_tpu_torch.tol_control import TolControl, tol_sv
from ida_tpu_torch.utils.convert import params_from_numpy

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

ATOL = [1e-8, 1e-6, 1e-6]
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn", "nge")
TOUTS = 0.4 * 10.0 ** np.arange(12)


def _params(b):
    return np.outer(np.exp(np.linspace(-0.2, 0.2, b)), ROBERTS_PARAMS)


def _port_events(rtol, atol, rootdir=None, problem=None, touts=TOUTS):
    """The port's twin of tests/test_root_oracle.py::_jax_events: core solve,
    one lane, re-entered after each ROOT_RETURN."""
    prob = problem or troberts_problem(with_roots=True, device="cpu")
    st = init_state(prob, ROBERTS_YY0, ROBERTS_YP0, device="cpu")
    if rootdir is not None:
        st = st._replace(rootdir=torch.as_tensor(rootdir, dtype=torch.int32))
    tol = tol_sv(rtol, atol, device="cpu")
    events = []
    for t in touts:
        while True:
            st, tret, ist = tsolve(st, prob, IdaOptions(), tol, float(t))
            if int(ist) != C.ROOT_RETURN:
                break
            events.append((float(tret), st.iroots.tolist()))
        assert int(ist) == C.SUCCESS, (t, int(ist))
    return st, events


@pytest.fixture(scope="module")
def port_run():
    return _port_events(1e-4, ATOL)


@pytest.fixture(scope="module")
def jitted_run():
    prob = jroberts_problem(with_roots=True)
    tol = JTol(jnp.asarray(1e-4), jnp.asarray(ATOL))
    fn = jax.jit(lambda s, t: jsolve(s, prob, JOptions(), tol, t))
    st = jinit(prob, ROBERTS_YY0, ROBERTS_YP0)
    events = []
    for t in TOUTS:
        while True:
            st, tret, ist = fn(st, jnp.asarray(t))
            if int(ist) != C.ROOT_RETURN:
                break
            events.append((float(tret), np.asarray(st.iroots).tolist()))
        assert int(ist) == C.SUCCESS
    return st, events


def test_twelve_decades_counters_match_jitted_reference(port_run, jitted_run):
    (tst, tev), (jst, jev) = port_run, jitted_run
    for f in COUNTERS:
        assert int(getattr(tst, f)) == int(getattr(jst, f)), f
    assert {f: int(getattr(tst, f)) for f in COUNTERS} == {
        "nst": 362, "nre": 537, "nje": 60, "nni": 537, "netf": 15, "ncfn": 0, "nge": 404}
    assert [e[1] for e in tev] == [e[1] for e in jev] == [[0, 1], [-1, 0]]
    # the jitted run's contracted multiply-adds drift from one rounding per
    # operation as t grows: 1e-9 holds at the first root, 1e-8 at the second
    # (t = 2e7) and 1e-7 for the state at 4e10 (measured: 3.4e-9, 1.7e-8)
    np.testing.assert_allclose(tev[0][0], jev[0][0], rtol=1e-9, atol=0)
    np.testing.assert_allclose(tev[1][0], jev[1][0], rtol=1e-8, atol=0)
    # (the internal step positions themselves drift to 2e-6 by then)
    np.testing.assert_allclose(tst.yy.numpy(), np.asarray(jst.yy), rtol=1e-7, atol=0)
    np.testing.assert_allclose(tst.tn.numpy(), np.asarray(jst.tn), rtol=1e-5, atol=0)
    assert tst.gactive.tolist() == np.asarray(jst.gactive).tolist()


def _np_res(t, y, yp):
    r0 = -0.04 * y[0] + 1.0e4 * y[1] * y[2]
    return np.array([r0 - yp[0], -r0 - 3.0e7 * y[1] ** 2 - yp[1], y[0] + y[1] + y[2] - 1.0])


def _np_jac(t, cj, y, yp, r):
    return np.array([
        [-0.04 - cj, 1.0e4 * y[2], 1.0e4 * y[1]],
        [0.04, -1.0e4 * y[2] - 6.0e7 * y[1] - cj, -1.0e4 * y[1]],
        [1.0, 1.0, 1.0],
    ])


def _np_root(t, y, yp):
    return np.array([y[0] - 1.0e-4, y[2] - 0.01])


def _oracle(rtol, atol, root=_np_root, nroots=2, touts=TOUTS, **kw):
    from ida_tpu.native import oracle_solve_roots

    return oracle_solve_roots(_np_res, _np_jac, root, nroots, ROBERTS_YY0, ROBERTS_YP0, touts,
                              rtol, np.asarray(atol), **kw)


def test_roots_match_oracle_loose_tol(port_run):
    ret, _y, ev_o, stats = _oracle(1e-4, ATOL)
    _, ev_t = port_run
    assert ret == 0 and stats["nge"] > 0
    assert len(ev_o) == len(ev_t) == 2
    for (_, io), (_, it) in zip(ev_o, ev_t):
        assert list(io) == list(it)
    assert abs(ev_o[0][0] - ev_t[0][0]) / ev_t[0][0] < 1e-12
    assert abs(ev_o[1][0] - ev_t[1][0]) / ev_t[1][0] < 5e-3
    # g1 = y3 - 0.01 crosses INCREASING first, g0 = y1 - 1e-4 DECREASING later
    assert ev_t[0][1] == [0, 1] and ev_t[1][1] == [-1, 0]
    np.testing.assert_allclose(ev_t[0][0], 2.6402e-01, rtol=1e-3)
    np.testing.assert_allclose(ev_t[1][0], 2.0788e7, rtol=1e-2)


def test_rootdir_filtering_matches_oracle():
    rootdir = np.array([0, -1], np.int32)
    ret, _y, ev_o, _s = _oracle(1e-4, ATOL, rootdir=rootdir)
    _, ev_t = _port_events(1e-4, ATOL, rootdir=rootdir)
    assert ret == 0 and len(ev_o) == len(ev_t) == 1
    assert list(ev_o[0][1]) == ev_t[0][1] == [-1, 0]
    assert abs(ev_o[0][0] - ev_t[0][0]) / ev_t[0][0] < 5e-3


def test_zero_at_t0_deactivation_matches_oracle():
    # g = y2 starts at exactly 0, rises, then decays: no event in either engine
    ret, _y, ev_o, _s = _oracle(1e-4, ATOL, root=lambda t, y, yp: np.array([y[1]]), nroots=1)
    base = troberts_problem(with_roots=False, device="cpu")
    prob = TProblem(n=3, res=base.res, jac=base.jac, nroots=1,
                    root=lambda t, y, yp: torch.stack([y[1]]))
    st, ev_t = _port_events(1e-4, ATOL, problem=prob)
    assert ret == 0 and len(ev_o) == 0 and ev_t == []
    assert int(st.nge) > 0 and int(st.nst) == 362


def test_close_roots_status():
    # y = t; g = max(0, 0.5 - t) is exactly 0 on [0.5, inf): the re-check at
    # the returned root finds the same component zero at the probe point too
    prob = TProblem(n=1, res=lambda t, yy, yp: yp - 1.0, nroots=1,
                    root=lambda t, yy, yp: torch.clamp(0.5 - t, min=0.0).reshape(1))
    st = init_state(prob, [0.0], [1.0], device="cpu")
    tol = TolControl(torch.tensor(1e-6, dtype=torch.float64), torch.tensor(1e-8, dtype=torch.float64))
    st, tret, ist = tsolve(st, prob, IdaOptions(), tol, 1.0)
    assert int(ist) == C.ROOT_RETURN and float(tret) >= 0.5
    st, tret, ist = tsolve(st, prob, IdaOptions(), tol, 1.0)
    assert int(ist) == C.CLOSE_ROOTS


# ------------------------------------------------------- budgeted, with roots


def test_budgeted_rooted_solve_equals_unbudgeted():
    b = 4
    params = _params(b)
    prob = troberts(params_from_numpy(params, device="cpu"), with_roots=True)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st0 = to_native(init_state(prob, yy0, yp0, device="cpu"))
    tol = TolControl(torch.full((b,), 1e-4, dtype=torch.float64),
                     torch.tensor(ATOL, dtype=torch.float64).reshape(3, 1).expand(3, b))
    ref = st0
    got = st0
    for tout, code in ((0.4, C.ROOT_RETURN), (0.4, C.SUCCESS)):
        ref, rtret, rist = tsolve(ref, prob, IdaOptions(), tol, tout)
        out = tsolve(got, prob, IdaOptions(), tol, tout, max_attempts=7)
        launches = 1
        while bool((out[2] == C.CONTINUE).any()):
            out = tsolve(out[0], prob, IdaOptions(), tol, tout, max_attempts=7, resume_carry=out[3])
            launches += 1
        got = out[0]
        assert rist.tolist() == [code] * b and launches > (1 if code == C.ROOT_RETURN else 0)
        assert torch.equal(out[1], rtret) and torch.equal(out[2], rist)
        for f in ref._fields:
            if f != "pdata":
                a, c = getattr(ref, f), getattr(got, f)
                assert torch.equal(a, c) or bool(((a == c) | (a != a) & (c != c)).all()), f
