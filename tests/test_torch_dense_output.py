"""The port's dense output: ``core.solve.solve_dense`` and ``interp.get_dky``.

* ``solve_dense`` against the port's own scan form (one ``solve`` call per
  grid row, re-entered through ROOT_RETURNs), bit for bit: one lane, a
  heterogeneous batch, per-lane ``tstop``, rows that fail (``mxstep``) beside
  rows that do not, a lane frozen by a first-call input error, and events with
  an event buffer that is too small.
* ``solve_dense`` against the JAX ``solve_dense`` run op by op on a short
  grid with roots: rows, events and the final state bit for bit.
* ``get_dky`` against the JAX ``get_dky`` run op by op on mid-flight states,
  one lane and (under ``vmap``) B = 8, every order k <= kused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core import interp as ji
from ida_tpu.core.solve import TASK_ONE_STEP
from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.solve import solve_dense as jdense
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.core.state import init_state as jinit
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.models import roberts_problem as jroberts_problem
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu_torch import constants as C
from ida_tpu_torch.core import interp as ti
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.core.solve import solve_dense
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.models import roberts_problem as troberts_problem
from ida_tpu_torch.parallel import to_native
from ida_tpu_torch.tol_control import TolControl
from ida_tpu_torch.utils.convert import params_from_numpy, state_from_numpy
from ida_tpu_torch.utils.tree import tree_where

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

ATOL = [1e-8, 1e-6, 1e-6]
DECADES = [0.4 * 10**k for k in range(12)]


def _setup(b, roots, spread=0.2):
    """Batch-native state, problem and tolerances of a B-lane Roberts sweep."""
    params = np.outer(np.exp(np.linspace(-spread, spread, b)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    prob = troberts(params_from_numpy(params, device="cpu"), with_roots=roots)
    st = to_native(init_state(prob, yy0, yp0, device="cpu"))
    tol = TolControl(torch.full((b,), 1e-4, dtype=torch.float64),
                     torch.tensor(ATOL, dtype=torch.float64).reshape(3, 1).expand(3, b))
    return st, prob, tol


def scan_form(st, prob, opts, tol, touts, max_events=0):
    """One ``solve`` per row; lanes that return a root are re-entered (the
    others keep their result) and their events collected. Returns the rows
    like ``solve_dense`` and the events as per-lane lists."""
    bshape = st.tn.shape
    events = [[] for _ in range(max(st.tn.numel(), 1))]
    rows = []
    for k in range(len(touts)):
        tout = touts[k]
        st, tret, ist = tsolve(st, prob, opts, tol, tout)
        while bool((ist == C.ROOT_RETURN).any()):
            hit = (ist == C.ROOT_RETURN).reshape(-1)
            for lane in torch.nonzero(hit).reshape(-1).tolist():
                events[lane].append((tret.reshape(-1)[lane].item(),
                                     st.iroots.reshape(st.iroots.shape[0], -1)[:, lane].tolist(),
                                     st.yy.reshape(3, -1)[:, lane].clone()))
            st, tret, ist = _reenter_once(st, tret, ist, prob, opts, tol, tout)
        rows.append((tret, ist, st.yy, st.yp, st.nst))
    assert st.tn.shape == bshape
    return st, [torch.stack([r[j] for r in rows]) for j in range(5)], events


def _reenter_once(st, tret, ist, prob, opts, tol, tout):
    """One more ``solve`` for the lanes at a root; the rest keep their carry."""
    hit = ist == C.ROOT_RETURN
    st2, tret2, ist2 = tsolve(st, prob, opts, tol, tout)
    return tree_where(hit, st2, st), torch.where(hit, tret2, tret), torch.where(hit, ist2, ist)


def assert_rows_equal(dense, scan, lanes=None):
    names = ("tret", "istate", "yy", "yp", "nst")
    for name, a, b in zip(names, dense[1:6], scan):
        if lanes is not None:
            a, b = a[..., lanes], b[..., lanes]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_one_lane_twelve_decades_equals_scan_form():
    prob = troberts_problem(with_roots=False, device="cpu")
    st = init_state(prob, ROBERTS_YY0, ROBERTS_YP0, device="cpu")
    tol = TolControl(torch.tensor(1e-4, dtype=torch.float64), torch.tensor(ATOL, dtype=torch.float64))
    out = solve_dense(st, prob, IdaOptions(), tol, DECADES)
    sst, rows, _ = scan_form(st, prob, IdaOptions(), tol, DECADES)
    assert_rows_equal(out, rows)
    assert out[2].tolist() == [C.SUCCESS] * 12 and out[1].tolist() == DECADES
    assert out[5].tolist() == [29, 43, 68, 95, 126, 161, 202, 250, 293, 325, 348, 362]
    for f in ("phi", "psi", "tn", "hh", "kk", "nre", "nni", "nje", "netf"):
        assert torch.equal(getattr(out[0], f), getattr(sst, f)), f
    assert int(out[0].status) == C.SUCCESS


def test_heterogeneous_batch_equals_scan_form():
    # a wide parameter spread: lanes reach their rows many passes apart
    st, prob, tol = _setup(4, roots=False, spread=1.0)
    touts = DECADES[:8]
    out = solve_dense(st, prob, IdaOptions(), tol, touts)
    _, rows, _ = scan_form(st, prob, IdaOptions(), tol, touts)
    assert_rows_equal(out, rows)
    assert bool((out[2] == C.SUCCESS).all())
    assert len(set(out[5][-1].tolist())) > 1  # the lanes really differ


def test_per_lane_grids_equal_scan_form():
    st, prob, tol = _setup(3, roots=False)
    touts = torch.tensor(DECADES[:5], dtype=torch.float64).reshape(5, 1) * torch.tensor(
        [1.0, 0.5, 2.0], dtype=torch.float64)
    out = solve_dense(st, prob, IdaOptions(), tol, touts)
    _, rows, _ = scan_form(st, prob, IdaOptions(), tol, touts)
    assert_rows_equal(out, rows)
    assert torch.equal(out[1], touts)


def test_per_lane_tstop_equals_scan_form():
    # lane 0 stops at 30, lane 1 has no stop time, lane 2 stops at 700
    st, prob, tol = _setup(3, roots=False)
    st = st._replace(tstop=torch.tensor([30.0, 0.0, 700.0], dtype=torch.float64),
                     tstop_set=torch.tensor([True, False, True]))
    touts = DECADES[:5]
    out = solve_dense(st, prob, IdaOptions(), tol, touts)
    sst, rows, _ = scan_form(st, prob, IdaOptions(), tol, touts)
    assert_rows_equal(out, rows)
    assert out[2][:, 0].tolist() == [0, 0, C.TSTOP_RETURN, 0, 0]
    assert out[1][2, 0].item() == 30.0
    assert out[2][:, 1].tolist() == [0] * 5
    assert out[2][:, 2].tolist() == [0, 0, 0, 0, C.TSTOP_RETURN] and out[1][4, 2].item() == 700.0
    assert not bool(out[0].tstop_set.any()) and torch.equal(out[0].tstop_set, sst.tstop_set)


def test_tstop_exactly_on_a_grid_row_follows_the_jax_package():
    """A stop time equal to a grid point: the step lands on it, the row is
    recorded as SUCCESS with tstop still set, and the clamp to tstop then
    makes the next step size zero, so ``solve_dense`` records every later
    row there without stepping (the scan form returns TSTOP_RETURN and goes
    on). The JAX package does this; the port is held to it, not to the scan
    form."""
    p = np.exp(0.2) * ROBERTS_PARAMS
    yp0 = p[0] * np.array([-1.0, 1.0, 0.0])
    touts = DECADES[:5]
    jprob = jroberts(jnp.asarray(p))
    jtol = JTol(jnp.asarray(1e-4), jnp.asarray(ATOL))
    jst = jinit(jprob, ROBERTS_YY0, yp0)._replace(tstop=jnp.asarray(40.0), tstop_set=jnp.asarray(True))
    ref = jax.jit(lambda s: jdense(s, jprob, JOptions(), jtol, jnp.asarray(touts)))(jst)
    tprob = troberts(torch.from_numpy(p))
    tst = init_state(tprob, ROBERTS_YY0, yp0, device="cpu")._replace(
        tstop=torch.tensor(40.0, dtype=torch.float64), tstop_set=torch.tensor(True))
    ttol = TolControl(torch.tensor(1e-4, dtype=torch.float64), torch.tensor(ATOL, dtype=torch.float64))
    got = solve_dense(tst, tprob, IdaOptions(), ttol, touts)
    assert got[2].tolist() == np.asarray(ref[2]).tolist() == [C.SUCCESS] * 5
    assert got[1].tolist() == np.asarray(ref[1]).tolist() == touts
    assert got[5].tolist() == np.asarray(ref[5]).tolist() and got[5][2:].tolist() == [71, 71, 71]
    assert float(got[0].hh) == float(ref[0].hh) == 0.0


def test_failed_rows_leave_the_other_lanes_alone():
    # mxstep 40 is too few for the later decades of some lanes: those rows
    # carry TOO_MUCH_WORK, the lane goes on, its neighbours never notice
    st, prob, tol = _setup(4, roots=False, spread=1.0)
    opts = IdaOptions(mxstep=40)
    out = solve_dense(st, prob, opts, tol, DECADES[:9])
    _, rows, _ = scan_form(st, prob, opts, tol, DECADES[:9])
    assert_rows_equal(out, rows)
    codes = set(out[2].reshape(-1).tolist())
    assert codes == {C.SUCCESS, C.TOO_MUCH_WORK}


def test_first_call_input_error_freezes_its_lane_only():
    st, prob, tol = _setup(3, roots=False)
    st = st._replace(tstop=torch.tensor([0.0, -1.0, 0.0], dtype=torch.float64),
                     tstop_set=torch.tensor([False, True, False]))  # tstop behind t0
    touts = DECADES[:4]
    out = solve_dense(st, prob, IdaOptions(), tol, touts)
    _, rows, _ = scan_form(st, prob, IdaOptions(), tol, touts)
    assert out[2][:, 1].tolist() == [C.ILL_INPUT] * 4 == rows[1][:, 1].tolist()
    assert out[1][:, 1].tolist() == [0.0] * 4 and int(out[0].nst[1]) == 0
    assert_rows_equal(out, rows, lanes=[0, 2])
    assert int(out[0].status[1]) == C.ILL_INPUT


def test_events_with_a_buffer_that_is_too_small():
    # through 4e8: both roots of every lane lie before it
    b, touts = 3, DECADES[:10]
    st, prob, tol = _setup(b, roots=True)
    out1 = solve_dense(st, prob, IdaOptions(), tol, touts, max_events=1)
    out3 = solve_dense(st, prob, IdaOptions(), tol, touts, max_events=3)
    _, rows, events = scan_form(st, prob, IdaOptions(), tol, touts)
    for out in (out1, out3):
        assert_rows_equal(out, rows)
        assert out[6].count.tolist() == [2] * b  # the true total, whatever fits
    ev1, ev3 = out1[6], out3[6]
    assert ev1.t.shape == (1, b) and ev3.t.shape == (3, b) and ev3.iroots.shape == (3, 2, b)
    for lane in range(b):
        assert len(events[lane]) == 2
        for e, (t, iroots, yy) in enumerate(events[lane]):
            assert ev3.t[e, lane].item() == t
            assert ev3.iroots[e, :, lane].tolist() == iroots
            assert torch.equal(ev3.yy[e, :, lane], yy)
        assert ev3.t[2, lane].item() == 0.0  # the unused row
        assert ev1.t[0, lane].item() == events[lane][0][0]  # the first is kept
    # rows are those of the problem without roots
    st0, prob0, _ = _setup(b, roots=False)
    plain = solve_dense(st0, prob0, IdaOptions(), tol, touts)
    assert torch.equal(plain[5], out3[5]) and torch.equal(plain[3], out3[3])


def test_roots_need_an_event_buffer():
    st, prob, tol = _setup(2, roots=True)
    with pytest.raises(ValueError, match="max_events"):
        solve_dense(st, prob, IdaOptions(), tol, DECADES[:2])


def test_dense_matches_jax_dense_op_by_op():
    """One lane with roots over a short grid that holds the first root: the
    JAX ``solve_dense`` run op by op and the port's agree in every row, every
    event and every field of the final state."""
    jprob = jroberts_problem(with_roots=True)
    jst = jinit(jprob, ROBERTS_YY0, ROBERTS_YP0)
    jtol = JTol(jnp.asarray(1e-4), jnp.asarray(ATOL))
    touts = [0.1, 0.3]
    with jax.disable_jit():
        ref = jdense(jst, jprob, JOptions(), jtol, jnp.asarray(touts), max_events=2)
    tprob = troberts_problem(with_roots=True, device="cpu")
    tst = init_state(tprob, ROBERTS_YY0, ROBERTS_YP0, device="cpu")
    ttol = TolControl(torch.tensor(1e-4, dtype=torch.float64), torch.tensor(ATOL, dtype=torch.float64))
    got = solve_dense(tst, tprob, IdaOptions(), ttol, touts, max_events=2)
    for name, a, b in zip(("tret", "istate", "yy", "yp", "nst"), got[1:6], ref[1:6]):
        assert b.dtype == a.numpy().dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    for name in ("t", "iroots", "yy", "yp", "count"):
        a, b = getattr(got[6], name).numpy(), np.asarray(getattr(ref[6], name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    assert int(got[6].count) == 1
    for f in ref[0]._fields:
        if f != "pdata":
            np.testing.assert_array_equal(getattr(got[0], f).numpy(), np.asarray(getattr(ref[0], f)), f)


def test_twelve_decades_with_events_match_the_jitted_jax_dense():
    """The nominal lane over the 12 decades with roots: status, cumulative
    steps, every counter with ``nge``, event count and signs exactly; floats
    as far as the jitted run's contracted multiply-adds allow (1e-9 at the
    first event, 1e-7 later). Off the nominal parameters the jitted run's
    rounding moves single steps, so only this lane is held exactly."""
    jprob = jroberts_problem(with_roots=True)
    jst = jinit(jprob, ROBERTS_YY0, ROBERTS_YP0)
    jtol = JTol(jnp.asarray(1e-4), jnp.asarray(ATOL))
    ref = jax.jit(lambda s: jdense(s, jprob, JOptions(), jtol, jnp.asarray(DECADES), max_events=3))(jst)
    tprob = troberts_problem(with_roots=True, device="cpu")
    tst = init_state(tprob, ROBERTS_YY0, ROBERTS_YP0, device="cpu")
    ttol = TolControl(torch.tensor(1e-4, dtype=torch.float64), torch.tensor(ATOL, dtype=torch.float64))
    got = solve_dense(tst, tprob, IdaOptions(), ttol, DECADES, max_events=3)
    for k in (1, 2, 5):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for f in ("nst", "nre", "nje", "nni", "netf", "ncfn", "nge", "kused"):
        assert int(getattr(got[0], f)) == int(getattr(ref[0], f)), f
    assert int(got[0].nge) == 393  # 11 fewer than the re-entered solve: no per-row re-entry checks
    assert int(got[6].count) == int(ref[6].count) == 2
    np.testing.assert_array_equal(got[6].iroots.numpy(), np.asarray(ref[6].iroots))
    np.testing.assert_allclose(got[6].t[0].numpy(), np.asarray(ref[6].t)[0], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[6].t[1].numpy(), np.asarray(ref[6].t)[1], rtol=1e-7, atol=0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-7, atol=0)


# ------------------------------------------------------------------ get_dky


@pytest.fixture(scope="module")
def midflight():
    """JAX states 12 steps into the run: B = 8 batch-leading, and its lane 3
    as one unbatched lane."""
    tol = JTol(jnp.asarray(1e-4), jnp.asarray(ATOL))
    b = 8
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, b)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    bst = jensemble_init(jroberts, jnp.asarray(params), jnp.asarray(yy0), jnp.asarray(yp0))
    step = jax.jit(jax.vmap(
        lambda s, p: jsolve(s, jroberts(p), JOptions(), tol, jnp.asarray(400.0), TASK_ONE_STEP)[0]))
    for _ in range(12):
        bst = step(bst, jnp.asarray(params))
    return jax.tree_util.tree_map(lambda x: x[3], bst), bst


def _port_state(jst, batch):
    return state_from_numpy({f: (() if f == "pdata" else np.asarray(getattr(jst, f)))
                             for f in jst._fields}, device="cpu", batch=batch)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_get_dky_one_lane_matches_jax(midflight, k):
    jst, _ = midflight
    assert int(jst.kused) >= 2
    for frac in (0.0, 0.37, 1.0):
        t = jst.tn - frac * jst.hused
        with jax.disable_jit():
            ref, ref_ok = ji.get_dky(jst, t, k)
        got, ok = ti.get_dky(_port_state(jst, "trailing"), torch.from_numpy(np.array(t)), k)
        assert bool(ok) == bool(ref_ok) == (k <= int(jst.kused))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # outside the last step
    _, ok = ti.get_dky(_port_state(jst, "trailing"),
                       torch.from_numpy(np.array(jst.tn - 2.5 * jst.hused)), k)
    assert not bool(ok)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_get_dky_batch_matches_jax(midflight, k):
    _, bst = midflight
    t = bst.tn - 0.25 * bst.hused
    with jax.disable_jit():
        ref, ref_ok = jax.vmap(lambda s, tt: ji.get_dky(s, tt, k))(bst, t)
    got, ok = ti.get_dky(_port_state(bst, "leading"), torch.from_numpy(np.array(t)), k)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).T)


def test_get_dky_order_zero_is_get_solution(midflight):
    jst, bst = midflight
    for st, batch in ((jst, "trailing"), (bst, "leading")):
        st = _port_state(st, batch)
        t = st.tn - 0.4 * st.hused
        dky, _ = ti.get_dky(st, t, 0)
        assert torch.equal(dky, ti.get_solution(st, t)[0].yy)
        dky1, _ = ti.get_dky(st, t, 1)
        torch.testing.assert_close(dky1, ti.get_solution(st, t)[0].yp, rtol=1e-12, atol=0)
