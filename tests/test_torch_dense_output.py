"""The port's dense output: ``core.solve.solve_dense`` and ``interp.get_dky``.

* ``solve_dense`` against the port's own scan form (one ``solve`` call per
  grid row, re-entered through ROOT_RETURNs), bit for bit: one lane, a
  heterogeneous batch, per-lane ``tstop``, rows that fail (``mxstep``) beside
  rows that do not, a lane frozen by a first-call input error, and events with
  an event buffer that is too small.
* ``solve_dense`` against the JAX ``solve_dense`` run op by op on a short
  grid with roots: rows, events and the final state bit for bit; and
  against the jitted one over 12 decades (both JAX runs pinned:
  tests/make_torch_refs.py, ``dense_output_jax``).
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
from make_torch_refs import load

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


def test_roots_need_an_event_buffer():
    st, prob, tol = _setup(2, roots=True)
    with pytest.raises(ValueError, match="max_events"):
        solve_dense(st, prob, IdaOptions(), tol, DECADES[:2])


SHORT_TOUTS = [0.1, 0.3]
EVENT_FIELDS = ("t", "iroots", "yy", "yp", "count")


def _jax_dense_short():
    """The JAX ``solve_dense`` of one lane with roots over SHORT_TOUTS, run
    op by op: its rows, events and final state."""
    jprob = jroberts_problem(with_roots=True)
    jst = jinit(jprob, ROBERTS_YY0, ROBERTS_YP0)
    jtol = JTol(jnp.asarray(1e-4), jnp.asarray(ATOL))
    with jax.disable_jit():
        ref = jdense(jst, jprob, JOptions(), jtol, jnp.asarray(SHORT_TOUTS), max_events=2)
    return {"rows": [np.asarray(r) for r in ref[1:6]],
            "events": {name: np.asarray(getattr(ref[6], name)) for name in EVENT_FIELDS},
            "state": {f: np.asarray(x) for f, x in zip(ref[0]._fields, ref[0])
                      if isinstance(x, jax.Array)}}


def _jax_dense_decades():
    """The jitted JAX ``solve_dense`` of the nominal lane with roots over the
    12 decades."""
    jprob = jroberts_problem(with_roots=True)
    jst = jinit(jprob, ROBERTS_YY0, ROBERTS_YP0)
    jtol = JTol(jnp.asarray(1e-4), jnp.asarray(ATOL))
    ref = jax.jit(lambda s: jdense(s, jprob, JOptions(), jtol, jnp.asarray(DECADES),
                                   max_events=3))(jst)
    return {"rows": {str(k): np.asarray(ref[k]) for k in (1, 2, 3, 5)},
            "counters": {f: int(getattr(ref[0], f))
                         for f in ("nst", "nre", "nje", "nni", "netf", "ncfn", "nge", "kused")},
            "events": {name: np.asarray(getattr(ref[6], name))
                       for name in ("t", "iroots", "count")}}


# what the pinned JAX runs (jax_dense_live) are computed from
REF_INPUTS = {"yy0": ROBERTS_YY0, "yp0": ROBERTS_YP0, "atol": ATOL, "short_touts": SHORT_TOUTS,
              "decades": DECADES}


def jax_dense_live():
    return {"short": _jax_dense_short(), "decades": _jax_dense_decades()}


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX dense runs, pinned (tests/make_torch_refs.py, ``dense_output_jax``)."""
    return load("dense_output_jax", REF_INPUTS)


def test_dense_matches_jax_dense_op_by_op(jax_dense):
    """One lane with roots over a short grid that holds the first root: the
    JAX ``solve_dense`` run op by op and the port's agree in every row, every
    event and every field of the final state."""
    ref = jax_dense["short"]
    tprob = troberts_problem(with_roots=True, device="cpu")
    tst = init_state(tprob, ROBERTS_YY0, ROBERTS_YP0, device="cpu")
    ttol = TolControl(torch.tensor(1e-4, dtype=torch.float64), torch.tensor(ATOL, dtype=torch.float64))
    got = solve_dense(tst, tprob, IdaOptions(), ttol, SHORT_TOUTS, max_events=2)
    for name, a, b in zip(("tret", "istate", "yy", "yp", "nst"), got[1:6], ref["rows"]):
        assert b.dtype == a.numpy().dtype, name
        np.testing.assert_array_equal(a.numpy(), b, name)
    for name in EVENT_FIELDS:
        a, b = getattr(got[6], name).numpy(), ref["events"][name]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    assert int(got[6].count) == 1
    assert "yy" in ref["state"] and "phi" in ref["state"]
    for f, b in ref["state"].items():
        np.testing.assert_array_equal(getattr(got[0], f).numpy(), b, f)


def test_twelve_decades_with_events_match_the_jitted_jax_dense(jax_dense):
    """The nominal lane over the 12 decades with roots: status, cumulative
    steps, every counter with ``nge``, event count and signs exactly; floats
    as far as the jitted run's contracted multiply-adds allow (1e-9 at the
    first event, 1e-7 later). Off the nominal parameters the jitted run's
    rounding moves single steps, so only this lane is held exactly."""
    ref = jax_dense["decades"]
    tprob = troberts_problem(with_roots=True, device="cpu")
    tst = init_state(tprob, ROBERTS_YY0, ROBERTS_YP0, device="cpu")
    ttol = TolControl(torch.tensor(1e-4, dtype=torch.float64), torch.tensor(ATOL, dtype=torch.float64))
    got = solve_dense(tst, tprob, IdaOptions(), ttol, DECADES, max_events=3)
    for k in (1, 2, 5):
        np.testing.assert_array_equal(got[k].numpy(), ref["rows"][str(k)])
    for f in ("nst", "nre", "nje", "nni", "netf", "ncfn", "nge", "kused"):
        assert int(getattr(got[0], f)) == ref["counters"][f], f
    assert int(got[0].nge) == 393  # 11 fewer than the re-entered solve: no per-row re-entry checks
    assert int(got[6].count) == int(ref["events"]["count"]) == 2
    np.testing.assert_array_equal(got[6].iroots.numpy(), ref["events"]["iroots"])
    np.testing.assert_allclose(got[6].t[0].numpy(), ref["events"]["t"][0], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[6].t[1].numpy(), ref["events"]["t"][1], rtol=1e-7, atol=0)
    np.testing.assert_allclose(got[3].numpy(), ref["rows"]["3"], rtol=1e-7, atol=0)


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
