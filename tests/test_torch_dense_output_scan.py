"""``solve_dense`` against the port's own scan form (one ``solve`` call a grid
row, re-entered through ROOT_RETURNs), bit for bit: one lane over 12
decades, a heterogeneous batch, per-lane grids and ``tstop``, a ``tstop`` on a
grid row, and rows that fail beside rows that do not (split from
tests/test_torch_dense_output.py, whose helpers they share); events with a
buffer that is too small in ``test_torch_dense_output_events.py``, a file
of one test, which queues last.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ida_tpu.core.solve import solve_dense as jdense
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.core.state import init_state as jinit
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.solve import solve_dense
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.models import roberts_problem as troberts_problem
from ida_tpu_torch.tol_control import TolControl
from test_torch_dense_output import ATOL, DECADES, _setup, assert_rows_equal, scan_form

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


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
