"""``IDA.calc_ic`` lane by lane against ``ida_tpu``'s, and the batch-native
``calc_ic`` against its vmapped lanes (split from tests/test_torch_calc_ic.py,
whose helpers they share).
"""

import numpy as np
import pytest
import torch

import ida_tpu_torch as port
from ida_tpu_torch.core.calc_ic import IC_CODES
from ida_tpu_torch.core.calc_ic import calc_ic as port_calc_ic
from ida_tpu_torch.models import roberts_problem
from ida_tpu_torch.parallel import to_native
from ida_tpu_torch.utils.convert import ida_from_numpy
from test_torch_calc_ic import ATOL, B, CASES, RTOL, TOL, _close, _lanes
from test_torch_calc_ic import jax_lane_ics

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(CASES))
def test_ida_calc_ic_matches_ida_tpu(jax_lane_ics, name):
    icopt, y0, yp0 = CASES[name]
    lane = [n for n, c in CASES.items() if c[0] == icopt].index(name)
    jy, jp, jok = (x[lane] for x in jax_lane_ics[icopt])
    ida = ida_from_numpy(roberts_problem(with_roots=False, device="cpu"), np.asarray(y0),
                         np.asarray(yp0), TOL, device="cpu")
    ida.calc_ic(icopt, tout1=0.4)
    y, yp = ida.get_consistent_ic()
    assert jok
    _close(y, jy)
    _close(yp, jp)
    np.testing.assert_allclose(y.sum(), 1.0, atol=1e-7)  # the algebraic row holds
    np.testing.assert_array_equal(ida.get_yy(), y)
    tret, status = ida.solve(0.4)  # and the corrected start integrates
    assert status == port.IdaSolveStatus.Success and tret == 0.4


@pytest.mark.parametrize("icopt", list(IC_CODES))
def test_batch_native_calc_ic_matches_vmapped_ida_tpu(jax_lane_ics, icopt):
    y0, yp0 = _lanes(icopt)
    prob = roberts_problem(with_roots=False, device="cpu")
    st = to_native(port.init_state(prob, y0, yp0, device="cpu"))
    tol = port.TolControl(torch.tensor(RTOL, dtype=torch.float64),
                          torch.from_numpy(ATOL).reshape(3, 1))
    out, ok = port_calc_ic(st, prob, port.IdaOptions(), tol, IC_CODES[icopt], 0.4)
    jy, jp, jok = jax_lane_ics[icopt]
    assert ok.tolist() == jok.tolist()
    _close(out.phi[0].t().numpy(), jy)
    _close(out.phi[1].t().numpy(), jp)
    if icopt == "y":
        assert ok.tolist() == [True] * (B - 1) + [False]
        # the failed lane keeps its guesses, in phi and in yy/yp
        for got in (out.phi[0][:, -1], out.yy[:, -1]):
            assert got.tolist() == y0[-1].tolist()
        assert out.phi[1][:, -1].tolist() == yp0[-1].tolist()
    else:
        assert ok.all()
