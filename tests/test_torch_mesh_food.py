"""The 8 x 8 food web (N = 128) with its state vector over four gloo ranks
on the CPU, against the port's unsharded run and ``ida_tpu``'s sharded
programs (``tests/test_torch_mesh.py`` has the setting; four gloo ranks
spawned once for this module).

``sharded_calc_ic("ya_ydp")`` and two legs, the block-diagonal
preconditioner on each rank's 16 grid points, and four lanes over the
2 x 2 mesh: bit for bit the port's unsharded run, ``ida_tpu``'s counters
(its jitted program on the state over 8 devices), and its values within
``tests/test_torch_krylov_path.py``'s food-web bound (1e-9 relative, the
atol floor). The direct solvers on a sharded state are refused (ROADMAP.md
item 12). The other cases of the food web are
``tests/test_torch_mesh_food_modes.py``'s.
"""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import heat2d_ic, heat2d_problem
from ida_tpu_torch.parallel import sharded_calc_ic, sharded_solve
from ida_tpu_torch.tol_control import tol_ss
from test_torch_mesh import (HEAT_TOL, _close, _jax_calls, _same, _same_calls,  # noqa: F401
                             food_unsharded_of, jax_food)

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the food web's IC, base legs and 2 x 2 mesh
    (one spawn)."""
    return R.spawn(str(tmp_path_factory.mktemp("mesh_food")), ("food", "food_2d"))


@pytest.fixture(scope="module")
def food_unsharded():
    return food_unsharded_of(("base",), two_d=True)


def test_sharded_foodweb_calc_ic_and_legs(ranks, food_unsharded, jax_food):
    # idaFoodWeb_kry_p's deployment: the IC and the two legs bit for bit the
    # unsharded run, ida_tpu's counters, its values within 1e-9; the
    # block-diagonal preconditioner on each rank's 16 grid points (pdata
    # its slice of the unsharded pdata), the IC one gather a field
    ref = jax_food
    assert ref["ic"]["ok"] and ref["ic"]["devices"] == 8 and food_unsharded["ic_ok"]
    npts = R.FOOD_M ** 2 // R.WORLD
    for k, rank in enumerate(ranks):
        food = rank["food"]
        assert food["ic_ok"] and food["ic_collectives"]["calls"] == 3
        for got, want in zip(food["ic"], food_unsharded["ic"]):
            assert _same(got, want)
        assert food["pdata0_shapes"] == [(npts, 2, 2), (npts, 2)]
        _same_calls(food["base"]["calls"], food_unsharded["base"])
        assert food["base"]["collectives"]["calls"] > 0
        for got, want in zip(food["base"]["pdata"], food_unsharded["pdata"]):
            assert _same(got, want[k * npts:(k + 1) * npts])
    _close(ranks[0]["food"]["ic"][0], ref["ic"]["phi0"])
    _close(ranks[0]["food"]["ic"][1], ref["ic"]["phi1"])
    _jax_calls(ranks[0]["food"]["base"]["calls"], ref["base"])
    assert ref["base"][-1]["counters"]["nps"] > 0 and ref["base"][-1]["counters"]["nje"] == 0


def test_sharded_foodweb_2d_mesh(ranks, food_unsharded, jax_food):
    # four lanes over the 2 x 2 (batch x state) mesh: each rank 2 lanes of
    # 32 grid points
    want, ref = food_unsharded["2d"], jax_food["2d"]
    assert ref["devices"] == 8 and np.all(ref["ic_ok"]) and np.all(want["ic_ok"])
    for rank in ranks:
        got = rank["food_2d"]
        assert np.all(got["ic_ok"]) and _same(got["ic_yy"], want["ic_yy"])
        assert got["local_pdata"] == [(R.FOOD_M ** 2 // 2, 2, 2, 2), (R.FOOD_M ** 2 // 2, 2, 2)]
        for a, b, j in zip(got["calls"], want["calls"], ref["calls"]):
            assert np.all(a["istate"] == C.SUCCESS) and _same(a["yy"], b["yy"])
            for f in R.COUNTERS:
                assert _same(a["counters"][f], b["counters"][f]), f
                np.testing.assert_array_equal(a["counters"][f], j["counters"][f], err_msg=f)
    for a, j in zip(ranks[0]["food_2d"]["calls"], ref["calls"]):
        _close(a["yy"], j["yy"])


@pytest.mark.parametrize("solver", ["dense", "band"])
def test_the_direct_solvers_are_still_refused(solver):
    # ROADMAP.md item 12: their Jacobian reads the whole state
    prob = heat2d_problem(4, device="cpu")
    opts = IdaOptions(linear_solver=solver, band_mu=4, band_ml=4)
    st = init_state(prob, *heat2d_ic(4), opts=opts, device="cpu")
    tol = tol_ss(*HEAT_TOL, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        sharded_solve(st, prob, opts, tol, 0.01, mesh=None)
    with pytest.raises(NotImplementedError, match="item 12"):
        sharded_calc_ic(st, prob, opts, tol, "y", 0.01, mesh=None)
