"""The port's mesh on a sharded state vector against ``ida_tpu``'s sharded
programs, on the CPU under gloo (``tests/test_torch_mesh.py`` has the
setting; four gloo ranks spawned once for this module).

heat2d m = 16 (SPGMR, diagonal preconditioner) over the four ranks, four
lanes over a 2 x 2 mesh, and the blocked BBD preconditioner: ``ida_tpu``'s
counters, ``yy`` within 1e-9 of max|y| (its sums run in XLA's order), and
bit for bit the port's own unsharded solve (a sharded sum replays the
unsharded tree; ``utils/sharding.py``). These solves make collectives, the
positive control of the dp case, which makes none. A preconditioner without
``pdata_rows`` runs on gathered vectors; a shard that splits a grid point
is refused.
"""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from ida_tpu import constants as JC
from ida_tpu_torch import constants as C
from ida_tpu_torch.models import heat2d_ic, heat2d_problem
from test_torch_mesh import _counters, _heat_unsharded, _same, jax_sharded  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the sharded-N cases and dp (one spawn)."""
    return R.spawn(str(tmp_path_factory.mktemp("mesh_sharded")),
                   ("dp", "heat", "heat_2d", "bbd_hooks", "bbd_solve", "heat_whole_prec",
                    "split_point"))


def test_dp_solve_makes_no_collective_and_sharded_n_does(ranks):
    for rank in ranks:
        assert rank["dp"]["collectives"] == {"calls": 0, "broadcasts": 0, "bytes": 0}
        for case in ("heat", "bbd_solve"):
            coll = rank[case]["collectives"]
            assert coll["calls"] > 0 and coll["broadcasts"] == R.WORLD * coll["calls"]
            assert coll["bytes"] > 0


def test_sharded_heat2d_has_ida_tpus_counters_and_the_unsharded_bits(ranks, jax_sharded):
    prob = heat2d_problem(R.HEAT_M, device="cpu")
    st1, _, ist1 = _heat_unsharded(prob)
    ref = jax_sharded["heat"]
    assert ref["devices"] == 8 and ref["istate"] == JC.SUCCESS and int(ist1) == C.SUCCESS
    for rank in ranks:
        heat = rank["heat"]
        assert heat["istate"] == C.SUCCESS and heat["pdata_rows"] == prob.n // R.WORLD
        assert heat["counters"] == {f: int(v) for f, v in _counters(st1).items()}
        assert heat["counters"] == {f: int(v) for f, v in ref["counters"].items()}
        assert _same(heat["yy"], st1.yy.numpy())
    y_ref = ref["yy"]
    np.testing.assert_allclose(ranks[0]["heat"]["yy"], y_ref, rtol=0,
                               atol=1e-9 * np.abs(y_ref).max())


def test_2d_mesh_batch_x_state(ranks, jax_sharded):
    st1, _, ist1 = _heat_unsharded(heat2d_problem(R.HEAT_M, device="cpu"), b=4)
    ref = jax_sharded["heat_2d"]
    assert ref["devices"] == 8 and np.all(ref["istate"] == JC.SUCCESS)
    for rank in ranks:
        got = rank["heat_2d"]
        assert got["local_phi"] == (6, R.HEAT_M ** 2 // 2, 2)
        assert np.all(got["istate"] == C.SUCCESS)
        for f in R.COUNTERS:
            assert _same(got["counters"][f], getattr(st1, f).numpy()), f
            np.testing.assert_array_equal(got["counters"][f], ref["counters"][f], err_msg=f)
        assert _same(got["yy"], st1.yy.numpy())
    np.testing.assert_allclose(ranks[0]["heat_2d"]["yy"], ref["yy"], rtol=0,
                               atol=1e-9 * np.abs(ref["yy"]).max())


def test_bbd_blocked_sharded_hooks(ranks, jax_sharded):
    # tests/test_bbd_prec.py::test_bbd_blocked_sharded_hooks: each rank sets
    # up and solves its own block, with no collective in the solve
    prob, bbd = R.bbd_problem(R.BBD_HOOKS_M, R.WORLD)
    u0, up0 = (torch.as_tensor(v) for v in heat2d_ic(R.BBD_HOOKS_M))
    r = torch.as_tensor(np.random.default_rng(1).standard_normal(prob.n))
    t, cj = torch.tensor(0.0, dtype=torch.float64), torch.tensor(3.0, dtype=torch.float64)
    x_plain = bbd.prec_solve(bbd.prec_setup(t, cj, u0, up0, torch.zeros_like(u0)), r, cj).numpy()
    nb = prob.n // R.WORLD
    for rank in ranks:
        hooks = rank["bbd_hooks"]
        assert hooks["lu_shape"] == (13, nb, 1)
        assert hooks["collectives_solve"]["calls"] == 0
        assert _same(hooks["x"], x_plain)
    np.testing.assert_allclose(ranks[0]["bbd_hooks"]["x"], jax_sharded["bbd_hooks"]["x"],
                               rtol=1e-12, atol=1e-14)


def test_bbd_blocked_sharded_solve(ranks, jax_sharded):
    # tests/test_bbd_prec.py::test_bbd_blocked_sharded_solve: the distributed
    # IDABBDPRE deployment, each rank preconditioning its own block
    prob, _ = R.bbd_problem(R.HEAT_M, R.WORLD)
    st1, tret1, ist1 = _heat_unsharded(prob)
    ref = jax_sharded["bbd_solve"]
    assert ref["istate"] == JC.SUCCESS and int(ist1) == C.SUCCESS
    for rank in ranks:
        got = rank["bbd_solve"]
        assert got["istate"] == C.SUCCESS and got["tret"] == float(tret1) == ref["tret"]
        assert got["counters"] == {f: int(v) for f, v in _counters(st1).items()}
        assert _same(got["phi0"], st1.phi[0].numpy())
    np.testing.assert_allclose(ranks[0]["bbd_solve"]["phi0"], ref["phi0"], atol=5e-5)


def test_a_preconditioner_without_pdata_rows_runs_on_gathered_vectors(ranks):
    # pdata whole on every rank, as ida_tpu's GSPMD keeps it
    prob = R.heat_whole_prec(R.HEAT_M)
    st1, _, ist1 = _heat_unsharded(prob)
    for rank in ranks:
        got = rank["heat_whole_prec"]
        assert got["istate"] == C.SUCCESS and got["pdata_shape"] == (prob.n,)
        assert got["counters"] == {f: int(v) for f, v in _counters(st1).items()}
        assert _same(got["yy"], st1.yy.numpy())


def test_a_shard_that_splits_a_grid_point_is_refused(ranks):
    for rank in ranks:
        split = rank["split_point"]
        assert "splits the preconditioner's entries of 2 rows" in split["shard"]
        assert "of N = 12 split one" in split["prec_setup"]
