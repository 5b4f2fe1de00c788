"""``EnsembleIDA`` against the JAX object on the same arrays (roots on, the
call that returns every lane's first root; re-entry and one-step calls), and
``solve_dae`` without events or a grid (split from tests/test_torch_api.py,
whose helpers they share).
"""

import numpy as np
import torch

from ida_tpu_torch import constants as C
from ida_tpu_torch.utils.convert import ensemble_from_numpy
from test_torch_api import TOL, _dae, _ensemble_inputs, rooted_factory
from test_torch_api import ensembles

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_solve_dae_without_events_or_grid():
    sol = _dae()
    assert sol.success and sol.t.tolist() == [40.0] and sol.y.shape == (1, 3)
    assert sol.t_events.shape == (0,) and sol.y_events.shape == (0, 3) and sol.stats["nge"] == 0
    ad = _dae(jac=None)  # forward-mode AD Jacobian
    assert ad.success and ad.stats["nst"] == sol.stats["nst"]
    np.testing.assert_allclose(ad.y, sol.y, rtol=1e-9)


def test_ensemble_solve_matches_the_jax_object(ensembles):
    jens, tens, (jtret, jist), (ttret, tist) = ensembles
    assert isinstance(ttret, np.ndarray) and tist.dtype == jist.dtype == np.int32
    assert tist.tolist() == jist.tolist() == [C.ROOT_RETURN] * 4
    np.testing.assert_allclose(ttret, jtret, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(tens.nst, jens.nst)
    np.testing.assert_allclose(tens.yy, jens.yy, rtol=1e-9, atol=0)
    assert tens.yy.shape == (4, 3) and tens.status_names(tist) == ["ROOT_RETURN"] * 4
    jst, tst = jens.states, tens.states
    for f in ("nge", "nre", "nni", "iroots", "gactive", "irfnd", "kused"):
        a, b = getattr(tst, f).numpy(), np.asarray(getattr(jst, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    assert tens.report_failures(tist) == [] and tens.format_failures() == ""


def test_ensemble_reenters_and_steps_once(ensembles):
    _, tens, _, _ = ensembles
    fresh = ensemble_from_numpy(rooted_factory, *_ensemble_inputs(4), TOL, device="cpu")
    fresh.solve(0.4)
    tret, ist = fresh.solve(0.4)
    assert ist.tolist() == [C.SUCCESS] * 4 and tret.tolist() == [0.4] * 4
    nst = fresh.nst.copy()
    # the internal time is already past 0.4: the first one-step call hands out
    # y(tn) without stepping, the next one steps
    tn, ist = fresh.solve(4.0, one_step=True)
    assert (fresh.nst == nst).all() and ist.tolist() == [C.SUCCESS] * 4 and (tn > 0.4).all()
    tret, ist = fresh.solve(4.0, one_step=True)
    assert (fresh.nst == nst + 1).all() and ist.tolist() == [C.SUCCESS] * 4
    assert (tret > tn).all() and (tret < 4.0).all()
