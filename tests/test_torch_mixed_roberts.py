"""The mixed-precision modes over the 12 decades of the Roberts acceptance run
with roots, against ``ida_tpu``'s own gates and its jitted run (pinned:
``mixed_roberts12_jax``): the final state, the roots, the per-decade steps
within the integration tolerance of full and of ``ida_tpu``, the
statistics of single (split from tests/test_torch_mixed_precision.py, whose
helpers they share).
"""

import numpy as np
import pytest
import torch

from test_torch_mixed_precision import CHECK_ANS, _wrms
from test_torch_mixed_precision import roberts12

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["single", "refined"])
def test_roberts_mode_final_state(roberts12, mode):
    # the reference check_ans (examples/roberts.rs:9-51): WRMS < 1
    t_final, y_final = roberts12[mode][2][-1]
    assert t_final == 4.0e10
    assert _wrms(y_final, CHECK_ANS) < 1.0


@pytest.mark.parametrize("mode", ["single", "refined"])
def test_roberts_mode_roots(roberts12, mode):
    roots = roberts12[mode][1]
    assert [r[1] for r in roots] == [(0, 1), (-1, 0)]
    np.testing.assert_allclose(roots[0][0], 2.6402e-01, rtol=1e-3)
    np.testing.assert_allclose(roots[1][0], 2.0788e7, rtol=1e-2)
    # and the jitted ida_tpu's events of the same mode, within the root
    # integration tolerance (another step sequence: 1.8e-4 apart at 2e7)
    jroots = roberts12["jax_" + mode][1]
    assert [r[1] for r in jroots] == [r[1] for r in roots]
    np.testing.assert_allclose([r[0] for r in roots], [r[0] for r in jroots], rtol=1e-3)


@pytest.mark.parametrize("mode", ["single", "refined"])
def test_roberts_mode_tracks_full_and_ida_tpu(roberts12, mode):
    # every output row within the check_ans metric of the port's "full" run
    # and of ida_tpu's jitted run of the mode (two rtol = 1e-4 solutions
    # with different step sequences: a few units; a broken float32 solve
    # gives 100+, tests/test_mixed_precision.py)
    rows = roberts12[mode][2]
    for other in ("full", "jax_" + mode):
        for (ts, ys), (tf, yf) in zip(rows, roberts12[other][2]):
            assert ts == tf
            assert _wrms(ys, yf) < 10.0, (mode, other, ts)


def test_roberts_single_statistics_sane(roberts12):
    # ida_tpu's windows (tests/test_mixed_precision.py): the late decades'
    # cond(J) ~ 1e9 beats float32, so Newton retries with fresh Jacobians
    ida = roberts12["single"][0]
    assert 250 <= ida.get_num_steps() <= 550
    assert ida.get_num_res_evals() <= 810
    assert ida.get_num_jac_evals() <= 250
    assert ida.get_num_nonlin_solv_conv_fails() <= 60
    jax_steps = roberts12["jax_single"][0]
    assert abs(ida.get_num_steps() - jax_steps) <= 0.1 * jax_steps
