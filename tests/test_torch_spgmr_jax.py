"""``ops.spgmr`` against ``ida_tpu``'s SPGMR on the same systems (plain and
preconditioned, modified and classical Gram-Schmidt) (split from
tests/test_torch_spgmr.py, whose helpers they share).
"""

import numpy as np
import pytest
import torch

from ida_tpu_torch.ops.spgmr import spgmr_solve
from test_torch_spgmr import CASES, GS, _run
from test_torch_spgmr import jax_results

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.mark.parametrize("gs", GS)
@pytest.mark.parametrize("name", list(CASES))
def test_spgmr_matches_ida_tpu(jax_results, name, gs):
    case = CASES[name]()
    res = _run(torch.from_numpy, spgmr_solve, case, gs, torch.tensor(1e-10, dtype=torch.float64))
    ref = jax_results[name, gs]
    scale = np.abs(ref["x"]).max()
    np.testing.assert_allclose(res.x.numpy(), ref["x"], rtol=1e-12, atol=1e-12 * scale)
    for k in ("converged", "nli", "nps", "natimes"):
        assert np.array_equal(getattr(res, k).numpy(), ref[k]), k
    assert np.array_equal(res.reduced.numpy(), ref["reduced"])
    if name == "batched_30x4":
        assert res.converged.tolist() == [True, True, True, False]
        assert res.reduced.tolist() == [False, False, False, True]
    else:
        assert bool(res.converged) and int(res.nps) > 0
