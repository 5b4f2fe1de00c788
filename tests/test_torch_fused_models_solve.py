"""Generated models in the whole-solve kernel's host build, through whole
solves: Lorenz '63 and Akzo Nobel bit for bit the eager ``core.solve`` in
parity, budget 6 and refined (split from tests/test_torch_fused_models.py,
whose helpers and fixtures they share).
"""

import pytest
import torch

from ida_tpu_torch import constants as C
from ida_tpu_torch.ops import fused_solve
from ida_tpu_torch.parallel import ensemble_init
from ida_tpu_torch.tol_control import tol_ss
from test_torch_fused_host import host_build
from test_torch_fused_models import ATOL, B, MODELS, RTOL, SOLVES, TOUT, _differ, _kernel_solve
from test_torch_fused_models import on_host

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.mark.parametrize("solve", SOLVES)
@pytest.mark.parametrize("name", MODELS)
def test_host_build_of_a_generated_model_is_bitwise_the_eager_solve(on_host, name, solve):
    # f64, B = 8 spread lanes to the model's tout: the kernel of the
    # generated model against make_fused_solve's plain version (the eager
    # core.solve, with the same budgeted host loop), every field
    factory, inputs, _ = MODELS[name]
    opts, budget = SOLVES[solve]
    params, yy0, yp0 = inputs(B)
    st0 = ensemble_init(factory, params, yy0, yp0, device="cpu", opts=opts)
    tol = tol_ss(RTOL, ATOL, device="cpu")
    model, got = _kernel_solve(factory, st0, params, tol, TOUT[name], opts, budget)
    ref = fused_solve.make_fused_solve(factory, tol, opts, attempt_budget=budget)(
        st0, params, TOUT[name])
    assert _differ(got[0], ref[0]) == []
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert bool((ref[2] == C.SUCCESS).all()) and int(ref[0].nst.min()) > 20
    kinds = {"init", "cont"} if budget else {"solve"}
    assert {(k, m) for k, _, m in fused_solve.MODE_LAUNCHES} == {(k, model.name) for k in kinds}
