"""The host build's evaluation entry of each generated model against the
eager problem, on the CPU (``tests/test_torch_fused_models.py`` has the
setting; a file of few tests, so that its builds queue after the suite's
files with the most tests).
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_fused_models import EVAL_MODELS, fused_solve, on_host  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


@pytest.mark.parametrize("name", EVAL_MODELS)
def test_host_build_evaluates_each_model_as_the_eager_problem(on_host, name):
    # the table of ops: res, jac (at that residual) and res_jvp (tangents
    # (v, cj v)) of 256 random lanes through fused_model_eval, bit for bit
    # the eager problem's res, sys_jacobian and jtimes
    factory, p0 = EVAL_MODELS[name]
    rng = np.random.default_rng(3)
    n = factory(torch.from_numpy(p0[:, None])).n
    lanes = 256
    params = torch.from_numpy(p0[:, None] * np.exp(rng.uniform(-0.2, 0.2, (len(p0), lanes))))
    yy = torch.from_numpy(np.abs(rng.normal(size=(n, lanes))) * 0.3 + 0.01)
    args = (params, torch.from_numpy(rng.uniform(0.0, 5.0, lanes)),
            torch.from_numpy(np.exp(rng.uniform(-3.0, 5.0, lanes))), yy,
            torch.from_numpy(rng.normal(size=(n, lanes))),
            torch.from_numpy(rng.normal(size=(n, lanes))))
    model = fused_solve.model_of(factory, params)
    out = {"res": torch.empty(n, lanes, dtype=torch.float64),
           "jac": torch.empty(n, n, lanes, dtype=torch.float64),
           "jv": torch.empty(n, lanes, dtype=torch.float64)}
    a = fused_solve.ModelEvalArgs(*(x.data_ptr() for x in args),
                                  *(x.data_ptr() for x in out.values()), lanes)
    lib = fused_solve.build_eval(model)["lib"]
    assert lib.fused_model_eval_f64(ctypes.byref(a), model.id, None) == 0
    assert lib.fused_model_eval_f64(ctypes.byref(a), model.id + 1, None) != 0
    want = fused_solve.eval_model(factory, *args)  # the plain version on CPU tensors
    for (key, got), w in zip(out.items(), want):
        assert torch.isfinite(w).all(), key
        assert torch.equal(got, w), (key, int((got != w).sum()))
