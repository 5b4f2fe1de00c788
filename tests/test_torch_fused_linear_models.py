"""Generated models under the band and Krylov solvers in the whole-solve
kernel (K2-K4), on the CPU.

The band Jacobian's colored columns and the Krylov operator are jvps of the
residual: the kernel calls the model's ``res_jvp``, which
``ops/fused_model.py`` emits from a trace of ``torch.func.jvp`` with the
params in float64 and the other arguments in float32, each op in the dtype
torch computes it in (``res_jvp<T, S>``; S = T outside ``ls_precision=
"single"``). Here, with the kernel source built for the host
(tests/test_torch_fused_host.py ``host_build``): the quadrature Roberts
(quadratures [y1 + y2 + y3, y1], B = 8 to tout 0.4) and Morris-Lecar
(``models/morris_lecar.py``: tanh and cosh, two quadratures, B = 8 to 2 ms),
f64, K2 and a budget of 6 (K3 + K4) bit for bit the port's eager solve under
band (1, 1) and spgmr, Morris-Lecar also under "single" (whose jvp mixes the
float64 current with float32 voltages), every field (``yQ`` and the Krylov
counters among them).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ida_tpu_torch import constants as C
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.models.morris_lecar import morris_lecar_factory, morris_lecar_inputs
from ida_tpu_torch.ops import fused_solve
from ida_tpu_torch.parallel import ensemble_init
from ida_tpu_torch.tol_control import tol_ss, tol_sv
from test_torch_fused_linear import B, assert_kernel_is_the_eager_solve
from test_torch_fused_models import on_host  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def quad_factory(params):
    """Roberts with the quadratures [y1 + y2 + y3, y1]."""
    return dataclasses.replace(
        roberts_factory(params),
        quad=lambda t, yy, yp: torch.stack([yy[0] + yy[1] + yy[2], yy[0]]), nquad=2)


def roberts_inputs(b):
    params = np.outer(np.linspace(0.9, 1.1, b), ROBERTS_PARAMS)
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, np.tile(ROBERTS_YY0, (b, 1)), yp0


BAND11 = IdaOptions(linear_solver="band", band_mu=1, band_ml=1)
SPGMR = IdaOptions(linear_solver="spgmr")
# name -> (factory, inputs, tolerances, tout, options)
CASES = {
    "roberts_quad-band1_1": (quad_factory, roberts_inputs, (1e-4, [1e-8, 1e-6, 1e-6]), 0.4,
                             BAND11),
    "roberts_quad-spgmr": (quad_factory, roberts_inputs, (1e-4, [1e-8, 1e-6, 1e-6]), 0.4, SPGMR),
    "morris_lecar-band1_1": (morris_lecar_factory, morris_lecar_inputs, (1e-6, 1e-8), 2.0,
                             BAND11),
    "morris_lecar-spgmr": (morris_lecar_factory, morris_lecar_inputs, (1e-6, 1e-8), 2.0, SPGMR),
    "morris_lecar-spgmr-single": (morris_lecar_factory, morris_lecar_inputs, (1e-6, 1e-8), 2.0,
                                  dataclasses.replace(SPGMR, ls_precision="single")),
}


@pytest.mark.parametrize("case", CASES)
def test_generated_model_kernel_is_bitwise_the_eager_solve(on_host, case):
    factory, inputs, (rtol, atol), tout, opts = CASES[case]
    params, yy0, yp0 = inputs(B)
    st0 = ensemble_init(factory, params, yy0, yp0, device="cpu", opts=opts)
    tol = (tol_ss if np.ndim(atol) == 0 else tol_sv)(rtol, atol, device="cpu")
    st, _, istate = assert_kernel_is_the_eager_solve(factory, params, st0, tol, tout, opts)
    model = fused_solve.model_of(factory, torch.as_tensor(params).t())
    assert model.nq == 2 and model.header is not None
    assert bool((istate == C.SUCCESS).all()) and int(st.nst.min()) > 15
    assert not torch.equal(st.yQ, st0.yQ)
    assert bool((st.nli > 0).all()) == (opts.linear_solver == "spgmr")


def test_the_generated_jvp_runs_each_op_in_the_dtype_torch_promotes_to():
    # Morris-Lecar's jvp under float32 arguments: the tangent of the current
    # minus the ionic terms is float64 (the float64 current promotes it), the
    # gates' tangents float32; each is one rounded operation of its type
    model = fused_solve.model_of(morris_lecar_factory, torch.ones(1, 2, dtype=torch.float64))
    jvp = model.header.split("static void res_jvp(")[1].split("static void jac(")[0]
    assert "template <typename T, typename S>" in model.header.split("res_jvp(")[0][-60:]
    assert "const S e" in jvp and "const T e" in jvp and "ida::promote<T>(" in jvp
    # res (and jac, quad) stay in the one type T
    res = model.header.split("static void res(")[1].split("static void res_jvp(")[0]
    assert "const S" not in res and "ida::promote" not in res
