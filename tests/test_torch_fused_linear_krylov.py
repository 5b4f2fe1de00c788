"""SPGMR in the whole-solve kernel (K2-K4), on the CPU.

Under ``linear_solver="spgmr"`` the port's kernel runs restarted GMRES in
each lane (``csrc/ida_lane.cuh`` ``spgmr_solve``, ``ops/spgmr.py`` op for
op: ``sum0`` dots, MGS or CGS2, the Givens algebra, the true-residual
restart test, the first iteration's acceptance of a reduced residual) on
jvps of the model's residual, with the Krylov counters in the state. Here,
with the kernel source built for the host (tests/test_torch_fused_host.py
``host_build``), on B = 8 heterogeneous Roberts lanes to tout 0.4, f64: K2
and a budget of 6 attempts a launch (K3 + K4) bit for bit the port's eager
solve under the same options, every field and counter (``nli``, ``nps``,
``ncfl``, ``njtimes`` among them), ``tret`` and ``istate``, in each of:

* MGS (the defaults: maxl 5, 5 restarts), CGS2, a bfloat16 basis,
  ``ls_precision="single"`` (the whole iteration in float32 on jvps whose
  float64 parameters promote what they meet) and ``fast_math``;
* a short basis that restarts and fails (maxl 2, 2 restarts, eplifac
  0.005): solves that end unconverged (``ncfl`` > 0) and steps that fail for
  it, half the lanes ending in LSOLVE_FAIL; restarts (also under the
  bfloat16 basis) counted in ``njtimes``.

The lanes' Arnoldi loops end at different columns (their ``nli`` differ),
so a lane's own loop is held against the eager loop that runs every lane to
the batch's last column.
"""

import pytest
import torch

from ida_tpu_torch import constants as C
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import roberts_factory
from ida_tpu_torch.ops import fused_solve
from ida_tpu_torch.tol_control import tol_sv
from test_torch_fused_host import ATOL, _stress_inputs, host_lib, on_host  # noqa: F401
from test_torch_fused_linear import B, TOUT, assert_kernel_is_the_eager_solve

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

KRYLOV_CASES = {
    "mgs": IdaOptions(linear_solver="spgmr"),
    "cgs2": IdaOptions(linear_solver="spgmr", krylov_gs="classical"),
    "bf16": IdaOptions(linear_solver="spgmr", krylov_storage="bfloat16"),
    "single": IdaOptions(linear_solver="spgmr", ls_precision="single"),
    "fast_math": IdaOptions(linear_solver="spgmr", fast_math=True),
    "maxl2-restarts2": IdaOptions(linear_solver="spgmr", krylov_maxl=2, krylov_max_restarts=2,
                                  eplifac=0.005),
}


@pytest.mark.parametrize("case", KRYLOV_CASES)
def test_spgmr_kernel_is_bitwise_the_eager_krylov_solve(on_host, case):
    opts = KRYLOV_CASES[case]
    params, st0 = _stress_inputs(b=B, opts=opts)
    assert st0.lu.numel() == 0 and st0.piv.numel() == 0
    ref = assert_kernel_is_the_eager_solve(roberts_factory, params, st0,
                                           tol_sv(1e-4, ATOL, device="cpu"), TOUT, opts)
    st, fails = ref[0], case == "maxl2-restarts2"
    assert set(ref[2].tolist()) == ({C.SUCCESS, C.LSOLVE_FAIL} if fails else {C.SUCCESS})
    # the Krylov counters moved, lane by lane differently; no Jacobian was
    # evaluated. Without a preconditioner each cycle's two solves of P
    # (start, true residual) pair with its two extra jvps, and a linear
    # solve runs at least one cycle
    assert bool((st.nli > 0).all()) and len(set(st.nli.tolist())) > 1
    assert torch.equal(st.nps, st.njtimes) and int(st.nje.sum()) == 0
    assert bool((st.njtimes >= st.nli + 2 * st.nni).all())
    restarted = st.njtimes > st.nli + 2 * st.nni
    if fails:
        # every lane restarted, counted unconverged solves and failed steps
        assert bool(restarted.all() and (st.ncfl > 0).all() and (st.ncfn > 0).all())
    else:
        assert bool(restarted.any()) == (case == "bf16") and int(st.ncfl.sum()) == 0
