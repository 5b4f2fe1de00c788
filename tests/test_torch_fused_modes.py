"""``ida_tpu_torch.ops.make_fused_solve`` in each arithmetic mode of
``IdaOptions`` (``fast_math`` x ``ls_precision`` "full", "single",
"refined") on CPU tensors, where it runs its plain version (the eager
``core.solve`` under the same options), against ``ida_tpu``'s batch-native
``core_solve`` run op by op (``jax.disable_jit()``): B = 8, tout 0.4,
float64, unbudgeted and with ``attempt_budget=6``, bit for bit in istate,
tret, the counters and every float field the mode touches (the float32
``lu``, the refined mode's lsetup point), as tests/test_torch_fused_solve.py
holds the parity mode.

The six references are pinned (:func:`jax_modes_op_by_op_live`, by
tests/make_torch_refs.py: about a minute of op-by-op JAX); one of them is
also computed live by tests/test_torch_pins_live.py and must equal its
pinned bits. The kernel source
itself is held to the eager solve in every mode by
tests/test_torch_fused_host.py (host build) and on the card by
tests/test_torch_cuda_kernels.py and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YY0
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.ops import make_fused_solve
from ida_tpu_torch.parallel import ensemble_init
from ida_tpu_torch.tol_control import tol_sv
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

B = 8
TOUT = 0.4
RTOL = 1e-4
ATOL = [1e-8, 1e-6, 1e-6]
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn")
FIELDS = ("yy", "yp", "phi", "psi", "hh", "tn", "kused", "lu", "piv", "ls_tn", "ls_cj", "ls_yy",
          "ls_yp")
# (fast_math, ls_precision), by id
MODES = {
    "-".join((["fast_math"] if fm else []) + [ls]): (fm, ls)
    for fm in (False, True) for ls in ("full", "single", "refined")
}
LIVE = "fast_math-single"


def _inputs():
    params = np.outer(np.linspace(0.9, 1.1, B), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (B, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


def _jax_op_by_op(mode_id):
    fm, ls = MODES[mode_id]
    jopts = JOptions(fast_math=fm, ls_precision=ls)
    params, yy0, yp0 = (jnp.asarray(a) for a in _inputs())
    st = jensemble_init(jroberts, params, yy0, yp0, opts=jopts)
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), st)
    tol = JTol(jnp.full((B,), RTOL), jnp.tile(jnp.asarray(ATOL)[:, None], (1, B)))
    with jax.disable_jit():
        return jsolve(st, jroberts(params.T), jopts, tol, jnp.full((B,), TOUT))


# what the pinned reference (jax_modes_op_by_op_live) is computed from
REF_INPUTS = {**dict(zip(("params", "yy0", "yp0"), _inputs())), "rtol": RTOL, "atol": ATOL,
              "tout": TOUT, "modes": MODES}


def jax_modes_op_by_op_live():
    """ida_tpu's op-by-op solve of the B = 8 lanes to 0.4 in each mode:
    {mode id: (batch-native state, tret, istate)}."""
    return {m: tuple(_jax_op_by_op(m)) for m in MODES}


@pytest.fixture(scope="module")
def pinned():
    return load("fused_modes_op_by_op", REF_INPUTS)


def _assert_bitwise(got, ref):
    st, tret, ist = got
    jst, jtret, jist = ref
    assert bool((ist == C.SUCCESS).all())
    np.testing.assert_array_equal(ist.numpy(), np.asarray(jist))
    np.testing.assert_array_equal(tret.numpy(), np.asarray(jtret))
    for f in COUNTERS + FIELDS:
        want = np.moveaxis(np.asarray(getattr(jst, f)), -1, 0)
        have = getattr(st, f).numpy()
        assert have.dtype == want.dtype and have.shape == want.shape, f
        np.testing.assert_array_equal(have, want, err_msg=f)


def _port(mode_id, budget):
    fm, ls = MODES[mode_id]
    opts = IdaOptions(fast_math=fm, ls_precision=ls)
    params, yy0, yp0 = _inputs()
    st = ensemble_init(troberts, params, yy0, yp0, device="cpu", opts=opts)
    fn = make_fused_solve(troberts, tol_sv(RTOL, ATOL, device="cpu"), opts, attempt_budget=budget)
    return fn(st, params, TOUT)


@pytest.mark.parametrize("budget", [None, 6], ids=["unbudgeted", "budget6"])
@pytest.mark.parametrize("mode_id", list(MODES))
def test_plain_version_in_each_mode_is_bitwise_the_op_by_op_reference(pinned, mode_id, budget):
    _assert_bitwise(_port(mode_id, budget), pinned[mode_id])


def test_a_pin_made_from_other_inputs_is_refused():
    # a pin records the inputs it was made from; a test whose constants
    # have moved since reads no stale reference
    load("fused_modes_op_by_op", REF_INPUTS)
    with pytest.raises(AssertionError, match="regenerate it"):
        load("fused_modes_op_by_op", {**REF_INPUTS, "tout": 0.5})
    with pytest.raises(AssertionError, match="regenerate it"):
        load("fused_modes_op_by_op", {**REF_INPUTS, "atol": [1e-8, 1e-6, 1e-7]})
