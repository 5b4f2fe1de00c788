"""Pinned ``ida_tpu`` references against the live JAX runs they stand for.

The port's tests read their slowest ``ida_tpu`` references from pins
(tests/make_torch_refs.py). Here a few of them are computed again and must
equal their pinned bits, and the port must equal the live run: the
fast_math + "single" op-by-op solve of tests/test_torch_fused_modes.py and
the Lorenz '63 run of ``ida_tpu``'s fused kernel in interpret mode of
tests/test_torch_fused_models.py (the first in ``test_torch_pins_live_modes.py``).
Files of one test: their JAX runs (about a minute) then queue last
(pytest-xdist hands out the files with the most tests first).
"""

import numpy as np
import torch

from make_torch_refs import load
from test_torch_fused_models import REF_INPUTS as MODELS_REF_INPUTS
from test_torch_fused_models import _jax_fused
from test_torch_fused_modes import LIVE, _assert_bitwise, _jax_op_by_op, _port, pinned  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_the_lorenz_pin_is_the_live_jax_run():
    live = _jax_fused("lorenz")
    pinned_lorenz = load("fused_models_jax", MODELS_REF_INPUTS)["lorenz"]["fused"]
    for k, v in live.items():
        np.testing.assert_array_equal(v, pinned_lorenz[k], err_msg=k)
