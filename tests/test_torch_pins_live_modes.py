"""The live check of the pinned op-by-op modes reference against
``ida_tpu``, on the CPU (``tests/test_torch_pins_live.py`` has the
setting; a file of its own, so that the slow test runs at the end of the
suite's queue).
"""

import numpy as np
import torch

from test_torch_pins_live import _assert_bitwise, _jax_op_by_op, _port, LIVE, pinned  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_one_mode_against_ida_tpu_live(pinned):  # noqa: F811
    # the pinned reference is still what ida_tpu computes, and the port
    # equals it
    live = _jax_op_by_op(LIVE)
    for f in live[0]._fields:
        if f != "pdata":
            np.testing.assert_array_equal(np.asarray(getattr(live[0], f)),
                                          np.asarray(getattr(pinned[LIVE][0], f)), err_msg=f)
    _assert_bitwise(_port(LIVE, None), live)
