"""``fast_math=True`` against ``ida_tpu`` run op by op: the Roberts slice's
first decade, every counter and the state bit for bit (split from
tests/test_torch_fast_math.py, whose other tests it shares its helpers with).
"""

import jax
import torch

from test_torch_fast_math import _counters, _ida, _jax_ida, _same_fields

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_fast_math_is_ida_tpus_op_by_op():
    jax_ida = _jax_ida(True)
    ida = _ida(True)
    with jax.disable_jit():
        for t in (0.04, 0.4):
            jax_ida.solve(t)
            ida.solve(t)
            assert _counters(ida.state) == _counters(jax_ida.state), t
    _same_fields(ida.state, jax_ida.state)
