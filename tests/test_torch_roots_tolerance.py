"""Root times converge with the tolerance, against the oracle, on the CPU
(``tests/test_torch_roots_path.py`` has the setting; a file of its own,
so that the slow test runs at the end of the suite's queue).
"""

import torch

from test_torch_roots_path import _oracle, _port_events, TOUTS

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_roots_converge_with_tolerance():
    # through 4e7: both roots lie before it
    atol = [1e-12, 1e-10, 1e-10]
    ret, _y, ev_o, _s = _oracle(1e-8, atol, touts=TOUTS[:9])
    _, ev_t = _port_events(1e-8, atol, touts=TOUTS[:9])
    assert ret == 0 and len(ev_o) == len(ev_t) == 2
    for (to, io), (tt, it) in zip(ev_o, ev_t):
        assert list(io) == list(it)
        assert abs(to - tt) / tt < 1e-6
