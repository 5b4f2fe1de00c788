"""Dense output with an event buffer that is too small, on the CPU
(``tests/test_torch_dense_output_scan.py`` has the setting; a file of
its own, so that the slow test runs at the end of the suite's queue).
"""

import torch

from test_torch_dense_output_scan import (_setup, assert_rows_equal, DECADES, IdaOptions,
                                          scan_form, solve_dense)

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_events_with_a_buffer_that_is_too_small():
    # through 4e8: both roots of every lane lie before it
    b, touts = 3, DECADES[:10]
    st, prob, tol = _setup(b, roots=True)
    out1 = solve_dense(st, prob, IdaOptions(), tol, touts, max_events=1)
    out3 = solve_dense(st, prob, IdaOptions(), tol, touts, max_events=3)
    _, rows, events = scan_form(st, prob, IdaOptions(), tol, touts)
    for out in (out1, out3):
        assert_rows_equal(out, rows)
        assert out[6].count.tolist() == [2] * b  # the true total, whatever fits
    ev1, ev3 = out1[6], out3[6]
    assert ev1.t.shape == (1, b) and ev3.t.shape == (3, b) and ev3.iroots.shape == (3, 2, b)
    for lane in range(b):
        assert len(events[lane]) == 2
        for e, (t, iroots, yy) in enumerate(events[lane]):
            assert ev3.t[e, lane].item() == t
            assert ev3.iroots[e, :, lane].tolist() == iroots
            assert torch.equal(ev3.yy[e, :, lane], yy)
        assert ev3.t[2, lane].item() == 0.0  # the unused row
        assert ev1.t[0, lane].item() == events[lane][0][0]  # the first is kept
    # rows are those of the problem without roots
    st0, prob0, _ = _setup(b, roots=False)
    plain = solve_dense(st0, prob0, IdaOptions(), tol, touts)
    assert torch.equal(plain[5], out3[5]) and torch.equal(plain[3], out3[3])
