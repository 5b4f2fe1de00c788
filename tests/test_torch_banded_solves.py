"""Band and BBD solves of the port against dense solves and ``ida_tpu``, on
the CPU (``tests/test_torch_banded.py`` has the setting and the
factor/solve kernels' checks; a file of few tests, so that these solves
queue after the suite's files with the most tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_banded import (_bbd_problem, _counts, _heat2d, _wrms, heat2d_problem, jax_heat2d,
                               jax_refs, jb, port, roberts_problem, ROBERTS_YP0, ROBERTS_YY0, tb,
                               tol_sv)  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_band_jacobian_is_ida_tpus():
    # the heat2d residual at m = 5 over 3 lanes, mu = ml = 5: one vmapped jvp
    # of the 11 colored probes against ida_tpu's 11 jvps
    m, bsz = 5, 3
    rng = np.random.default_rng(2)
    yy = rng.standard_normal((m * m, bsz))
    yp = rng.standard_normal((m * m, bsz))
    cj = rng.uniform(1.0, 10.0, bsz)
    jp = jax_heat2d(m, use_prec=False)
    want = jb.band_sys_jacobian(jp, jnp.zeros(bsz), jnp.asarray(cj), jnp.asarray(yy),
                                jnp.asarray(yp), m, m)
    tp = heat2d_problem(m, use_prec=False, device="cpu")
    got = tb.band_sys_jacobian(tp, torch.zeros(bsz, dtype=torch.float64), torch.from_numpy(cj),
                               torch.from_numpy(yy), torch.from_numpy(yp), m, m)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # and the dense system Jacobian, packed, holds the same entries
    dense = tp.sys_jacobian(torch.zeros(bsz, dtype=torch.float64), torch.from_numpy(cj),
                            torch.from_numpy(yy), torch.from_numpy(yp), None)
    assert torch.equal(tb.band_from_dense(dense, m, m), got)


@pytest.fixture(scope="module")
def heat2d_dense():
    m = 8
    return _heat2d(heat2d_problem(m, use_prec=False, device="cpu"), m,
                   port.IdaOptions(mxstep=5000))


def test_heat2d_band_vs_dense_and_ida_tpu(heat2d_dense, jax_refs):
    # tests/test_band_ls.py::test_heat2d_band_vs_dense, and the same band
    # solve in ida_tpu (jitted): the same counters
    m = 8
    ida_d, dense_rows = heat2d_dense
    opts = dict(linear_solver="band", band_mu=m, band_ml=m, mxstep=5000)
    ida_b, band_rows = _heat2d(heat2d_problem(m, use_prec=False, device="cpu"), m,
                               port.IdaOptions(**opts))
    for ud, ub in zip(dense_rows, band_rows):
        np.testing.assert_allclose(ub, ud, atol=5e-6)
    assert ida_b.get_num_jac_evals() > 0
    assert ida_b.get_num_steps() <= 2 * ida_d.get_num_steps()
    assert tuple(ida_b.state.lu.shape) == (3 * m + 1, m * m)
    ref = jax_refs["heat2d_band"]
    assert _counts(ida_b) == ref["counts"]
    assert _wrms(band_rows, ref["rows"]) < 1.0


def test_roberts_band_full_bandwidth_matches_dense():
    # tests/test_band_ls.py: N = 3 with mu = ml = 2, the band IS the dense
    # matrix; 12 decades with the two roots
    ida = port.IDA(roberts_problem(device="cpu"), ROBERTS_YY0, ROBERTS_YP0,
                   tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device="cpu"),
                   port.IdaOptions(linear_solver="band", band_mu=2, band_ml=2), device="cpu")
    iout, tout, roots = 0, 0.4, 0
    while iout < 12:
        _, status = ida.solve(tout)
        if status == port.IdaSolveStatus.Root:
            roots += 1
        else:
            assert status == port.IdaSolveStatus.Success
            iout, tout = iout + 1, tout * 10.0
    assert roots == 2
    reference = np.array([5.2083474251394888e-08, 2.0833390772616859e-13, 9.9999994791631752e-01])
    ewt = 1.0 / (1e-4 * np.abs(reference) + 10.0 * np.array([1e-8, 1e-6, 1e-6]))
    assert np.sqrt(np.mean((ewt * (ida.get_yy() - reference)) ** 2)) < 1.0
    assert abs(ida.get_num_steps() - 362) <= 20 and abs(ida.get_num_jac_evals() - 60) <= 10


def test_heat2d_bbd_vs_diag_prec(heat2d_dense):
    # tests/test_bbd_prec.py::test_heat2d_bbd_vs_diag_prec: at a tight
    # linear tolerance the banded preconditioner (here the exact Jacobian)
    # needs materially fewer Krylov iterations a Newton iteration than the
    # diagonal one, on the dense trajectory
    m = 8
    opts = port.IdaOptions(linear_solver="spgmr", mxstep=5000, eplifac=1e-8)
    _, dense_rows = heat2d_dense
    ida_diag, _ = _heat2d(heat2d_problem(m, use_prec=True, device="cpu"), m, opts)
    ida_bbd, bbd_rows = _heat2d(_bbd_problem(m, m, m), m, opts)
    for ud, ub in zip(dense_rows, bbd_rows):
        np.testing.assert_allclose(ub, ud, atol=2e-5)
    assert ida_bbd.get_num_prec_solves() > 0
    cost_bbd = ida_bbd.get_num_lin_iters() / ida_bbd.get_num_nonlin_solv_iters()
    cost_diag = ida_diag.get_num_lin_iters() / ida_diag.get_num_nonlin_solv_iters()
    assert cost_bbd < 0.8 * cost_diag


def test_bbd_blocked_end_to_end_matches_ida_tpu(heat2d_dense, jax_refs):
    # tests/test_bbd_prec.py::test_bbd_blocked_end_to_end, and the same
    # solve in ida_tpu (jitted): the same counters
    m = 8
    opts = dict(linear_solver="spgmr", mxstep=5000)
    ida, rows = _heat2d(_bbd_problem(m, m, m, nblocks=4), m, port.IdaOptions(**opts))
    _, dense_rows = heat2d_dense
    for ud, ub in zip(dense_rows, rows):
        np.testing.assert_allclose(ub, ud, atol=2e-5)
    assert ida.get_num_prec_solves() > 0
    ref = jax_refs["heat2d_bbd"]
    assert _counts(ida) == ref["counts"]
    assert _wrms(rows, ref["rows"]) < 1.0


def test_bbd_narrow_band_and_res_local():
    # tests/test_bbd_prec.py: a tridiagonal kept band still converges to the
    # trajectory, and a distinct Gres (res_local) is what prec_setup calls
    m = 6
    base = heat2d_problem(m, use_prec=False, device="cpu")
    calls = []

    def gres(t, yy, yp):
        calls.append(1)
        return base.res(t, yy, yp)

    opts = port.IdaOptions(linear_solver="spgmr", mxstep=5000)
    _, rows = _heat2d(_bbd_problem(m, 1, 1, res_local=gres), m, opts)
    _, dense_rows = _heat2d(heat2d_problem(m, use_prec=False, device="cpu"), m,
                            port.IdaOptions(mxstep=5000))
    for ud, ub in zip(dense_rows, rows):
        np.testing.assert_allclose(ub, ud, atol=2e-5)
    assert calls
