"""The band solver (``ida_tpu_torch.ops.banded``, ``linear_solver="band"``)
and the BBD preconditioner (``ops.bbd.make_bbd_prec``) against ``ida_tpu``.

The factor and the solve are held to ``ida_tpu``'s run op by op
(``jax.disable_jit``, so nothing is contracted into a multiply-add) bit for
bit on seeded bands, a zero pivot and ties in the pivot column. Where a
row of U holds more than 32 products, the port adds them as a pairwise tree
(``utils.numerics.sum0``) and XLA:CPU in an order of its own: there the
solution is held to 1e-12. End to end (tests/test_band_ls.py,
tests/test_bbd_prec.py, heat2d at m = 8 and 6): band against dense to
5e-6, BBD against dense to 2e-5, the BBD Krylov work per Newton iteration
against the diagonal preconditioner's, and the counters against the jitted
JAX solve where one is run (exactly; the solution there to a WRMS of 1
under the solve's weights: the jitted linear algebra rounds otherwise, and
the Newton iterates differ within their tolerance). The JAX runs are pinned
(tests/make_torch_refs.py, ``banded_jax``). The end-to-end solves are
``test_torch_banded_solves.py``'s, a file of few tests, which queues after
the files with the most tests (pytest-xdist hands those out first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu as jida
from ida_tpu.models.heat2d import heat2d_problem as jax_heat2d
from ida_tpu.ops import banded as jb
from ida_tpu.ops import make_bbd_prec as jax_bbd
from ida_tpu.problem import IdaProblem as JaxProblem
import ida_tpu_torch as port
from ida_tpu_torch.models import (ROBERTS_YP0, ROBERTS_YY0, heat2d_ic, heat2d_problem,
                                  roberts_problem)
from ida_tpu_torch.ops import banded as tb
from ida_tpu_torch.ops import make_bbd_prec
from ida_tpu_torch.tol_control import tol_ss, tol_sv
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

TOUTS = (0.01, 0.04, 0.16)


def _random_banded(n, mu, ml, rng, batch=()):
    """tests/test_banded.py's seeded bands without its diagonal boost, so
    that the pivot search swaps rows."""
    a = np.zeros((n, n) + batch)
    for i in range(n):
        lo, hi = max(0, i - ml), min(n, i + mu + 1)
        a[i, lo:hi] = rng.standard_normal((hi - lo,) + batch)
    return a


def _jax_band(a, b, mu, ml):
    """ida_tpu op by op: the packed band, the factor and x."""
    with jax.disable_jit():
        ab = jb.band_from_dense(jnp.asarray(a), mu, ml)
        f = jb.band_factor(ab, mu, ml)
        x = jb.band_solve(f, jnp.asarray(b))
    return [np.asarray(ab), np.asarray(f.lu), np.asarray(f.piv), np.asarray(f.fail_col),
            np.asarray(x)]


def _port_band(a, b, mu, ml):
    """The port's packed band, factor and x."""
    abt = tb.band_from_dense(torch.from_numpy(a), mu, ml)
    ft = tb.band_factor(abt, mu, ml)
    xt = tb.band_solve(ft, torch.from_numpy(b))
    return abt.numpy(), ft.lu.numpy(), ft.piv.numpy(), ft.fail_col.numpy(), xt.numpy()


BAND_CASES = {"8-2-1": (8, 2, 1, ()), "8-1-3": (8, 1, 3, ()), "12-0-2": (12, 0, 2, ()),
              "7-6-6-full": (7, 6, 6, ()), "10-2-3-batch3": (10, 2, 3, (3,))}


def _seeded_case(n, mu, ml, batch):
    rng = np.random.default_rng(42 + n + 10 * mu + 100 * ml)
    a = _random_banded(n, mu, ml, rng, batch)
    return a, rng.standard_normal((n,) + batch)


def _ties_case():
    # lane 0: column 1 all zero (fail_col 2); lane 1: |column 0| ties at 2
    # between rows 1 and 2 below a zero diagonal (the first one wins); lane
    # 2: a three-way tie led by the diagonal itself (no swap)
    n = 4
    a = np.zeros((n, n, 3))
    a[:, :, 0] = [[1, 0, 0, 0], [0, 0, 1, 0], [1, 0, 1, 1], [0, 0, 1, 1]]
    a[:, :, 1] = [[0, 1, 0, 0], [2, 3, 1, 0], [-2, 1, 4, 2], [0, 1, 1, 1]]
    a[:, :, 2] = [[2, 1, 0, 0], [-2, 3, 1, 0], [2, 1, 4, 2], [0, 1, 1, 5]]
    return a, np.arange(1.0, 1.0 + n * 3).reshape(n, 3)


def _wide_case():
    n, mu, ml = 40, 17, 17
    rng = np.random.default_rng(5)
    a = _random_banded(n, mu, ml, rng, (2,)) + 8.0 * np.eye(n)[:, :, None]
    return a, rng.standard_normal((n, 2))


@pytest.mark.parametrize("n,mu,ml,batch", list(BAND_CASES.values()), ids=list(BAND_CASES))
def test_band_factor_and_solve_are_ida_tpus_bit_for_bit(jax_refs, n, mu, ml, batch):
    a, b = _seeded_case(n, mu, ml, batch)
    case = next(k for k, v in BAND_CASES.items() if v == (n, mu, ml, batch))
    want, got = jax_refs["band"][case], _port_band(a, b, mu, ml)
    for name, w, g in zip(("band", "lu", "piv", "fail_col", "x"), want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g), name
    assert not got[3].any() and (got[2] > 0).any()  # the pivot search swapped rows
    assert np.allclose(np.einsum("ij...,j...->i...", a, got[4]), b, atol=1e-10)
    assert np.array_equal(tb.band_to_dense(torch.from_numpy(got[0]), mu, ml).numpy(), a)


def test_zero_pivots_and_ties_follow_ida_tpu(jax_refs):
    # _ties_case: a zero column, ties below a zero diagonal, a tie led by
    # the diagonal
    mu, ml = 1, 2
    a, b = _ties_case()
    want, got = jax_refs["band"]["ties"], _port_band(a, b, mu, ml)
    for name, w, g in zip(("band", "lu", "piv", "fail_col", "x"), want, got):
        assert np.array_equal(w, g, equal_nan=True), name
    assert got[3].tolist() == [2, 0, 0]
    assert got[2][0].tolist() == [0, 1, 0]


def test_more_than_32_products_a_row_sum_as_a_tree(jax_refs):
    mu, ml = 17, 17
    a, b = _wide_case()
    want, got = jax_refs["band"]["wide"], _port_band(a, b, mu, ml)
    for name, w, g in zip(("band", "lu", "piv", "fail_col"), want[:4], got[:4]):
        assert np.array_equal(w, g), name
    np.testing.assert_allclose(got[4], want[4], rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------- end to end


def _heat2d(problem, m, opts):
    u0, up0 = heat2d_ic(m)
    ida = port.IDA(problem, u0, up0, tol_ss(1e-5, 1e-8, device="cpu"), opts, device="cpu")
    rows = []
    for t in TOUTS:
        _, status = ida.solve(t)
        assert status == port.IdaSolveStatus.Success
        rows.append(ida.get_yy().copy())
    return ida, rows


def _jax_heat2d(problem, m, opts):
    u0, up0 = heat2d_ic(m)
    ida = jida.IDA(problem, u0, up0, jida.tol_ss(1e-5, 1e-8), options=opts)
    rows = []
    for t in TOUTS:
        _, status = ida.solve(t)
        assert status == jida.IdaSolveStatus.Success
        rows.append(np.asarray(ida.get_yy()).copy())
    return ida, rows


def _wrms(rows, ref_rows) -> float:
    """The largest WRMS difference over the output times, under the
    solve's own weights 1 / (1e-5 |y| + 1e-8)."""
    ref = np.array(ref_rows)
    w = 1.0 / (1e-5 * np.abs(ref) + 1e-8)
    return float(np.sqrt(np.mean(((np.array(rows) - ref) * w) ** 2, axis=1)).max())


def _counts(ida) -> dict:
    return {"nst": ida.get_num_steps(), "nni": ida.get_num_nonlin_solv_iters(),
            "nje": ida.get_num_jac_evals(), "nli": ida.get_num_lin_iters(),
            "nps": ida.get_num_prec_solves(), "netf": ida.get_num_err_test_fails()}


def _jax_bbd_blocked():
    """ida_tpu's BBD preconditioner (nblocks 4) on heat2d m = 8, op by op:
    (pdata, x) at cj 7.5 for the seeded right-hand side."""
    m, nblocks = 8, 4
    n = m * m
    u0, up0 = heat2d_ic(m)
    cj = 7.5
    r = np.random.default_rng(0).standard_normal(n)
    jbase = jax_heat2d(m, use_prec=False)
    jprec = jax_bbd(jbase.res, n, m, m, nblocks=nblocks)
    with jax.disable_jit():
        jdata = jprec.prec_setup(jnp.asarray(0.0), jnp.asarray(cj), jnp.asarray(u0),
                                 jnp.asarray(up0), jnp.zeros(n))
        jx = np.asarray(jprec.prec_solve(jdata, jnp.asarray(r), jnp.asarray(cj)))
    return [np.asarray(jdata[0]), np.asarray(jdata[1])], jx


def _jax_heat2d_run(kind):
    """ida_tpu's jitted heat2d m = 8 solve with the band solver or SPGMR
    with the blocked BBD preconditioner: its counters and rows."""
    m = 8
    if kind == "band":
        prob = jax_heat2d(m, use_prec=False)
        opts = dict(linear_solver="band", band_mu=m, band_ml=m, mxstep=5000)
    else:
        jbase = jax_heat2d(m, use_prec=False)
        prob = JaxProblem(n=jbase.n, res=jbase.res, id=jbase.id,
                          **jax_bbd(jbase.res, jbase.n, m, m, nblocks=4).hooks())
        opts = dict(linear_solver="spgmr", mxstep=5000)
    jax_ida, rows = _jax_heat2d(prob, m, jida.IdaOptions(**opts))
    return {"counts": {k: int(v) for k, v in _counts(jax_ida).items()}, "rows": rows}


# what the pinned JAX runs (jax_banded_live) are computed from
REF_INPUTS = {"band_cases": BAND_CASES, "ties": _ties_case(), "wide": _wide_case(),
              "touts": TOUTS, "heat_m": 8, "bbd": {"nblocks": 4, "cj": 7.5}}


def jax_banded_live():
    band = {case: _jax_band(*_seeded_case(*v), v[1], v[2]) for case, v in BAND_CASES.items()}
    band["ties"] = _jax_band(*_ties_case(), 1, 2)
    band["wide"] = _jax_band(*_wide_case(), 17, 17)
    return {"band": band, "bbd_blocked": _jax_bbd_blocked(),
            "heat2d_band": _jax_heat2d_run("band"), "heat2d_bbd": _jax_heat2d_run("bbd")}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX runs, pinned (tests/make_torch_refs.py, ``banded_jax``)."""
    return load("banded_jax", REF_INPUTS)


def test_band_options_size_the_state():
    opts = port.IdaOptions(linear_solver="band", band_mu=3, band_ml=2)
    st = port.init_state(heat2d_problem(4, device="cpu"), np.zeros(16), np.zeros(16),
                         device="cpu", opts=opts)
    assert tuple(st.lu.shape) == (8, 16) and tuple(st.piv.shape) == (16,)
    with pytest.raises(ValueError, match="band_mu"):
        port.IdaOptions(linear_solver="band", band_mu=-1)


def _bbd_problem(m, mu, ml, **kw):
    base = heat2d_problem(m, use_prec=False, device="cpu")
    prec = make_bbd_prec(base.res, base.n, mu, ml, **kw)
    return port.IdaProblem(n=base.n, res=base.res, id=base.id, **prec.hooks())


def test_bbd_blocked_matches_ida_tpu_and_the_block_diagonal_solve(jax_refs):
    # tests/test_bbd_prec.py::test_bbd_blocked_matches_manual_blockdiag:
    # with nblocks = 4 the preconditioner solves with the band of the
    # Jacobian restricted to the blocks; its factor and solve are ida_tpu's
    # (op by op) bit for bit
    m, nblocks = 8, 4
    n, mu, ml = m * m, m, m
    nb = n // nblocks
    u0, up0 = heat2d_ic(m)
    cj = 7.5
    base = heat2d_problem(m, use_prec=False, device="cpu")
    prec = make_bbd_prec(base.res, n, mu, ml, nblocks=nblocks)
    t, cjt = torch.tensor(0.0, dtype=torch.float64), torch.tensor(cj, dtype=torch.float64)
    yy, yp = torch.from_numpy(u0), torch.from_numpy(up0)
    pdata = prec.prec_setup(t, cjt, yy, yp, torch.zeros_like(yy))
    r = np.random.default_rng(0).standard_normal(n)
    x = prec.prec_solve(pdata, torch.from_numpy(r), cjt).numpy()

    jdata, jx = jax_refs["bbd_blocked"]
    assert np.array_equal(pdata[0].numpy(), jdata[0])
    assert np.array_equal(pdata[1].numpy(), jdata[1])
    assert np.array_equal(x, jx)
    assert tuple(pdata[0].shape) == (tb.band_rows(mu, ml), nb, nblocks)

    jac = base.sys_jacobian(t, cjt, yy, yp, None).numpy()
    i, j = np.indices(jac.shape)
    keep = (i - j <= ml) & (j - i <= mu) & ((i // nb) == (j // nb))
    np.testing.assert_allclose(x, np.linalg.solve(np.where(keep, jac, 0.0), r), rtol=1e-10,
                               atol=1e-12)


def test_bbd_blocked_validation():
    base = heat2d_problem(6, use_prec=False, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        make_bbd_prec(base.res, base.n, 2, 2, nblocks=5)  # 36 % 5 != 0
    with pytest.raises(ValueError, match="exceed"):
        make_bbd_prec(base.res, base.n, 2, 2, nblocks=18)  # block 2 <= ml
