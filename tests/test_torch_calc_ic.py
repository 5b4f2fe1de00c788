"""Consistent initial conditions (``ida_tpu_torch.core.calc_ic``) and the
looped dense LU it factors with, against ``ida_tpu``.

Roberts through ``IDA.calc_ic`` on the inputs of tests/test_calc_ic.py and
tests/test_calc_ic_oracle.py, and eight lanes at once (those inputs and
seeded ones), batch-native, all against one ``jax.vmap`` of the JAX
``calc_ic`` per icopt (one lane fails and keeps its guesses);
``solve_dae(yp0=None)`` and ``EnsembleIDA.calc_ic``. The JAX side is
jitted, so its last bits may differ (XLA:CPU contracts multiply-adds): the
consistent values are held to 1e-10 relative, the ``ok`` flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu as jida
import ida_tpu_torch as port
from ida_tpu.core.calc_ic import calc_ic as jax_calc_ic
from ida_tpu.core.state import init_state as jax_init_state
from ida_tpu.models import roberts_problem as jax_roberts
from ida_tpu.ops.dense_lu import lu_factor as jax_lu_factor
from ida_tpu.ops.dense_lu import lu_solve as jax_lu_solve
from ida_tpu.parallel import EnsembleIDA as JaxEnsemble
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.calc_ic import IC_CODES
from ida_tpu_torch.models import ROBERTS_PARAMS, roberts_factory, roberts_problem
from ida_tpu_torch.ops import dense_lu
from ida_tpu_torch.utils.convert import ensemble_from_numpy, ida_from_numpy, state_from_numpy
from ida_tpu_torch.utils.convert import state_fields

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

RTOL = 1.0e-4
ATOL = np.array([1e-8, 1e-6, 1e-6])
TOL = {"rtol": np.float64(RTOL), "atol": ATOL}

# (icopt, y0, yp0): tests/test_calc_ic.py:16-50 and test_calc_ic_oracle.py:49-107
CASES = {
    "ya_ydp_y3_off": ("ya_ydp", [1.0, 0.0, 0.3], [0.0, 0.0, 0.0]),
    "ya_ydp_oracle": ("ya_ydp", [0.7, 0.1, 0.5], [0.0, 0.0, 0.0]),
    "y_init": ("y", [1.0, 1e-5, 0.05], [-0.05, 0.04, 0.0]),
}
B = 8


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-300)


def _lanes(icopt: str):
    """Eight lanes: the cases of that ``icopt`` first, then seeded lanes
    around the last of them; under Y_INIT the last lane's Jacobian is
    singular (y' = [-0.04, 0.04, 0] at y = [1, 0, 0]), so it fails."""
    rng = np.random.default_rng(11)
    cases = [c for c in CASES.values() if c[0] == icopt]
    y0 = np.array(cases[-1][1]) * (1.0 + 0.05 * rng.uniform(-1, 1, size=(B, 3)))
    yp0 = np.tile(cases[-1][2], (B, 1))
    for i, (_, y, yp) in enumerate(cases):
        y0[i], yp0[i] = y, yp
    if icopt == "y":
        y0[-1], yp0[-1] = [1.0, 0.0, 0.0], [-0.04, 0.04, 0.0]
    return y0, yp0


@pytest.fixture(scope="module")
def jax_lane_ics():
    """``jax.vmap`` of the jitted JAX calc_ic over the eight lanes of each
    icopt: per icopt (y0, yp0, ok) batch-leading."""
    prob = jax_roberts(with_roots=False)
    opts = jida.IdaOptions()
    tol = jida.tol_sv(RTOL, jnp.asarray(ATOL))
    out = {}
    for icopt, code in IC_CODES.items():
        def one(y, yp, code=code):
            st = jax_init_state(prob, y, yp, opts=opts)
            return jax_calc_ic(st, prob, opts, tol, code, jnp.asarray(0.4))

        st, ok = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in _lanes(icopt)))
        out[icopt] = (np.asarray(st.phi[:, 0]), np.asarray(st.phi[:, 1]), np.asarray(ok))
    return out


def test_failed_calc_ic_raises_and_keeps_the_state():
    # y' = [-0.04, 0.04, 0] at y = [1, 0, 0]: the Y_INIT Jacobian is singular
    ida = ida_from_numpy(roberts_problem(with_roots=False, device="cpu"),
                         np.array([1.0, 0.0, 0.0]), np.array([-0.04, 0.04, 0.0]), TOL, device="cpu")
    before = ida.state.phi.clone()
    with pytest.raises(port.IdaError, match="CONV_FAIL"):
        ida.calc_ic("y", tout1=0.4)
    assert torch.equal(ida.state.phi, before)


def test_solve_dae_computes_the_initial_conditions():
    def res(t, y, yp):
        r0 = -0.04 * y[0] + 1.0e4 * y[1] * y[2]
        r1 = -r0 - 3.0e7 * y[1] * y[1] - yp[1]
        return jnp_or_torch(y).stack([r0 - yp[0], r1, y[0] + y[1] + y[2] - 1.0])

    kw = dict(t_eval=[0.04, 0.4], rtol=RTOL, atol=ATOL, id=[True, True, False])
    y0 = [1.0, 0.0, 0.2]  # y3 off the algebraic manifold
    ref = jida.solve_dae(res, (0.0, 0.4), y0, None, **kw)
    sol = port.solve_dae(res, (0.0, 0.4), y0, None, device="cpu", **kw)
    assert sol.success and ref.success
    counts = ("nst", "nre", "nje", "nni", "netf", "ncfn", "last_order")
    assert {k: sol.stats[k] for k in counts} == {k: ref.stats[k] for k in counts}
    np.testing.assert_allclose(sol.y, np.asarray(ref.y), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(sol.y[:, :3].sum(axis=1), 1.0, atol=1e-6)
    # calc_ic="y" given y' is the other option; yp0=None needs id for "ya_ydp"
    with pytest.raises(ValueError, match="id"):
        port.solve_dae(res, (0.0, 0.4), y0, None, device="cpu", t_eval=[0.4])


def jnp_or_torch(x):
    return torch if isinstance(x, torch.Tensor) else jnp


def test_ensemble_calc_ic_matches_ida_tpu():
    rng = np.random.default_rng(12)
    params = np.outer(np.exp(rng.uniform(-0.2, 0.2, 4)), ROBERTS_PARAMS)
    y0 = np.tile([0.7, 0.1, 0.5], (4, 1)) * (1.0 + 0.05 * rng.uniform(-1, 1, size=(4, 3)))
    yp0 = np.zeros((4, 3))
    ref = JaxEnsemble(jida.models.roberts_factory, jnp.asarray(params), y0, yp0,
                      jida.tol_sv(RTOL, jnp.asarray(ATOL)))
    ens = ensemble_from_numpy(roberts_factory, params, y0, yp0, TOL, device="cpu")
    ok_ref, ok = ref.calc_ic("ya_ydp", 0.4), ens.calc_ic("ya_ydp", 0.4)
    assert ok.tolist() == np.asarray(ok_ref).tolist() == [True] * 4
    _close(ens.yy, np.asarray(ref.states.yy))
    _close(ens.states.phi[:, 1].numpy(), np.asarray(ref.states.phi[:, 1]))
    tret, ist = ens.solve(0.4)  # the corrected lanes integrate
    assert ist.tolist() == [C.SUCCESS] * 4


def test_spgmr_state_converts_field_by_field():
    # a JAX state with a preconditioner workspace goes over leaf by leaf
    jprob = jida.models.foodweb_problem(3, 3)
    c0, cp0 = jida.models.foodweb_ic(3, 3)
    jst = jax_init_state(jprob, c0, cp0, opts=jida.IdaOptions(linear_solver="spgmr"))
    st = state_from_numpy(state_fields(jst), device="cpu", batch="trailing")
    assert tuple(st.lu.shape) == (0, 0) and tuple(st.piv.shape) == (0,)
    assert [tuple(x.shape) for x in st.pdata] == [(9, 2, 2), (9, 2)]
    assert [x.dtype for x in st.pdata] == [torch.float64, torch.int32]
    ours = port.init_state(port.models.foodweb_problem(3, 3, device="cpu"), c0, cp0,
                           device="cpu", opts=port.IdaOptions(linear_solver="spgmr"))
    for f in st._fields:
        a, b = getattr(st, f), getattr(ours, f)
        pairs = zip(a, b) if f == "pdata" else [(a, b)]
        for x, y in pairs:
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), f


# ------------------------------------------------------------------ looped LU


def _old_lu_factor(a):
    """The masked whole-matrix form the in-place factor replaced: every
    column rebuilds [N, N, *batch] (kept here as the reference)."""
    n = a.shape[0]
    bshape = a.shape[2:]
    idx = torch.arange(n, dtype=torch.int32).reshape((n,) + (1,) * len(bshape))
    mat, piv = a, []
    fail = torch.zeros(bshape, dtype=torch.int32)
    for k in range(n):
        col = mat[:, k]
        l = torch.argmax(torch.where(idx >= k, col.abs(), torch.full_like(col, -np.inf)),
                         dim=0).to(torch.int32)
        piv.append(l)
        sel_l = idx == l
        pivot_val = torch.gather(col, 0, l.long().unsqueeze(0)).squeeze(0)
        zero_piv = pivot_val == 0.0
        fail = torch.where((fail == 0) & zero_piv, k + 1, fail)
        row_k = mat[k]
        row_l = torch.gather(mat, 0, l.long().reshape((1, 1) + bshape).expand(
            (1,) + mat.shape[1:])).squeeze(0)
        mat = torch.where(sel_l.unsqueeze(1), row_k.unsqueeze(0), mat)
        mat = torch.cat([mat[:k], row_l.unsqueeze(0), mat[k + 1:]])
        mult = 1.0 / torch.where(zero_piv, torch.ones_like(pivot_val), mat[k, k])
        col_k = mat[:, k]
        col_scaled = torch.where(idx > k, col_k * mult, col_k)
        mat = torch.cat([mat[:, :k], col_scaled.unsqueeze(1), mat[:, k + 1:]], dim=1)
        update = col_scaled.unsqueeze(1) * mat[k].unsqueeze(0)
        mask = (idx > k).unsqueeze(1) & (idx > k).unsqueeze(0)
        mat = mat - torch.where(mask, update, torch.zeros_like(update))
    return mat, torch.stack(piv), fail


def test_looped_lu_in_place_matches_the_old_form_and_ida_tpu():
    rng = np.random.default_rng(24)
    a = rng.normal(size=(24, 24, 5))
    a[:, 5, 3] = 0.0  # lane 3 is singular at column 6
    b = rng.normal(size=(24, 5))
    f = dense_lu.lu_factor(torch.from_numpy(a))
    old = _old_lu_factor(torch.from_numpy(a))
    assert torch.equal(f.lu, old[0]) and torch.equal(f.piv, old[1])
    assert torch.equal(f.fail_col, old[2]) and f.fail_col.tolist() == [0, 0, 0, 6, 0]
    ja = jax.jit(jax.vmap(jax_lu_factor, in_axes=-1, out_axes=-1))(jnp.asarray(a))
    assert np.array_equal(f.lu.numpy(), np.asarray(ja.lu))
    assert np.array_equal(f.piv.numpy(), np.asarray(ja.piv))
    assert np.array_equal(f.fail_col.numpy(), np.asarray(ja.fail_col))
    x = dense_lu.lu_solve(f, torch.from_numpy(b)).numpy()
    jx = np.asarray(jax.jit(jax.vmap(jax_lu_solve, in_axes=-1, out_axes=-1))(ja, jnp.asarray(b)))
    good = [0, 1, 2, 4]
    np.testing.assert_allclose(x[:, good], jx[:, good], rtol=1e-13)  # XLA may contract a*b-c
    np.testing.assert_allclose(np.einsum("ijb,jb->ib", a, x)[:, good], b[:, good], atol=1e-10)
    # dispatch by size: N = 24 takes the looped form on any device
    g = dense_lu.lu_factor_auto(torch.from_numpy(a))
    assert torch.equal(g.lu, f.lu)
