"""The Krylov large-system path of the port against ``ida_tpu``: heat2d
(SPGMR with the diagonal preconditioner) through ``IDA`` and as a
batch-native ensemble, and foodweb (the block-diagonal preconditioner)
through ``IDA.calc_ic`` and two output legs, at small grids.

The JAX side is the jitted solver, pinned (tests/make_torch_refs.py,
``krylov_path_jax``). The sums inside
GMRES run in each framework's own order (XLA:CPU vectorizes sums over more
than ~32 terms, ``utils/numerics.py``), which moves the last bits of each
correction; the counters are held exactly, the states to 1e-9 (of max|u|
for heat2d, relative with an atol floor for foodweb).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu as jida
import ida_tpu_torch as port
from ida_tpu.core.solve import solve as jax_solve
from ida_tpu.models import foodweb_ic, heat2d_ic
from ida_tpu.models import foodweb_problem as jax_foodweb
from ida_tpu.models import heat2d_problem as jax_heat2d
from ida_tpu.parallel import ensemble_init as jax_ensemble_init
from ida_tpu_torch.core.solve import solve as port_solve
from ida_tpu_torch.models import foodweb_problem, heat2d_problem
from ida_tpu_torch.models.foodweb import prec_blocks
from ida_tpu_torch.parallel import ensemble_init, to_native
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

HEAT_M = 8
HEAT_TOUTS = [0.01, 0.04, 0.16]
HEAT_B = 3
FOOD_M = 4
FOOD_TOUTS = [1e-3, 4e-3]
FOOD_ATOL = 1e-5
COUNTERS = ("nst", "nni", "nli", "nps", "ncfl", "netf", "ncfn", "nje", "nre", "nsetups",
            "njtimes")

HEAT_OPTS = dict(linear_solver="spgmr", mxstep=5000)
# BASELINE config 5 takes krylov_maxl=12; 6 halves the JAX solver's compile
# (its Arnoldi loop is unrolled) and still restarts and preconditions
FOOD_OPTS = dict(linear_solver="spgmr", mxstep=5000, krylov_maxl=6, krylov_max_restarts=10)


def _counters(st) -> dict:
    return {k: np.asarray(getattr(st, k)).tolist() for k in COUNTERS}


def _port_counters(st) -> dict:
    return {k: getattr(st, k).tolist() for k in COUNTERS}


# ------------------------------------------------------------------ heat2d


def _heat_ida(pkg, problem, **kw):
    u0, up0 = heat2d_ic(HEAT_M)
    return pkg.IDA(problem, u0, up0, pkg.tol_ss(1e-5, 1e-8, **kw), pkg.IdaOptions(**HEAT_OPTS),
                   **kw)


def _jax_heat_rows():
    """ida_tpu's IDA through the three touts: per tout, the counters and yy."""
    jax_ida = _heat_ida(jida, jax_heat2d(HEAT_M))
    rows = []
    for tout in HEAT_TOUTS:
        jax_ida.solve(tout)
        rows.append((_counters(jax_ida.state), np.asarray(jax_ida.state.yy)))
    return rows


@pytest.fixture(scope="module")
def heat_runs(jax_refs):
    """Both packages' IDA through the three touts: per tout, the counters
    and yy of each (ida_tpu's pinned)."""
    ida = _heat_ida(port, heat2d_problem(HEAT_M, device="cpu"), device="cpu")
    rows = []
    for tout, jax_row in zip(HEAT_TOUTS, jax_refs["heat"]):
        ida.solve(tout)
        rows.append({"jax": jax_row, "port": (_port_counters(ida.state), ida.get_yy())})
    return rows


@pytest.mark.parametrize("i", range(len(HEAT_TOUTS)), ids=[f"tout{t}" for t in HEAT_TOUTS])
def test_heat2d_ida_matches_ida_tpu(heat_runs, i):
    (jc, jy), (pc, py) = heat_runs[i]["jax"], heat_runs[i]["port"]
    assert pc == jc
    assert pc["nje"] == 0 and pc["nli"] > 0 and pc["nps"] > 0
    np.testing.assert_allclose(py, jy, rtol=0, atol=1e-9 * np.abs(jy).max())


def _heat_ensemble_inputs():
    u0, up0 = heat2d_ic(HEAT_M)
    scales = np.linspace(0.9, 1.1, HEAT_B)
    return scales, u0[None] * scales[:, None], up0[None] * scales[:, None]


def _jax_heat_ensemble_rows():
    """ida_tpu's jitted batch-native core solve of the B = 3 lanes: per tout,
    the counters, yy [N, B] and the statuses."""
    scales, u0b, up0b = _heat_ensemble_inputs()
    jprob, jopts = jax_heat2d(HEAT_M), jida.IdaOptions(**HEAT_OPTS)
    jst = jax_ensemble_init(lambda s: jprob, jnp.asarray(scales), u0b, up0b, opts=jopts)
    jst = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), jst)
    jtol = jida.tol_ss(1e-5, 1e-8)
    jfn = jax.jit(lambda st, tout: jax_solve(st, jprob, jopts, jtol, tout, 0))
    rows = []
    for tout in HEAT_TOUTS:
        jst, _, jist = jfn(jst, jnp.full((HEAT_B,), tout))
        rows.append((_counters(jst), np.asarray(jst.yy), np.asarray(jist).tolist()))
    return rows


@pytest.fixture(scope="module")
def heat_ensemble_runs(jax_refs):
    """B = 3 batch-native lanes (u0 x 0.9, 1.0, 1.1) through both packages'
    core solve: per tout, the counters and yy [N, B] (ida_tpu's pinned)."""
    scales, u0b, up0b = _heat_ensemble_inputs()
    prob, opts = heat2d_problem(HEAT_M, device="cpu"), port.IdaOptions(**HEAT_OPTS)
    st = to_native(ensemble_init(lambda p: prob, scales[:, None], u0b, up0b, opts=opts,
                                 device="cpu"))
    tol = port.tol_ss(1e-5, 1e-8, device="cpu")
    assert tuple(st.lu.shape) == (0, 0, HEAT_B) and tuple(st.pdata[0].shape) == (HEAT_M ** 2, HEAT_B)
    rows = []
    for tout, jax_row in zip(HEAT_TOUTS, jax_refs["heat_ensemble"]):
        st, _, ist = port_solve(st, prob, opts, tol, tout)
        rows.append({"jax": jax_row, "port": (_port_counters(st), st.yy.numpy(), ist.tolist())})
    return rows


@pytest.mark.parametrize("i", range(len(HEAT_TOUTS)), ids=[f"tout{t}" for t in HEAT_TOUTS])
def test_heat2d_ensemble_matches_ida_tpu(heat_ensemble_runs, i):
    (jc, jy, jist), (pc, py, pist) = heat_ensemble_runs[i]["jax"], heat_ensemble_runs[i]["port"]
    assert pist == jist == [0] * HEAT_B
    assert pc == jc
    np.testing.assert_allclose(py, jy, rtol=0, atol=1e-9 * np.abs(jy).max())


# ------------------------------------------------------------------ foodweb


def _food_ida(pkg, problem, **kw):
    c0, cp0 = foodweb_ic(FOOD_M, FOOD_M)
    return pkg.IDA(problem, c0, cp0, pkg.tol_ss(1e-5, FOOD_ATOL, **kw),
                   pkg.IdaOptions(**FOOD_OPTS), **kw)


def _jax_food_rows():
    """ida_tpu's IDA: calc_ic("ya_ydp"), then the first two legs."""
    jax_ida = _food_ida(jida, jax_foodweb(FOOD_M, FOOD_M))
    jax_ida.calc_ic("ya_ydp", tout1=FOOD_TOUTS[0])
    rows = [tuple(np.asarray(x) for x in jax_ida.get_consistent_ic())]
    for tout in FOOD_TOUTS:
        jax_ida.solve(tout)
        rows.append((_counters(jax_ida.state), np.asarray(jax_ida.state.yy)))
    return rows


# what the pinned JAX runs (jax_krylov_live) are computed from
REF_INPUTS = {"heat_m": HEAT_M, "heat_touts": HEAT_TOUTS, "heat_b": HEAT_B,
              "heat_opts": HEAT_OPTS, "food_m": FOOD_M, "food_touts": FOOD_TOUTS,
              "food_atol": FOOD_ATOL, "food_opts": FOOD_OPTS}


def jax_krylov_live():
    return {"heat": _jax_heat_rows(), "heat_ensemble": _jax_heat_ensemble_rows(),
            "food": _jax_food_rows()}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX runs, pinned (tests/make_torch_refs.py, ``krylov_path_jax``)."""
    return load("krylov_path_jax", REF_INPUTS)


@pytest.fixture(scope="module")
def food_runs(jax_refs):
    """Both packages' IDA: calc_ic("ya_ydp"), then the first two legs
    (ida_tpu's pinned)."""
    ida = _food_ida(port, foodweb_problem(FOOD_M, FOOD_M, device="cpu"), device="cpu")
    ida.calc_ic("ya_ydp", tout1=FOOD_TOUTS[0])
    jax_rows = jax_refs["food"]
    rows = [{"jax": jax_rows[0], "port": ida.get_consistent_ic()}]
    for tout, jax_row in zip(FOOD_TOUTS, jax_rows[1:]):
        ida.solve(tout)
        rows.append({"jax": jax_row, "port": (_port_counters(ida.state), ida.get_yy())})
    return rows


def _close(got, want):
    """Within 1e-9 relative, the scale max(|value|, atol)."""
    err = np.abs(got - want) / np.maximum(np.abs(want), FOOD_ATOL)
    assert err.max() <= 1e-9, (err.max(), int(err.argmax()))


def test_foodweb_calc_ic_matches_ida_tpu(food_runs):
    (jy, jp), (py, pp) = food_runs[0]["jax"], food_runs[0]["port"]
    _close(py, jy)
    _close(pp, jp)
    c = py.reshape(-1, 2)  # predators on the algebraic manifold c_pred ~ EE c_prey
    np.testing.assert_allclose(c[:, 1] / (1.0e4 * c[:, 0]), 1.0, rtol=1e-3)


@pytest.mark.parametrize("i", [1, 2], ids=[f"tout{t}" for t in FOOD_TOUTS])
def test_foodweb_legs_match_ida_tpu(food_runs, i):
    (jc, jy), (pc, py) = food_runs[i]["jax"], food_runs[i]["port"]
    assert pc == jc
    assert pc["nje"] == 0 and pc["nps"] > 0
    _close(py, jy)


# ------------------------------------------------------------------ dtypes


@pytest.mark.parametrize("model", ["heat2d", "foodweb"])
def test_models_keep_float32(model):
    rng = np.random.default_rng(5)
    if model == "heat2d":
        prob = heat2d_problem(6, device="cpu")
        yy = torch.from_numpy(rng.normal(size=(36, 3))).float()
    else:
        prob = foodweb_problem(3, 3, device="cpu")
        yy = torch.from_numpy(rng.uniform(1.0, 2.0, size=(18, 3))).float()
    yp = torch.from_numpy(rng.normal(size=tuple(yy.shape))).float()
    cj = torch.full((3,), 20.0)
    t = torch.zeros(3)
    assert prob.res(t, yy, yp).dtype == torch.float32
    assert prob.jtimes(t, cj, yy, yp, yp).dtype == torch.float32
    pdata = prob.prec_setup(t, cj, yy, yp, yp)
    assert all(x.dtype in (torch.float32, torch.int32) for x in pdata)
    assert prob.prec_solve(pdata, yp, cj).dtype == torch.float32
    # and the f32 blocks are the f64 ones rounded (same operations)
    if model == "foodweb":
        b32 = prec_blocks(3, 3, cj, yy)
        b64 = prec_blocks(3, 3, cj.double(), yy.double())
        assert b32.dtype == torch.float32 and b32.shape == (2, 2, 9, 3)
        np.testing.assert_allclose(b32.numpy(), b64.numpy(), rtol=1e-6)


def test_foodweb_preconditioner_matches_ida_tpu():
    """prec_setup + prec_solve against ida_tpu's on one batch-native input:
    the blocks are factored by the same unrolled LU, so bit for bit."""
    rng = np.random.default_rng(6)
    yy = rng.uniform(1.0, 2.0, size=(2 * FOOD_M ** 2, 3))
    r = rng.normal(size=yy.shape)
    cj = np.array([10.0, 200.0, 3000.0])
    jprob = jax_foodweb(FOOD_M, FOOD_M)
    jp = jprob.prec_setup(0.0, jnp.asarray(cj), jnp.asarray(yy), None, None)
    jz = np.asarray(jprob.prec_solve(jp, jnp.asarray(r), jnp.asarray(cj)))
    prob = foodweb_problem(FOOD_M, FOOD_M, device="cpu")
    pdata = prob.prec_setup(0.0, torch.from_numpy(cj), torch.from_numpy(yy), None, None)
    for got, want in zip(pdata, jp):
        assert tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(prob.prec_solve(pdata, torch.from_numpy(r), None).numpy(), jz)
