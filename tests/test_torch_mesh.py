"""The port's mesh (``ida_tpu_torch.parallel.mesh``) against ``ida_tpu``'s
sharded programs, on the CPU under gloo.

Each test module of the mesh spawns four gloo ranks once
(``tests/torch_mesh_ranks.py``, rendezvous through a file under the
module's temporary directory); each rank runs the module's cases and saves
what it found. The JAX side is ``ida_tpu`` on the conftest's 8 virtual CPU
devices, as ``tests/test_multidevice.py``, ``tests/test_shard_norms.py``
and ``tests/test_bbd_prec.py`` run it; its solves are pinned by
``tests/make_torch_refs.py`` (an op-by-op solve and three jitted sharded
programs take over a minute), computed here for every mesh module.

* dp: Roberts B = 16 at four lanes a rank is bit for bit four per-shard
  runs, equal to the unsharded run and to ``ida_tpu`` run op by op to 0.4.
* the collective norms at n = 64, ``EnsembleIDA(mesh=...)`` against the
  same calls without a mesh.
* sharded N (heat2d, BBD): ``tests/test_torch_mesh_sharded.py``; the food
  web: ``tests/test_torch_mesh_food.py`` and ``_food_modes.py``.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_mesh_ranks as R
from ida_tpu import constants as JC
from ida_tpu.core.calc_ic import IC_YA_YDP_INIT as JIC_YA_YDP
from ida_tpu.core.calc_ic import calc_ic as jcalc_ic
from ida_tpu.core.solve import TASK_NORMAL
from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.core.state import init_state as jinit_state
from ida_tpu.models import foodweb_ic
from ida_tpu.models import foodweb_problem as jfoodweb
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.models.heat2d import heat2d_ic
from ida_tpu.models.heat2d import heat2d_problem as jheat2d
from ida_tpu.ops.bbd import make_bbd_prec as jmake_bbd
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.parallel import make_mesh_2d as jmesh_2d
from ida_tpu.parallel import shard_ensemble_2d as jshard_2d
from ida_tpu.parallel import shard_state_vector as jshard_state
from ida_tpu.problem import IdaProblem as JProblem
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu.tol_control import tol_ss as jtol_ss
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.calc_ic import IC_YA_YDP_INIT, calc_ic
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.core.state import init_state
from ida_tpu_torch.models import roberts_factory
from ida_tpu_torch.norms import wrms_norm, wrms_norm_masked
from ida_tpu_torch.parallel import EnsembleIDA, ensemble_init, make_ensemble_solve, to_native
from ida_tpu_torch.tol_control import tol_ss, tol_sv
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

# what the pinned references are computed from
REF_INPUTS = {"dp": dict(zip(("params", "yy0", "yp0"), R.roberts_inputs(R.B_DP))),
              "rtol": R.ROBERTS_RTOL, "atol": R.ROBERTS_ATOL, "dp_tout": R.DP_TOUT,
              "heat_m": R.HEAT_M, "heat_tout": R.HEAT_TOUT, "bbd_hooks_m": R.BBD_HOOKS_M,
              "nblocks": R.WORLD, "counters": R.COUNTERS}
HEAT_TOL = (1e-5, 1e-8)
FOOD_REF_INPUTS = {"m": R.FOOD_M, "tol": R.FOOD_TOL, "touts": R.FOOD_TOUTS,
                   "opts": R.FOOD_OPTS, "cases": R.FOOD_CASES, "centre": R.FOOD_CENTRE,
                   "level": R.FOOD_ROOT_LEVEL, "lanes": R.FOOD_B}
FOOD_ATOL = R.FOOD_TOL[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the dp, EnsembleIDA and norms cases (one
    spawn for the module)."""
    return R.spawn(str(tmp_path_factory.mktemp("mesh")), ("dp", "ensemble", "norms"))


# ------------------------------------------------------------ JAX references


def jax_dp_op_by_op_live():
    """``ida_tpu``'s batch-native solve of the 16 lanes to 0.4, op by op."""
    params, yy0, yp0 = R.roberts_inputs(R.B_DP)
    b = params.shape[0]
    st = jensemble_init(jroberts, jnp.asarray(params), jnp.asarray(yy0), jnp.asarray(yp0))
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), st)
    tol = JTol(jnp.full((b,), R.ROBERTS_RTOL), jnp.tile(jnp.asarray(R.ROBERTS_ATOL)[:, None], (1, b)))
    with jax.disable_jit():
        out, tret, ist = jsolve(st, jroberts(jnp.asarray(params.T)), JOptions(), tol,
                                jnp.full((b,), R.DP_TOUT), TASK_NORMAL)
    return {"state": {f: np.moveaxis(np.asarray(getattr(out, f)), -1, 0)
                      for f in ("yy", "yp", "phi") + R.COUNTERS},
            "tret": np.asarray(tret), "istate": np.asarray(ist)}


def _jax_counters(st) -> dict:
    return {f: np.asarray(getattr(st, f)) for f in R.COUNTERS}


def jax_sharded_live():
    """``ida_tpu``'s sharded programs (``tests/test_multidevice.py``,
    ``tests/test_bbd_prec.py``): heat2d m = 16 with its state vector over
    the 8 devices, four lanes over the 2 x 4 mesh, the blocked BBD solve and
    hooks over 4 devices in 4 blocks."""
    devs = jax.devices()
    opts = JOptions(linear_solver="spgmr", mxstep=2000)
    tol = jtol_ss(*HEAT_TOL)
    m, n = R.HEAT_M, R.HEAT_M ** 2
    u0, up0 = heat2d_ic(m)
    out = {}

    prob = jheat2d(m, use_prec=True)
    fn = jax.jit(lambda st, tout: jsolve(st, prob, opts, tol, tout, TASK_NORMAL))
    st8 = jshard_state(jinit_state(prob, u0, up0, opts=opts), Mesh(np.asarray(devs), ("batch",)), n)
    st8, tret, ist = fn(st8, jnp.asarray(R.HEAT_TOUT))
    out["heat"] = {"counters": _jax_counters(st8), "yy": np.asarray(st8.yy),
                   "istate": int(ist), "devices": len(st8.phi.sharding.device_set)}

    scales, u0b, up0b = R.heat2d_lanes(m, 4)
    states = jensemble_init(lambda s: prob, jnp.asarray(scales), jnp.asarray(u0b),
                            jnp.asarray(up0b), opts=opts)
    states = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    states = jshard_2d(states, jmesh_2d(2, 4), n)
    st2, _, ist2 = fn(states, jnp.full((4,), R.HEAT_TOUT))
    out["heat_2d"] = {"counters": _jax_counters(st2), "yy": np.asarray(st2.yy),
                      "istate": np.asarray(ist2), "devices": len(st2.phi.sharding.device_set)}

    base = jheat2d(m, use_prec=False)
    bbd = jmake_bbd(base.res, n, 4, 4, nblocks=R.WORLD)
    bprob = JProblem(n=n, res=base.res, id=base.id, **bbd.hooks())
    mesh4 = Mesh(np.asarray(devs[:R.WORLD]), ("batch",))
    sts = jshard_state(jinit_state(bprob, u0, up0, opts=opts), mesh4, n)
    stb, tretb, istb = jax.jit(lambda st, tout: jsolve(st, bprob, opts, tol, tout, TASK_NORMAL))(
        sts, jnp.asarray(R.HEAT_TOUT))
    out["bbd_solve"] = {"counters": _jax_counters(stb), "phi0": np.asarray(stb.phi[0]),
                        "tret": float(tretb), "istate": int(istb)}

    mh = R.BBD_HOOKS_M
    hbase = jheat2d(mh, use_prec=False)
    hbbd = jmake_bbd(hbase.res, mh * mh, 4, 4, nblocks=R.WORLD)
    hu0, hup0 = heat2d_ic(mh)
    r = np.random.default_rng(1).standard_normal(mh * mh)
    t, cj = jnp.asarray(0.0), jnp.asarray(3.0)

    def setup_and_solve(yy, yp, rv):
        return hbbd.prec_solve(hbbd.prec_setup(t, cj, yy, yp, jnp.zeros_like(yy)), rv, cj)

    sh = NamedSharding(mesh4, P("batch"))
    out["bbd_hooks"] = {"x": np.asarray(jax.jit(setup_and_solve)(
        *(jax.device_put(jnp.asarray(v), sh) for v in (hu0, hup0, r))))}
    return out


def _jax_food_problem(case: str):
    prob = jfoodweb(R.FOOD_M, R.FOOD_M)
    p = 2 * R.FOOD_CENTRE
    if case == "roots":
        prob = dataclasses.replace(prob, root=lambda t, yy, yp: yp[p:p + 1] - R.FOOD_ROOT_LEVEL,
                                   nroots=1)
    if case == "quad":
        prob = dataclasses.replace(prob, quad=lambda t, yy, yp: jnp.sum(yy[0::2], axis=0,
                                                                          keepdims=True), nquad=1)
    return prob


def jax_food_live():
    """``ida_tpu``'s jitted programs of the 8 x 8 food web with its state
    vector over the 8 devices (``shard_state_vector``, as
    ``tests/test_multidevice.py``): calc_ic("ya_ydp"), then the legs of
    each case from that IC, a root return resumed (the rank side's
    ``food_legs``); and four lanes (vmapped calc_ic) over the 2 x 4 mesh."""
    mesh8 = Mesh(np.asarray(jax.devices()), ("batch",))
    tol = jtol_ss(*R.FOOD_TOL)
    c0, cp0 = foodweb_ic(R.FOOD_M, R.FOOD_M)
    base, opts0 = jfoodweb(R.FOOD_M, R.FOOD_M), JOptions(**R.FOOD_OPTS)
    tout1 = jnp.asarray(R.FOOD_TOUTS[0])
    ic_fn = jax.jit(partial(jcalc_ic, problem=base, opts=opts0, tol=tol, icopt=JIC_YA_YDP))
    st, ok = ic_fn(jshard_state(jinit_state(base, c0, cp0, opts=opts0), mesh8, base.n),
                   tout1=tout1)
    out = {"ic": {"ok": bool(ok), "phi0": np.asarray(st.phi[0]), "phi1": np.asarray(st.phi[1]),
                  "devices": len(st.phi.sharding.device_set)}}
    for case, kw in R.FOOD_CASES.items():
        prob, opts = _jax_food_problem(case), JOptions(**R.FOOD_OPTS, **kw)
        cst = jinit_state(prob, c0, cp0, opts=opts)
        if case == "constraints":
            cst = cst._replace(constraints=jnp.ones_like(cst.constraints),
                               constraints_set=jnp.asarray(True))
        cst = jshard_state(cst, mesh8, prob.n)._replace(phi=st.phi, yy=st.yy, yp=st.yp)
        fn = jax.jit(partial(jsolve, problem=prob, opts=opts, tol=tol, itask=TASK_NORMAL))
        calls = []
        for tout in R.FOOD_TOUTS:
            for _ in range(4):
                cst, tret, ist = fn(cst, tout=jnp.asarray(tout))
                calls.append({"tret": float(tret), "istate": int(ist),
                              "counters": {f: int(getattr(cst, f)) for f in R.COUNTERS + ("nge",)},
                              "iroots": np.asarray(cst.iroots), "yQ": np.asarray(cst.yQ),
                              "yy": np.asarray(cst.yy)})
                if not (int(ist) == JC.ROOT_RETURN and float(tret) < tout):
                    break
        out[case] = calls

    scales = np.linspace(0.95, 1.05, R.FOOD_B)

    def ic_one(scale):
        lane = jinit_state(base, c0 * jnp.where(base.id, scale, 1.0), cp0, opts=opts0)
        return jcalc_ic(lane, base, opts0, tol, JIC_YA_YDP, tout1)

    states, ok4 = jax.jit(jax.vmap(ic_one))(jnp.asarray(scales))
    states = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
    states = jshard_2d(states, jmesh_2d(2, 4), base.n)
    fn = jax.jit(partial(jsolve, problem=base, opts=opts0, tol=tol, itask=TASK_NORMAL))
    calls = []
    for tout in R.FOOD_TOUTS:
        states, _, ist = fn(states, tout=jnp.full((R.FOOD_B,), tout))
        calls.append({"istate": np.asarray(ist), "yy": np.asarray(states.yy),
                      "counters": {f: np.asarray(getattr(states, f)) for f in R.COUNTERS}})
    out["2d"] = {"ic_ok": np.asarray(ok4), "calls": calls,
                 "devices": len(states.phi.sharding.device_set)}
    return out


@pytest.fixture(scope="module")
def jax_food():
    return load("mesh_foodweb_programs", FOOD_REF_INPUTS)


@pytest.fixture(scope="module")
def jax_dp():
    return load("mesh_dp_op_by_op", REF_INPUTS)


@pytest.fixture(scope="module")
def jax_sharded():
    return load("mesh_sharded_programs", REF_INPUTS)


# ------------------------------------------------- the port without a mesh


def _roberts_tol():
    return tol_sv(R.ROBERTS_RTOL, R.ROBERTS_ATOL, device="cpu")


@pytest.fixture(scope="module")
def unsharded_dp():
    params, yy0, yp0 = R.roberts_inputs(R.B_DP)
    st = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu")
    return make_ensemble_solve(roberts_factory)(st, params, _roberts_tol(), R.DP_TOUT)


def food_unsharded_of(cases, two_d: bool) -> dict:
    """The port's unsharded food web: calc_ic, the legs of each of ``cases``
    from that IC (the rank side's helpers), the base legs' pdata; with
    ``two_d``, the four lanes batch-native."""
    tol, prob = R.food_tol(), R.food_problem()
    st, ok = calc_ic(R.food_state(), prob, R.food_opts(), tol, IC_YA_YDP_INIT, R.FOOD_TOUTS[0])
    out = {"ic_ok": bool(ok), "ic": [st.phi[0].numpy(), st.phi[1].numpy()]}
    for case in cases:
        p, opts = R.food_problem(case), R.food_opts(case)
        cst = R.food_state(case)._replace(phi=st.phi, yy=st.yy, yp=st.yp)
        calls, end = R.food_legs(cst, lambda s, tout: tsolve(s, p, opts, tol, tout), lambda x: x)
        out[case] = calls
        if case == "base":
            out["pdata"] = [x.numpy() for x in end.pdata]
    if not two_d:
        return out
    st4, ok4 = calc_ic(R.food_state(b=R.FOOD_B), prob, R.food_opts(), tol, IC_YA_YDP_INIT,
                       R.FOOD_TOUTS[0])
    ic_yy = st4.yy.numpy()
    calls = []
    for tout in R.FOOD_TOUTS:
        st4, _, ist = tsolve(st4, prob, R.food_opts(), tol,
                             torch.full((R.FOOD_B,), tout, dtype=torch.float64))
        calls.append({"istate": ist.numpy(), "yy": st4.yy.numpy(), "counters": _counters(st4)})
    out["2d"] = {"ic_ok": ok4.numpy(), "ic_yy": ic_yy, "calls": calls}
    return out


def _heat_unsharded(prob, b=None):
    opts = R.HEAT_OPTS
    tol = tol_ss(*HEAT_TOL, device="cpu")
    if b is None:
        u0, up0 = heat2d_ic(R.HEAT_M)
        return tsolve(init_state(prob, u0, up0, opts=opts, device="cpu"), prob, opts, tol,
                      R.HEAT_TOUT)
    scales, u0b, up0b = R.heat2d_lanes(R.HEAT_M, b)
    st = to_native(ensemble_init(lambda s: prob, scales[:, None], u0b, up0b, opts=opts,
                                 device="cpu"))
    return tsolve(st, prob, opts, tol, R.HEAT_TOUT)


def _counters(st) -> dict:
    return {f: getattr(st, f).numpy() for f in R.COUNTERS}


def _same(a, b) -> bool:
    """Bit for bit (signed zeros and NaNs included)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------------------------------ dp


def test_dp_shards_are_bit_for_bit_their_per_shard_runs(ranks):
    for rank in ranks:
        dp = rank["dp"]
        for f, x in dp["per_shard"].items():
            assert _same(dp["shard"][f], x), f
        assert np.all(dp["per_shard_istate"] == C.SUCCESS)


def test_dp_equals_the_unsharded_run_and_ida_tpu_op_by_op(ranks, unsharded_dp, jax_dp):
    st1, tret1, ist1 = unsharded_dp
    for rank in ranks:
        dp = rank["dp"]
        assert _same(dp["istate"], ist1.numpy()) and _same(dp["tret"], tret1.numpy())
        for f in ("yy", "yp", "phi") + R.COUNTERS:
            assert _same(dp["whole"][f], getattr(st1, f).numpy()), f
    dp = ranks[0]["dp"]
    np.testing.assert_array_equal(dp["istate"], jax_dp["istate"])
    np.testing.assert_array_equal(dp["tret"], jax_dp["tret"])
    for f in R.COUNTERS:
        np.testing.assert_array_equal(dp["whole"][f], jax_dp["state"][f], err_msg=f)
    for f in ("yy", "yp", "phi"):
        assert _same(dp["whole"][f], jax_dp["state"][f]), f


# ------------------------------------------------------- the collective norms


def test_collective_norms_match_the_unsharded_ones():
    # tests/test_shard_norms.py's inputs; the ranks' values against the
    # port's and ida_tpu's unsharded norms
    from ida_tpu.norms import wrms_norm as jwrms
    from ida_tpu.norms import wrms_norm_masked as jwrms_masked

    rng = np.random.default_rng(0)
    x = rng.normal(size=64)
    w = 1.0 / (np.abs(rng.normal(size=64)) + 1.0)
    mask = rng.uniform(size=64) > 0.3
    tx, tw, tm = torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(mask)
    plain, masked = float(wrms_norm(tx, tw)), float(wrms_norm_masked(tx, tw, tm))
    np.testing.assert_allclose(plain, float(jwrms(jnp.asarray(x), jnp.asarray(w))), rtol=1e-12)
    np.testing.assert_allclose(masked, float(jwrms_masked(jnp.asarray(x), jnp.asarray(w),
                                                          jnp.asarray(mask))), rtol=1e-12)


def test_collective_norms_on_the_ranks(ranks):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=64))
    w = torch.as_tensor(1.0 / (np.abs(rng.normal(size=64)) + 1.0))
    mask = torch.as_tensor(rng.uniform(size=64) > 0.3)
    for rank in ranks:
        assert rank["norms"]["plain"] == float(wrms_norm(x, w))
        assert rank["norms"]["masked"] == float(wrms_norm_masked(x, w, mask))


# ------------------------------------------------------- EnsembleIDA(mesh=)


def test_ensemble_ida_with_a_mesh_returns_what_it_returns_without(ranks):
    params, yy0, yp0 = R.roberts_inputs(R.B_DP)
    ens = EnsembleIDA(roberts_factory, params, yy0, yp0, _roberts_tol(), device="cpu")
    want = {"solve": ens.solve(R.DP_TOUT), "one_step": ens.solve(4.0, one_step=True),
            "yy": ens.yy, "nst": ens.nst}
    states = ens.states
    grid = EnsembleIDA(roberts_factory, params, yy0, yp0, _roberts_tol(), device="cpu")
    want["grid"] = grid.solve_grid(np.asarray(R.GRID_TOUTS))
    for rank in ranks:
        got = rank["ensemble"]
        for key in ("solve", "one_step", "grid"):
            assert len(got[key]) == len(want[key])
            for a, b in zip(got[key], want[key]):
                assert _same(a, b), key
        assert _same(got["yy"], want["yy"]) and _same(got["nst"], want["nst"])
        for f, x in zip(states._fields, states):
            if isinstance(x, torch.Tensor):
                assert _same(got["states"][f], x.numpy()), f


def test_ensemble_ida_refuses_a_batch_that_does_not_divide(ranks):
    for rank in ranks:
        assert "does not divide over the 4 ranks" in rank["ensemble"]["indivisible"]


# ------------------------ the food web's comparisons (test_torch_mesh_food*.py)


def _close(got, want):
    """Within 1e-9 relative, the scale max(|value|, atol)
    (``tests/test_torch_krylov_path.py``'s food-web bound)."""
    err = np.abs(np.asarray(got) - want) / np.maximum(np.abs(want), FOOD_ATOL)
    assert err.max() <= 1e-9, (err.max(), int(err.argmax()))


def _same_calls(got: list, want: list) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("tret", "istate", "iroots", "yQ", "yy"):
            assert _same(a[k], b[k]), k
        for f, x in b["counters"].items():
            assert _same(a["counters"][f], x), f


def _jax_calls(got: list, ref: list) -> None:
    """Counters, istates and root returns as ``ida_tpu``'s; tret, yQ and
    yy within the food-web bound."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert int(a["istate"]) == b["istate"]
        assert {f: int(x) for f, x in a["counters"].items()} == b["counters"]
        np.testing.assert_array_equal(a["iroots"], b["iroots"])
        np.testing.assert_allclose(float(a["tret"]), b["tret"], rtol=1e-12)
        _close(a["yQ"], b["yQ"])
        _close(a["yy"], b["yy"])


