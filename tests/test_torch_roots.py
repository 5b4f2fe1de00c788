"""The port's rootfinding (``core/root.py``, the root branches of ``solve``)
against the JAX package and the native C++ oracle.

* Per function (``_scan``, ``r_check1``, ``r_check2``, ``_root_find``,
  ``r_check3``): the same state, carried over through ``utils.convert``, goes
  through the JAX function run op by op (``jax.disable_jit()``: one rounding
  per operation, as the port and C IDA do) and through the port's; every
  field must agree bit for bit. One lane and a batch-native B = 8.
* Whole path: rooted Roberts at B = 4 through its first root to t = 1 against
  the op-by-op JAX solve, bit for bit (tests/test_torch_roots_path.py holds
  the 12-decade run against the jitted solve and the native oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core import interp as ji
from ida_tpu.core import root as jroot
from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YY0
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.problem import IdaProblem as JProblem
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu_torch import constants as C
from ida_tpu_torch.core import root as troot
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.models import roberts_problem as troberts_problem
from ida_tpu_torch.problem import IdaProblem as TProblem
from ida_tpu_torch.utils.convert import params_from_numpy, state_from_numpy, tol_from_numpy
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

B = 8
ATOL = [1e-8, 1e-6, 1e-6]
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn", "nge")
TOUTS = 0.4 * 10.0 ** np.arange(12)


def _fields(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields if f != "pdata"}


def to_port(st):
    return state_from_numpy({**_fields(st), "pdata": ()}, device="cpu", batch="trailing")


def assert_states_bitwise(got, ref, what=""):
    """Every field of the port's state equals the JAX state's, bit for bit
    (NaN equal to NaN), in dtype and shape too."""
    for f, a in _fields(ref).items():
        b = getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")


def _params(b):
    return np.outer(np.exp(np.linspace(-0.2, 0.2, b)), ROBERTS_PARAMS)


# --------------------------------------------------- mid-flight rooted states


def _jax_setup():
    """(state at t0, problem, tol) of rooted Roberts, B lanes batch-native."""
    params = _params(B)
    yy0 = np.tile(ROBERTS_YY0, (B, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    fac = lambda p: jroberts(p, with_roots=True)  # noqa: E731
    st = jensemble_init(fac, jnp.asarray(params), jnp.asarray(yy0), jnp.asarray(yp0))
    st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), st)
    tol = JTol(jnp.full((B,), 1e-4), jnp.tile(jnp.asarray(ATOL)[:, None], (1, B)))
    return st, jroberts(jnp.asarray(params.T), with_roots=True), tol


@pytest.fixture(scope="module")
def batch_run():
    """The batch-native B = 8 JAX run to its first ROOT_RETURN (jitted: the
    states are only inputs)."""
    st0, prob, tol = _jax_setup()
    at_root, _, ist = jax.jit(lambda s: jsolve(s, prob, JOptions(), tol, jnp.full((B,), 0.4)))(st0)
    assert bool(jnp.all(ist == C.ROOT_RETURN))
    return st0, at_root


@pytest.fixture(scope="module", params=[False, True], ids=["one_lane", "batch8"])
def rooted(request, batch_run):
    """JAX states of the rooted run: at the first ROOT_RETURN (``at_root``:
    irfnd set, tlo at the root), and that state wound back to before its
    ``r_check3`` (``before``: tlo and glo at the start of the last step,
    nothing found yet). ``one_lane`` is lane 2 of the batch, as an
    unbatched state with its own parameters."""
    batched = request.param
    st0, at_root = batch_run
    if batched:
        prob = jroberts(jnp.asarray(_params(B).T), with_roots=True)
        tprob = troberts(params_from_numpy(_params(B), device="cpu"), with_roots=True)
    else:
        st0, at_root = (jax.tree_util.tree_map(lambda x: x[..., 2], s) for s in (st0, at_root))
        prob = jroberts(jnp.asarray(_params(B)[2]), with_roots=True)
        tprob = troberts(torch.from_numpy(_params(B)[2].copy()), with_roots=True)
    tlo = at_root.tn - at_root.hused
    yy, yp = ji.interpolate(at_root, tlo)
    before = at_root._replace(
        tlo=tlo, glo=prob.root(tlo, yy, yp), iroots=jnp.zeros_like(at_root.iroots),
        irfnd=jnp.zeros_like(at_root.irfnd),
    )
    return {"batched": batched, "jprob": prob, "tprob": tprob, "t0": st0,
            "at_root": at_root, "before": before}


def test_converted_rooted_state_keeps_every_field(rooted):
    # [R] fields included: glo, ghi, grout, iroots, rootdir, gactive
    st = rooted["at_root"]
    got = to_port(st)
    assert got.glo.shape == st.glo.shape and got.glo.shape[0] == 2
    assert_states_bitwise(got, st, "convert")


def test_r_check1_matches_op_by_op(rooted):
    # the first-call state with a step size chosen, as _first_call_init calls it
    st = rooted["t0"]._replace(hh=jnp.full(rooted["t0"].tn.shape, 1.0e-5))
    with jax.disable_jit():
        ref = jroot.r_check1(st, rooted["jprob"])
    assert_states_bitwise(troot.r_check1(to_port(st), rooted["tprob"]), ref, "r_check1")


def test_r_check1_deactivates_exact_zeros(rooted):
    # g0 = y1 - 1 is exactly zero at t0 and moves off at the probe point;
    # g1 = y2 stays zero along the linear probe only if y2' = 0 (it is not)
    st = rooted["t0"]._replace(hh=jnp.full(rooted["t0"].tn.shape, 1.0e-5))
    jp = JProblem(n=3, res=rooted["jprob"].res, nroots=2,
                  root=lambda t, y, yp: jnp.stack([y[0] - 1.0, y[2]]))
    tp = TProblem(n=3, res=rooted["tprob"].res, nroots=2,
                  root=lambda t, y, yp: torch.stack([y[0] - 1.0, y[2]]))
    with jax.disable_jit():
        ref = jroot.r_check1(st, jp)
    got = troot.r_check1(to_port(st), tp)
    assert_states_bitwise(got, ref, "r_check1 zeros")
    assert int(got.nge.reshape(-1)[0]) == 2  # both evaluations count
    assert bool(got.gactive[0].all()) and not bool(got.gactive[1].any())


def test_r_check3_finds_the_root_like_op_by_op(rooted):
    st = rooted["before"]
    with jax.disable_jit():
        ref = jroot.r_check3(st, rooted["jprob"], JOptions(), True)
    got = troot.r_check3(to_port(st), rooted["tprob"], IdaOptions(), True)
    assert bool(np.all(np.asarray(ref.found)))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    assert_states_bitwise(got.state, ref.state, "r_check3")
    # and the located time is the one the whole solve returned
    np.testing.assert_array_equal(got.state.tlo.numpy(), np.asarray(rooted["at_root"].tlo))


def test_r_check3_one_step_task_and_no_root(rooted):
    # after the root nothing changes sign in what is left of the step
    st = rooted["at_root"]
    with jax.disable_jit():
        ref = jroot.r_check3(st, rooted["jprob"], JOptions(), False)
    got = troot.r_check3(to_port(st), rooted["tprob"], IdaOptions(), False)
    assert not bool(np.any(np.asarray(ref.found)))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    assert_states_bitwise(got.state, ref.state, "r_check3 one_step")


def test_root_find_matches_op_by_op(rooted):
    st = rooted["before"]
    yy, yp = ji.interpolate(st, st.tn)
    st = st._replace(
        thi=st.tn, ghi=rooted["jprob"].root(st.tn, yy, yp),
        ttol=(jnp.abs(st.tn) + jnp.abs(st.hh)) * float(jnp.finfo(st.dtype).eps) * 100.0,
    )
    with jax.disable_jit():
        ref_st, ref_found = jroot._root_find(st, rooted["jprob"], JOptions())
    troot.reset_pass_count()
    got_st, got_found = troot._root_find(to_port(st), rooted["tprob"], IdaOptions())
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(ref_found))
    assert_states_bitwise(got_st, ref_st, "_root_find")
    assert 0 < troot.ILLINOIS_PASSES <= IdaOptions().max_root_iters
    # evaluations in the search: a lane stops counting when it converges
    assert bool(np.all(np.asarray(ref_st.nge - st.nge) > 0))


def test_root_find_respects_the_iteration_bound(rooted):
    st = to_port(rooted["before"])
    yy, yp = ji.interpolate(rooted["before"], rooted["before"].tn)
    ghi = torch.from_numpy(np.array(rooted["jprob"].root(rooted["before"].tn, yy, yp)))
    st = st._replace(thi=st.tn, ghi=ghi, ttol=torch.zeros_like(st.ttol))  # never converges
    troot.reset_pass_count()
    troot._root_find(st, rooted["tprob"], IdaOptions(max_root_iters=3))
    assert troot.ILLINOIS_PASSES == 3


def test_r_check2_matches_op_by_op(rooted):
    st = rooted["at_root"]
    with jax.disable_jit():
        ref = jroot.r_check2(st, rooted["jprob"])
    got = troot.r_check2(to_port(st), rooted["tprob"])
    for name in ("found", "close_roots"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), name)
    assert_states_bitwise(got.state, ref.state, "r_check2")


def test_r_check2_skips_lanes_whose_last_return_was_no_root(rooted):
    # irfnd False: nothing changes, nge included
    st = rooted["at_root"]._replace(irfnd=jnp.zeros_like(rooted["at_root"].irfnd))
    with jax.disable_jit():
        ref = jroot.r_check2(st, rooted["jprob"])
    got = troot.r_check2(to_port(st), rooted["tprob"])
    assert_states_bitwise(got.state, ref.state, "r_check2 skipped")
    assert_states_bitwise(got.state, st, "r_check2 skipped: unchanged")
    assert not bool(got.found.any()) and not bool(got.close_roots.any())


def test_r_check2_exact_zero_at_the_last_root(rooted):
    # g1 = y3 - y3(tlo) is exactly zero at tlo and moves off at the probe: no
    # new root, glo takes the probe's value. g0 = 0 * y1 is zero at both: a
    # second zero of another component just past the root counts as found
    st = rooted["at_root"]
    yy_lo = np.asarray(ji.interpolate(st, st.tlo)[0])
    jp = JProblem(n=3, res=rooted["jprob"].res, nroots=2,
                  root=lambda t, y, yp: jnp.stack([y[0] * 0.0, y[2] - jnp.asarray(yy_lo[2])]))
    c2 = torch.from_numpy(np.array(yy_lo[2]))
    tp = TProblem(n=3, res=rooted["tprob"].res, nroots=2,
                  root=lambda t, y, yp: torch.stack([y[0] * 0.0, y[2] - c2]))
    with jax.disable_jit():
        ref = jroot.r_check2(st, jp)
    got = troot.r_check2(to_port(st), tp)
    for name in ("found", "close_roots"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), name)
    assert_states_bitwise(got.state, ref.state, "r_check2 zeros")
    assert bool(got.close_roots.all())  # g0 is zero at tlo and at the probe


# ---------------------------------------------------------------- _scan


def _scan_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    glo = rng.normal(size=shape)
    gnew = rng.normal(size=shape)
    gnew[rng.random(shape) < 0.2] = 0.0  # exact zeros at the far end
    glo[0] = -gnew[0]  # ties: fraction exactly 1/2 in component 0 ...
    if shape[0] > 2:
        glo[2] = -gnew[2]  # ... and in component 2
    gactive = rng.random(shape) < 0.8
    rootdir = rng.integers(-1, 2, size=shape).astype(np.int32)
    return gactive, rootdir, glo, gnew


@pytest.mark.parametrize("shape", [(2,), (3,), (2, B), (3, B), (5, 64)], ids=str)
def test_scan_matches_jax(shape):
    args = _scan_inputs(len(shape) * 10 + shape[0], shape)
    with jax.disable_jit():
        ref = jroot._scan(*(jnp.asarray(a) for a in args))
    got = troot._scan(*(torch.from_numpy(a) for a in args))
    for name, r, g in zip(("zroot", "sgnchg", "imax"), ref, got):
        assert np.asarray(r).dtype == g.numpy().dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)


def test_scan_ties_and_no_change_pick_component_zero():
    glo = torch.tensor([[-1.0, 1.0], [-1.0, 1.0]], dtype=torch.float64)
    gnew = torch.tensor([[1.0, 2.0], [1.0, 2.0]], dtype=torch.float64)
    active = torch.ones(2, 2, dtype=torch.bool)
    _, sgnchg, imax = troot._scan(active, torch.zeros(2, 2, dtype=torch.int32), glo, gnew)
    assert sgnchg.tolist() == [True, False]
    assert imax.tolist() == [0, 0]
    assert np.asarray(jroot._scan(*(jnp.asarray(x.numpy()) for x in (
        active, torch.zeros(2, 2, dtype=torch.int32), glo, gnew)))[2]).tolist() == [0, 0]


# ------------------------------------------------------- whole path, op by op


FIRST_ROOT_LEGS = (0.4, 0.4, 1.0)
FIRST_ROOT_B = 4
# what the pinned reference (first_root_op_by_op_live) is computed from
REF_INPUTS = {"params": _params(FIRST_ROOT_B), "legs": FIRST_ROOT_LEGS, "yy0": ROBERTS_YY0,
              "rtol": 1e-4, "atol": ATOL}


def first_root_op_by_op_live():
    """The op-by-op JAX solve of B = 4 batch-native rooted lanes: the
    initial state, then (state, tret, istate) of each call toward
    FIRST_ROOT_LEGS, and the tolerances."""
    b = FIRST_ROOT_B
    params = _params(b)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    fac = lambda p: jroberts(p, with_roots=True)  # noqa: E731
    jst = jensemble_init(fac, jnp.asarray(params), jnp.asarray(yy0), jnp.asarray(yp0))
    jst = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), jst)
    jprob = jroberts(jnp.asarray(params.T), with_roots=True)
    jtol = JTol(jnp.full((b,), 1e-4), jnp.tile(jnp.asarray(ATOL)[:, None], (1, b)))
    out = {"init": jst, "rtol": jtol.rtol, "atol": jtol.atol, "legs": []}
    for tout in FIRST_ROOT_LEGS:
        with jax.disable_jit():
            jst, jtret, jist = jsolve(jst, jprob, JOptions(), jtol, jnp.full((b,), tout))
        out["legs"].append((jst, jtret, jist))
    return out


def test_rooted_solve_through_first_root_bitwise_op_by_op():
    """B = 4 batch-native: the call that returns every lane's first root, the
    re-entry that lands on 0.4, and a further leg, each bit for bit the
    op-by-op JAX solve (state, tret, istate; :func:`first_root_op_by_op_live`,
    pinned by tests/make_torch_refs.py)."""
    b = FIRST_ROOT_B
    params = _params(b)
    ref = load("roots_first_root", REF_INPUTS)
    tst = to_port(ref["init"])
    tprob = troberts(params_from_numpy(params, device="cpu"), with_roots=True)
    ttol = tol_from_numpy({"rtol": ref["rtol"], "atol": ref["atol"]}, device="cpu",
                          batch="trailing")
    expected = [C.ROOT_RETURN, C.SUCCESS, C.SUCCESS]
    for tout, code, (jst, jtret, jist) in zip(FIRST_ROOT_LEGS, expected, ref["legs"]):
        tst, ttret, tist = tsolve(tst, tprob, IdaOptions(), ttol, tout)
        assert np.asarray(jist).tolist() == [code] * b
        np.testing.assert_array_equal(tist.numpy(), np.asarray(jist))
        np.testing.assert_array_equal(ttret.numpy(), np.asarray(jtret))
        assert_states_bitwise(tst, jst, f"solve toward {tout}")
        if code == C.ROOT_RETURN:
            assert tst.iroots.t().tolist() == [[0, 1]] * b


def test_f32_root_function_stays_f32():
    prob = troberts_problem(with_roots=True, device="cpu")
    y = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32)
    assert prob.root(torch.tensor(0.0, dtype=torch.float32), y, y).dtype == torch.float32
    assert prob.res(torch.tensor(0.0, dtype=torch.float32), y, y).dtype == torch.float32
    fac = troberts(torch.tensor(ROBERTS_PARAMS, dtype=torch.float32), with_roots=True)
    assert fac.root(torch.tensor(0.0, dtype=torch.float32), y, y).dtype == torch.float32
    cj = torch.tensor(2.0, dtype=torch.float32)
    assert prob.jac(cj, cj, y, y, y).dtype == torch.float32
