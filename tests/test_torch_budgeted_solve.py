"""The port's budgeted solve (``core.solve`` with ``max_attempts`` and
``resume_carry``, the plain version of the budgeted kernel and its
continuation) against the JAX package's, as tests/test_budgeted_solve.py
runs it there:

* one lane to tout 4 with a budget of 7 (several resumes), against the JAX
  solve run op by op (``jax.disable_jit``): istate, tret, the counters and
  the number of resumes exactly, every float bit for bit;
* heterogeneous lanes with a budget of 5, against the jitted, vmapped JAX
  solve: istate and the counters exactly, tret to 1e-13 relative (XLA:CPU
  contracts multiply-adds into FMAs), in ``test_torch_budgeted_hetero.py``
  (a file of one test, which queues last);
* TASK_ONE_STEP with a budget of 2;
* the port's budgeted and resumed solve is bit for bit its unbudgeted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core.solve import TASK_ONE_STEP as J_ONE_STEP
from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.core.state import init_state as jinit_state
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.tol_control import tol_sv as jtol_sv
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.solve import TASK_ONE_STEP, TASK_NORMAL
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.core.state import IdaOptions, init_state
from ida_tpu_torch.models import roberts_factory as troberts
from ida_tpu_torch.ops import make_fused_solve
from ida_tpu_torch.parallel import ensemble_init, to_native
from ida_tpu_torch.tol_control import TolControl, tol_sv
from make_torch_refs import load

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

ATOL = [1e-8, 1e-6, 1e-6]
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn")
FLOATS = ("phi", "psi", "yy", "yp", "ee", "tn", "hh", "hused", "rr", "cj", "ewt", "savres")
RTOL = 1e-4
# the one-lane budgeted solve of the pinned reference (one_lane_op_by_op_live)
ONE_LANE_TOUT = 4.0
ONE_LANE_BUDGET = 7
REF_INPUTS = {"params": ROBERTS_PARAMS, "yy0": ROBERTS_YY0, "yp0": ROBERTS_YP0, "rtol": RTOL,
              "atol": ATOL, "tout": ONE_LANE_TOUT, "max_attempts": ONE_LANE_BUDGET}


def _port_budgeted(st, prob, tol, tout, budget, itask=TASK_NORMAL):
    """First call, then resumes until no lane is CONTINUE; also the number
    of calls."""
    opts = IdaOptions()
    st, tret, ist, carry = tsolve(st, prob, opts, tol, tout, itask, max_attempts=budget)
    calls = 1
    while bool((ist == C.CONTINUE).any()):
        st, tret, ist, carry = tsolve(st, prob, opts, tol, tout, itask, max_attempts=budget,
                                      resume_carry=carry)
        calls += 1
        assert calls < 200
    return st, tret, ist, calls


def _jax_budgeted(first, again, st):
    st, tret, ist, carry = first(st)
    calls = 1
    while (np.asarray(ist) == C.CONTINUE).any():
        st, tret, ist, carry = again(st, carry)
        calls += 1
        assert calls < 200
    return st, tret, ist, calls


def _one_lane_port():
    prob = troberts(torch.from_numpy(ROBERTS_PARAMS))
    return init_state(prob, ROBERTS_YY0, ROBERTS_YP0, device="cpu"), prob, tol_sv(RTOL, ATOL, device="cpu")


def _one_lane_jax():
    prob = jroberts(jnp.asarray(ROBERTS_PARAMS))
    return jinit_state(prob, ROBERTS_YY0, ROBERTS_YP0, opts=JOptions()), prob, jtol_sv(RTOL, jnp.asarray(ATOL))


@pytest.fixture(scope="module")
def one_lane_op_by_op():
    """:func:`one_lane_op_by_op_live`, pinned by tests/make_torch_refs.py."""
    return load("budgeted_one_lane", REF_INPUTS)


def one_lane_op_by_op_live():
    """The JAX budgeted solve of one lane to tout 4, budget 7, op by op."""
    st, prob, tol = _one_lane_jax()
    tout, budget = jnp.asarray(ONE_LANE_TOUT), ONE_LANE_BUDGET
    with jax.disable_jit():
        return _jax_budgeted(
            lambda s: jsolve(s, prob, JOptions(), tol, tout, max_attempts=budget),
            lambda s, c: jsolve(s, prob, JOptions(), tol, tout, max_attempts=budget,
                                resume_carry=c),
            st,
        )


def test_one_lane_budget_matches_op_by_op_reference(one_lane_op_by_op):
    jst, jtret, jist, jcalls = one_lane_op_by_op
    st, prob, tol = _one_lane_port()
    got, tret, ist, calls = _port_budgeted(st, prob, tol, ONE_LANE_TOUT, ONE_LANE_BUDGET)
    assert calls == jcalls and calls > 3  # the budget bit
    assert int(ist) == int(jist) == C.SUCCESS
    assert float(tret) == float(jtret)
    for f in COUNTERS:
        assert int(getattr(got, f)) == int(getattr(jst, f)), f
    for f in FLOATS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)


def _hetero_inputs(b=5):
    params = np.outer(np.linspace(0.5, 2.0, b), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


def _hetero_port(budget):
    params, yy0, yp0 = _hetero_inputs()
    st = to_native(ensemble_init(troberts, params, yy0, yp0, device="cpu"))
    b = params.shape[0]
    tol = TolControl(torch.full((b,), 1e-4, dtype=torch.float64),
                     torch.tensor(ATOL, dtype=torch.float64)[:, None].expand(3, b))
    prob = troberts(torch.from_numpy(params).t().contiguous())
    if budget is None:
        return tsolve(st, prob, IdaOptions(), tol, 0.4)
    return _port_budgeted(st, prob, tol, 0.4, budget)


def test_heterogeneous_budgeted_is_bitwise_the_unbudgeted_solve():
    ref = _hetero_port(None)
    got = _hetero_port(5)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    for f, x in zip(ref[0]._fields, ref[0]):
        if isinstance(x, torch.Tensor):
            assert torch.equal(getattr(got[0], f), x), f


def test_one_step_task_under_a_budget():
    jst0, jprob, jtol = _one_lane_jax()
    first = jax.jit(lambda s: jsolve(s, jprob, JOptions(), jtol, jnp.asarray(4.0), J_ONE_STEP,
                                     max_attempts=2))
    again = jax.jit(lambda s, c: jsolve(s, jprob, JOptions(), jtol, jnp.asarray(4.0), J_ONE_STEP,
                                        max_attempts=2, resume_carry=c))
    jst, jtret, jist, jcalls = _jax_budgeted(first, again, jst0)

    st, prob, tol = _one_lane_port()
    got, tret, ist, calls = _port_budgeted(st, prob, tol, 4.0, 2, itask=TASK_ONE_STEP)
    ref = tsolve(st, prob, IdaOptions(), tol, 4.0, TASK_ONE_STEP)
    assert int(ist) == int(jist) == C.SUCCESS and calls == jcalls
    assert int(got.nst) == 1
    np.testing.assert_allclose(float(tret), float(jtret), rtol=1e-13, atol=0)
    for f in COUNTERS:
        assert int(getattr(got, f)) == int(getattr(jst, f)), f
    # and bit for bit the port's own unbudgeted ONE_STEP call
    assert torch.equal(tret, ref[1]) and torch.equal(got.yy, ref[0].yy)


def test_resume_carry_requires_a_budget():
    st, prob, tol = _one_lane_port()
    _, _, _, carry = tsolve(st, prob, IdaOptions(), tol, 4.0, max_attempts=1)
    with pytest.raises(ValueError):
        tsolve(st, prob, IdaOptions(), tol, 4.0, resume_carry=carry)
    with pytest.raises(ValueError):
        tsolve(st, prob, IdaOptions(), tol, 4.0, max_attempts=0)


@pytest.mark.parametrize("tol_form", ["shared", "per-lane"])
def test_fused_entry_budgeted_plain_version_is_its_unbudgeted_one(tol_form):
    # the fused entry point's budgeted host loop on CPU tensors (the plain
    # version of K3/K4), with the tolerances shared or per lane (rtol [B],
    # atol [B, N]): bit for bit the unbudgeted call, and the input untouched
    b = 5
    params = np.outer(np.exp(np.linspace(-0.5, 0.5, b)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st0 = ensemble_init(troberts, params, yy0, yp0, device="cpu")
    tol = tol_sv(1e-4, ATOL, device="cpu")
    if tol_form == "per-lane":
        scale = torch.linspace(0.5, 2.0, b, dtype=torch.float64)
        tol = TolControl(tol.rtol * scale, tol.atol * scale[:, None])
    ref = make_fused_solve(troberts, tol)(st0, params, 4.0)
    got = make_fused_solve(troberts, tol, attempt_budget=4)(st0, params, 4.0)
    assert bool((ref[2] == C.SUCCESS).all()) and int(st0.nst.sum()) == 0
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    for f, x in zip(ref[0]._fields, ref[0]):
        if isinstance(x, torch.Tensor):
            assert torch.equal(getattr(got[0], f), x), f
    if tol_form == "per-lane":
        # lanes with different tolerances take different steps
        assert len(set(ref[0].nst.tolist())) > 1
