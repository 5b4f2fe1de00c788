"""Quadratures along the solution (``core/quad.py``) against ``ida_tpu``: a
conserved integrand exact and bit for bit, the augmented system's integral,
``get_quad`` op by op and its window, and a batch whose steps the
quadratures leave alone (split from tests/test_torch_quad_checkpoint.py,
whose helpers they share).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core.quad import get_quad as jax_get_quad
import ida_tpu_torch as port
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.quad import get_quad
from ida_tpu_torch.core.solve import solve as core_solve
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory, roberts_problem
from ida_tpu_torch.parallel import ensemble_init, to_native
from ida_tpu_torch.tol_control import TolControl, tol_sv
from ida_tpu_torch.utils.convert import state_fields, state_from_numpy
from test_torch_quad_checkpoint import ATOL, RTOL, TOUTS, YP0, _port_quad_ida, _quad_factory
from test_torch_quad_checkpoint import jax_quads

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_conserved_quadrature_is_exact_and_ida_tpus(jax_quads):
    # q = y1 + y2 + y3 == 1 along the trajectory, so its integral is tret to
    # roundoff; [y1, y3] beside it as ida_tpu integrates them
    rows, _, _ = jax_quads
    ida = _port_quad_ida(lambda t, yy, yp: torch.stack([yy[0] + yy[1] + yy[2], yy[0], yy[2]]), 3)
    for tout, (jt, jq, jnst, jnre) in zip(TOUTS, rows):
        tret, _ = ida.solve(tout)
        q = ida.get_quad()
        assert q.shape == (3,)
        assert abs(q[0] - tret) < 1e-9 * max(1.0, tout), (tout, q, tret)
        assert (tret, ida.get_num_steps(), ida.get_num_res_evals()) == (jt, jnst, jnre)
        np.testing.assert_allclose(q, jq, rtol=1e-9)
    # the raw accumulator runs to the internal time tn >= tret
    assert float(ida.state.yQ[0]) >= tret - 1e-9


def test_get_quad_is_ida_tpus_op_by_op(jax_quads):
    # on one state (ida_tpu's after 40, carried over field by field), the
    # port's get_quad at tret and inside the last step, bit for bit ida_tpu's
    # run op by op
    _, jstate, jprob = jax_quads
    st = state_from_numpy(state_fields(jstate), device="cpu", batch="trailing")
    prob = dataclasses.replace(
        roberts_factory(torch.from_numpy(ROBERTS_PARAMS)),
        quad=lambda t, yy, yp: torch.stack([yy[0] + yy[1] + yy[2], yy[0], yy[2]]), nquad=3)
    for t in (float(jstate.tretlast), float(jstate.tn) - 0.3 * float(jstate.hused)):
        with jax.disable_jit():
            want = np.asarray(jax_get_quad(jstate, jprob, jnp.asarray(t)))
        got = get_quad(st, prob, torch.tensor(t, dtype=torch.float64)).numpy()
        assert np.array_equal(got, want), t


def test_quadrature_matches_augmented_system():
    # int y1 dt and int y3 dt against two extra differential variables of an
    # augmented DAE, w' = y1 and w' = y3 (tests/test_quadrature.py)
    p = torch.from_numpy(ROBERTS_PARAMS)
    ida = _port_quad_ida(lambda t, yy, yp: torch.stack([yy[0], yy[2]]), 2)
    ida.solve(400.0)
    q = ida.get_quad()

    def res_aug(t, yy, yp):
        r = roberts_factory(p).res(t, yy[:3], yp[:3])
        return torch.cat([r, torch.stack([yp[3] - yy[0], yp[4] - yy[2]])])

    prob_aug = port.IdaProblem(n=5, res=res_aug,
                               id=torch.tensor([True, True, False, True, True]))
    ida2 = port.IDA(prob_aug, np.concatenate([ROBERTS_YY0, np.zeros(2)]),
                    np.concatenate([YP0, [1.0, 0.0]]),
                    tol_sv(RTOL, ATOL + [1e-8, 1e-8], device="cpu"), device="cpu")
    ida2.solve(400.0)
    w = ida2.get_yy()[3:]
    for i in range(2):
        assert abs(q[i] - w[i]) / max(abs(w[i]), 1e-12) < 1e-5, (i, q[i], w[i])


def test_quadrature_batched_leaves_the_steps_alone():
    # four lanes, per-lane tolerances, batch-native core.solve: get_quad at
    # tret is tret in every lane, and every field but yQ is the quadrature-
    # free solve's, bit for bit
    params = np.stack([ROBERTS_PARAMS] * 4) * np.array([1.0, 1.1, 0.9, 1.05])[:, None]
    yy0 = np.tile(ROBERTS_YY0, (4, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    p = torch.from_numpy(params.T).contiguous()
    tol = TolControl(torch.full((4,), RTOL, dtype=torch.float64),
                     torch.tensor(ATOL, dtype=torch.float64).reshape(3, 1).expand(3, 4))
    out = {}
    for name, factory in (("quad", _quad_factory), ("plain", roberts_factory)):
        st = to_native(ensemble_init(factory, params, yy0, yp0, device="cpu"))
        out[name] = core_solve(st, factory(p), port.IdaOptions(), tol, 4.0)
    st, tret, istate = out["quad"]
    assert bool((istate == C.SUCCESS).all()) and tuple(st.yQ.shape) == (1, 4)
    np.testing.assert_allclose(get_quad(st, _quad_factory(p), tret)[0].numpy(), tret.numpy(),
                               rtol=1e-9)
    ref = out["plain"][0]
    differ = [f for f in st._fields if f != "yQ" and isinstance(getattr(st, f), torch.Tensor)
              and not torch.equal(getattr(st, f), getattr(ref, f))]
    assert differ == [] and torch.equal(tret, out["plain"][1])


def test_get_quad_rejects_out_of_window_t():
    ida = _port_quad_ida()
    ida.solve(400.0)
    with pytest.raises(port.IdaError) as ei:
        ida.get_quad(t=10.0)  # far outside [tn - hused, tn]
    assert ei.value.name == "BAD_T"
    with pytest.raises(ValueError, match="no quadratures"):
        port.IDA(roberts_problem(with_roots=False, device="cpu"), ROBERTS_YY0, YP0,
                 tol_sv(RTOL, ATOL, device="cpu"), device="cpu").get_quad()
