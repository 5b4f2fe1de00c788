"""Inequality constraints through whole solves: the host build bit for bit the
eager solve with mixed constraint codes and with the probe's, the probe
taking ``ida_tpu``'s steps and keeping y >= 0, lanes without constraints
untouched, and ``enable_constraints=False`` bit-identical (split from
tests/test_torch_constraints.py, whose helpers they share).
"""

import numpy as np
import pytest
import torch

import ida_tpu_torch as port
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.parallel import ensemble_init, make_ensemble_solve
from ida_tpu_torch.tol_control import tol_sv
from test_torch_fused_host import _kernel_solve, _differ, host_lib, on_host
from test_torch_constraints import (
    ATOL,
    DECADES,
    PROBE,
    RTOL,
    _counters,
    _decades,
    _mixed_batch,
    _port_ida,
)
from test_torch_constraints import jax_probe

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_probe_takes_ida_tpus_steps_and_keeps_y_nonnegative(jax_probe):
    jax_rows, jax_counts = jax_probe
    ida = _port_ida()
    rows = _decades(ida)
    assert {k: jax_counts[k] for k in PROBE} == PROBE
    assert _counters(ida) == jax_counts
    assert (rows >= 0.0).all() and (jax_rows >= 0.0).all()
    w = 1.0 / (RTOL * np.abs(jax_rows) + np.array(ATOL))
    assert np.abs((rows - jax_rows) * w).max() < 1e-8


def test_constraints_nonnegative():
    # tests/test_calc_ic.py::test_constraints_nonnegative on the port: every
    # output y >= 0 at the canonical tolerances
    ida = _port_ida(yp0=np.array([-0.04, 0.04, 0.0]), rtol=1e-4, atol=[1e-8, 1e-6, 1e-6])
    for tout in DECADES:
        tret, status = ida.solve(tout)
        assert status == port.IdaSolveStatus.Success
        assert np.all(ida.get_yy() >= 0.0), (tret, ida.get_yy())


def test_enable_constraints_false_is_bit_identical():
    # tests/test_options.py: without constraints set, the solver without the
    # block gives every field of the state the default one gives
    on = _port_ida(constraints=False, rtol=1e-4, atol=[1e-8, 1e-6, 1e-6])
    off = _port_ida(constraints=False, rtol=1e-4, atol=[1e-8, 1e-6, 1e-6],
                    options=IdaOptions(enable_constraints=False))
    assert on.solve(400.0) == off.solve(400.0)
    assert _differ(on.state, off.state) == []
    assert on.get_num_steps() > 0


def test_lanes_without_constraints_are_untouched_by_the_block():
    # the block runs (some lanes have constraints set) and is an identity on
    # the lanes without: they equal the same lanes solved with no constraint
    # set anywhere, in every field
    params, st = _mixed_batch()
    tol = tol_sv(RTOL, ATOL, device="cpu")
    fn = make_ensemble_solve(roberts_factory)
    got, _, ist = fn(st, params, tol, 400.0)
    free = st._replace(constraints_set=torch.zeros_like(st.constraints_set))
    ref, _, _ = fn(free, params, tol, 400.0)
    lanes = ~st.constraints_set
    for f, x in zip(got._fields, got):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x[lanes], getattr(ref, f)[lanes]), f
    assert bool((ist[lanes] == C.SUCCESS).all()) and int(ist[4]) < 0  # lane 4: [-1, 0, 0]
    assert bool((got.yy[st.constraints_set & (ist == C.SUCCESS)].amin() >= 0.0))


def test_host_build_gives_the_probe(on_host):
    params = ROBERTS_PARAMS[None]
    st = ensemble_init(roberts_factory, params, ROBERTS_YY0[None], ROBERTS_YP0[None], device="cpu")
    st = st._replace(constraints=torch.ones_like(st.constraints),
                     constraints_set=torch.ones_like(st.constraints_set))
    tol = tol_sv(RTOL, ATOL, device="cpu")
    eager = st
    for tout in DECADES:
        st, tret, istate = _kernel_solve(st, params, tout, IdaOptions(), tol=tol)
        eager, etret, eistate = make_ensemble_solve(roberts_factory)(eager, params, tol, tout)
        assert _differ(st, eager) == [], tout
        assert torch.equal(tret, etret) and torch.equal(istate, eistate)
        assert int(istate[0]) == C.SUCCESS and bool((st.yy >= 0.0).all())
    assert int(st.nst[0]) == PROBE["nst"] and int(st.nre[0]) == PROBE["nre"]


@pytest.mark.parametrize("budget", [None, 3], ids=["unbudgeted", "budget3"])
def test_host_build_is_bitwise_the_eager_solve_with_mixed_constraints(on_host, budget):
    params, st0 = _mixed_batch()
    tol = tol_sv(RTOL, ATOL, device="cpu")
    st_e = st_k = st0
    codes = set()
    for tout in (4.0, 4.0e4):
        ref = make_ensemble_solve(roberts_factory)(st_e, params, tol, tout)
        got = _kernel_solve(st_k, params, tout, IdaOptions(), budget=budget, tol=tol)
        assert _differ(got[0], ref[0]) == [], tout
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        codes |= set(ref[2].tolist())
        st_e, st_k = ref[0], got[0]
    assert C.CONSTR_FAIL in codes
    # the kernel copies the constraint fields into its new state
    assert torch.equal(st_k.constraints, st0.constraints)
    assert torch.equal(st_k.constraints_set, st0.constraints_set)
