"""The extra models and the examples, run: Lorenz '63 against ``ida_tpu`` and
RK4 and through ``tstop`` and one-step returns, slider-crank's residual and
Jacobian against ``ida_tpu``'s and its solve, the stratified solve bit for bit
the plain one, and two examples on the CPU (split from
tests/test_torch_models_extra.py, whose helpers they share).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu as jida
import ida_tpu_torch as port
from ida_tpu.models.lorenz63 import lorenz63_problem as jax_lorenz
from ida_tpu.models.slider_crank import slider_crank_problem as jax_slider
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.parallel.batch import pilot_cost as jax_pilot_cost
from ida_tpu_torch import IdaOptions, IdaSolveStatus
from ida_tpu_torch.models import (
    lorenz63_problem,
    roberts_factory,
    slider_crank_ic,
    slider_crank_problem,
)
from ida_tpu_torch.parallel import (
    ensemble_init,
    make_ensemble_solve,
    make_stratified_solve,
    pilot_cost,
)
from ida_tpu_torch.tol_control import tol_ss, tol_sv
from test_torch_models_extra import ATOL, ROOT, _f, _stratified_inputs

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_slider_crank_residual_and_jacobian_are_ida_tpus():
    # at perturbed states, batch-native (4 lanes), op by op: the residual
    # and J = dF/dy + cj dF/dy' (ida_tpu's jacfwd, the port's vmapped jvp)
    rng = np.random.default_rng(7)
    yy0, yp0 = slider_crank_ic()
    yy = yy0[:, None] + 0.05 * rng.normal(size=(10, 4))
    yp = yp0[:, None] + 0.05 * rng.normal(size=(10, 4))
    cj = np.array([1.0, 10.0, 100.0, 1000.0])
    jprob = jax_slider()
    with jax.disable_jit():
        jr = jprob.res(0.0, jnp.asarray(yy), jnp.asarray(yp))
        # ida_tpu's core vmaps a Jacobian over the lanes: one lane a call
        jj = np.stack([np.asarray(jprob.sys_jacobian(
            jnp.asarray(0.0), jnp.asarray(cj[k]), jnp.asarray(yy[:, k]), jnp.asarray(yp[:, k]),
            None)) for k in range(4)], axis=-1)
    prob = slider_crank_problem(device="cpu")
    t = torch.zeros(4, dtype=torch.float64)
    r = prob.res(t, torch.from_numpy(yy), torch.from_numpy(yp))
    j = prob.sys_jacobian(t, torch.from_numpy(cj), torch.from_numpy(yy), torch.from_numpy(yp), None)
    assert np.array_equal(r.numpy(), np.asarray(jr))
    # the Jacobian to 1e-13: torch's forward-mode rule for x / y associates
    # as t / y - t_y (x / y) / y, jax's as t / y + (-t_y x) y^-2 (14 of its
    # 400 entries differ in the last bits; the solve below still ends bit
    # for bit where ida_tpu's does)
    assert j.shape == (10, 10, 4)
    np.testing.assert_allclose(j.numpy(), jj, rtol=1e-13, atol=1e-15)


def test_slider_crank_solve():
    # tests/test_observability.py::test_slider_crank, with ida_tpu's
    # op-by-op counters (module doc)
    a = 0.5
    yy0, yp0 = slider_crank_ic(a)
    ida = port.IDA(slider_crank_problem(device="cpu"), yy0, yp0, tol_ss(1e-6, 1e-6, device="cpu"),
                   IdaOptions(mxstep=50000, suppressalg=True), device="cpu")
    tret, status = ida.solve(0.1)
    assert status == IdaSolveStatus.Success
    assert (ida.get_num_steps(), ida.get_num_res_evals(), ida.get_num_jac_evals()) == (20, 38, 16)
    y = ida.get_yy()
    np.testing.assert_allclose(y[1], np.cos(y[2]) + a * np.cos(y[0]), atol=1e-8)
    np.testing.assert_allclose(-np.sin(y[2]) - a * np.sin(y[0]), 0.0, atol=1e-8)
    assert abs(y[0] - yy0[0]) > 1e-4


def test_lorenz63_matches_ida_tpu_and_rk4():
    y0 = np.array([1.0, 1.0, 1.0])
    yp0 = np.array([0.0, 26.0, 1.0 - 8.0 / 3.0])
    jax_ida = jida.IDA(jax_lorenz(), y0, yp0, jida.tol_ss(1e-6, 1e-8),
                       options=jida.IdaOptions(mxstep=20000))
    ida = port.IDA(lorenz63_problem(), y0, yp0, tol_ss(1e-6, 1e-8, device="cpu"),
                   IdaOptions(mxstep=20000), device="cpu")
    t_end = 1.0
    assert jax_ida.solve(t_end)[1] == jida.IdaSolveStatus.Success
    assert ida.solve(t_end)[1] == IdaSolveStatus.Success
    for k in ("steps", "res_evals", "nonlin_solv_iters", "err_test_fails", "jac_evals"):
        assert getattr(ida, "get_num_" + k)() == getattr(jax_ida, "get_num_" + k)(), k
    np.testing.assert_allclose(ida.get_yy(), np.asarray(jax_ida.get_yy()), rtol=1e-9)
    # a fine RK4 reference (tests/test_observability.py::test_lorenz63)
    y, h = y0.copy(), 2e-5
    for _ in range(int(t_end / h)):
        k1 = _f(y)
        k2 = _f(y + 0.5 * h * k1)
        k3 = _f(y + 0.5 * h * k2)
        k4 = _f(y + h * k3)
        y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    np.testing.assert_allclose(ida.get_yy(), y, rtol=2e-4)


def test_lorenz63_tstop_and_onestep():
    ida = port.IDA(lorenz63_problem(), np.ones(3), np.array([0.0, 26.0, 1.0 - 8.0 / 3.0]),
                   tol_ss(1e-6, 1e-8, device="cpu"), IdaOptions(mxstep=20000), device="cpu")
    ida.set_stop_time(0.5)
    status = None
    for _ in range(100000):
        tret, status = ida.solve(10.0, itask=port.IdaTask.OneStep)
        if status == IdaSolveStatus.TStop:
            break
    assert status == IdaSolveStatus.TStop and tret == 0.5


def test_stratified_solve_matches_plain():
    # tests/test_batch_extra.py::test_stratified_solve_matches_plain: the
    # lanes come back in their order, each bit for bit the plain ensemble's;
    # the pilot cost is ida_tpu's (its jitted counters are exact here)
    params, yy0, yp0 = _stratified_inputs()
    tol = tol_sv(1e-4, ATOL, device="cpu")
    states = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu")
    key = pilot_cost(roberts_factory, states, params, tol, 0.4)
    jst = jensemble_init(jida.models.roberts_factory, jnp.asarray(params), jnp.asarray(yy0),
                         jnp.asarray(yp0))
    jkey = jax_pilot_cost(jida.models.roberts_factory, jst, jnp.asarray(params),
                          jida.tol_sv(1e-4, jnp.asarray(ATOL)), 0.4)
    assert key.tolist() == np.asarray(jkey).tolist() and int(key.min()) > 0
    assert int(states.nst.max()) == 0  # pilot_cost solved a copy

    st_s, tret_s, ist_s = make_stratified_solve(roberts_factory, n_chunks=2)(
        states, params, tol, 400.0, key)
    st_p, tret_p, ist_p = make_ensemble_solve(roberts_factory)(states, params, tol, 400.0)
    assert torch.equal(ist_s, ist_p) and torch.equal(tret_s, tret_p)
    for f in st_p._fields:
        a, b = getattr(st_s, f), getattr(st_p, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f


@pytest.mark.parametrize("example,args,last", [
    ("bounce_torch.py", [], "PASS"),
    ("slider_crank_torch.py", ["--tend", "1.0"], "last order / step"),
], ids=["bounce", "slider_crank"])
def test_example_runs_on_the_cpu(example, args, last):
    proc = subprocess.run([sys.executable, f"examples/{example}", "--device", "cpu", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    assert last in proc.stdout.strip().splitlines()[-1]
