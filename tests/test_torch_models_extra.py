"""The rest of the port's single-device surface against ``ida_tpu``: the
lorenz63 and slider-crank models, the stratified ensemble solve with its
pilot cost, the profiling scopes, what a sharded-N solve refuses and two of the
examples.

* slider-crank (N = 10, the AD Jacobian, ``suppressalg``): its consistent IC
  and residual bit for bit ``ida_tpu``'s op by op (``sin``/``cos``/``sqrt``
  go through the C library on the CPU, as XLA:CPU's do), its Jacobian to
  1e-13 (the two forward-mode rules for a quotient associate apart); the solve
  to 0.1 takes ``ida_tpu``'s op-by-op counts (20 steps, 38 residuals, 16
  Jacobians; measured once by hand, bit for bit the same state: a live
  op-by-op reference costs ~30 s) and keeps the position constraints.
* lorenz63 (chaotic: held only to t = 1): the counters of ``ida_tpu``'s
  jitted run exactly and the state to 1e-9, and a fine RK4 reference.
* The stratified solve bit for bit the plain one in every lane; the pilot
  cost ``ida_tpu``'s.
* ``utils.profiling``: the 17 ``ida.<name>`` scopes of ``ida_tpu`` on the same
  routines, visible in a ``torch.profiler`` trace; a profiler that cannot
  start warns and runs the block unprofiled.
"""

import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from ida_tpu.models.slider_crank import slider_crank_ic as jax_slider_ic
from ida_tpu_torch import IdaOptions
from ida_tpu_torch.core.state import init_state
from ida_tpu_torch.core.step import attempt_once
from ida_tpu_torch.models import (
    ROBERTS_PARAMS,
    ROBERTS_YY0,
    lorenz63_problem,
    roberts_factory,
    roberts_problem,
    slider_crank_ic,
    slider_crank_problem,
)
from ida_tpu_torch.parallel import ensemble_init, make_stratified_solve, sharded_solve, to_native
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils import profiling

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ATOL = [1e-8, 1e-6, 1e-6]


# ------------------------------------------------------------ slider-crank


def test_slider_crank_ic_is_ida_tpus():
    yy0, yp0 = slider_crank_ic()
    jyy0, jyp0 = jax_slider_ic()
    assert np.array_equal(yy0, jyy0) and np.array_equal(yp0, jyp0)


# ----------------------------------------------------------------- lorenz63


def _f(y):
    return np.array([10.0 * (y[1] - y[0]), y[0] * (28.0 - y[2]) - y[1],
                     y[0] * y[1] - 8.0 / 3.0 * y[2]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["lorenz63", "slider_crank"])
def test_models_keep_their_dtype(model, dtype):
    # tests/test_model_dtypes.py: res and jtimes keep float32 in float32 out
    # (a captured float64 constant would run "single" silently in float64),
    # one lane and batch-native
    prob = lorenz63_problem() if model == "lorenz63" else slider_crank_problem(device="cpu")
    n = prob.n
    for shape in ((n,), (n, 4)):
        yy = torch.ones(shape, dtype=dtype)
        yp = torch.zeros(shape, dtype=dtype)
        t = torch.zeros(shape[1:], dtype=dtype)
        cj = torch.ones(shape[1:], dtype=dtype)
        assert prob.res(t, yy, yp).dtype == dtype
        assert prob.jtimes(t, cj, yy, yp, torch.ones_like(yy)).dtype == dtype
        assert prob.sys_jacobian(t, cj, yy, yp, None).dtype == dtype


# ------------------------------------------------------ stratified solve


def _stratified_inputs(b=8):
    scale = np.logspace(-0.5, 0.5, b)
    scale = scale[np.random.default_rng(0).permutation(b)]  # unsorted costs
    params = np.outer(scale, ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (b, 1))
    yp0 = params[:, 0:1] * np.array([-1.0, 1.0, 0.0])
    return params, yy0, yp0


def test_stratified_solve_needs_divisible_batch():
    params, yy0, yp0 = _stratified_inputs(6)
    states = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu")
    fn = make_stratified_solve(roberts_factory, n_chunks=4)
    with pytest.raises(ValueError, match="divisible"):
        fn(states, params, tol_sv(1e-4, ATOL, device="cpu"), 0.4, torch.arange(6))


def test_mesh_is_refused_naming_its_roadmap_item():
    # the mesh is ported (tests/test_torch_mesh.py); what a solve on a state
    # sharded over N still refuses, here the dense path's [N, N] Jacobian,
    # names its ROADMAP item before it touches the mesh
    params, yy0, yp0 = _stratified_inputs(2)
    st = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        sharded_solve(to_native(st), roberts_factory(torch.as_tensor(params).t()), IdaOptions(),
                      tol_sv(1e-4, ATOL, device="cpu"), 0.4, mesh=None)


# --------------------------------------------------------------- profiling


_SCOPE = re.compile(r'@scope\("([a-z_.0-9]+)"\)')


def _scopes(pkg: str) -> list:
    return sorted(name for path in (ROOT / pkg).rglob("*.py")
                  for name in _SCOPE.findall(path.read_text()))


def test_scopes_sit_where_ida_tpus_do():
    assert _scopes("ida_tpu_torch") == _scopes("ida_tpu") and len(_scopes("ida_tpu")) == 17


def _one_attempt():
    prob = roberts_problem(with_roots=False, device="cpu")
    st = init_state(prob, ROBERTS_YY0, np.array([-0.04, 0.04, 0.0]), device="cpu")
    st = st._replace(hh=torch.tensor(1e-4, dtype=torch.float64),
                     ewt=torch.ones(3, dtype=torch.float64))
    z = torch.zeros((), dtype=torch.int32)
    return attempt_once(st, prob, IdaOptions(), st.tn, z, z)


def test_scopes_show_in_a_profiler_trace(tmp_path):
    # tests/test_utils.py::test_named_scopes_in_lowered_program, on a trace
    with profiling.profile(str(tmp_path / "trace")) as prof:
        _one_attempt()
    names = {e.key for e in prof.key_averages()}
    for expected in ("ida.step.attempt", "ida.set_coeffs", "ida.predict", "ida.nonlinear_solve",
                     "ida.lsetup", "ida.newton_iterate", "ida.error_test", "ida.restore"):
        assert expected in names, (expected, sorted(n for n in names if n.startswith("ida.")))
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"ida.nonlinear_solve"' in trace
    # no profiler recording: the same values, no record_function opened
    first = _one_attempt()
    profiling.ENABLED = False
    try:
        second = _one_attempt()
    finally:
        profiling.ENABLED = True
    assert all(torch.equal(a, b) for a, b in zip(first[0], second[0])
               if isinstance(a, torch.Tensor))


def test_profile_scope_degrades_to_noop(monkeypatch, tmp_path):
    # tests/test_utils.py::test_profile_scope_degrades_to_noop: a profiler
    # that cannot start warns, and the block still runs
    class Broken:
        def __init__(self, **kw):
            raise RuntimeError("no profiler on this backend")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    ran = []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with profiling.profile(str(tmp_path / "trace")) as prof:
            ran.append(True)
    assert ran == [True] and prof is None
    assert any("unprofiled" in str(x.message) for x in w)


# ----------------------------------------------------------------- examples
