"""``IdaOptions(fast_math=True)`` in the port against ``ida_tpu``
(tests/test_fast_math.py): phi stays unscaled and the phi -> phi-star scale
goes into its consumers, so the association changes and step sequences need
not be C IDA's.

* Against ``ida_tpu`` run op by op, the same association: every counter
  exactly and the states bit for bit (to 0.4; over all twelve decades the two
  take 375 steps, against ``ida_tpu`` jitted 362: XLA's FMA contraction).
* What the mode guarantees: check_ans over 12 decades, every decade within
  the integration tolerance of the parity mode, the failure path (no
  restore pass), dense output with events, a batch. ``ida_tpu``'s own test
  holds its jitted run to atol 1e-9 and event times to rtol 1e-6 because that
  run takes parity's 362 steps; its op-by-op run takes the port's 375 (the
  same bits), which part from parity's by 1.0e-8 in y1 at 4e8 (the solve's
  atol for y1 is 1e-8) and by 6e-4 in the event time near 2e7. So here the
  bound is rtol 1e-3 with the solve's own atol, and the late event rtol 1e-3.
* The whole-solve kernel refuses the mode (and the mixed-precision ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu as jida
import ida_tpu_torch as port
from ida_tpu.models import roberts_problem as jax_roberts
from ida_tpu_torch import IdaOptions, IdaProblem, IdaSolveStatus
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.coeffs import phi_star_scale
from ida_tpu_torch.core.solve import solve as tsolve
from ida_tpu_torch.models import ROBERTS_PARAMS, roberts_factory, roberts_problem
from ida_tpu_torch.parallel import ensemble_init, to_native
from ida_tpu_torch.tol_control import TolControl, tol_sv

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

Y0 = np.array([1.0, 0.0, 0.0])
YP0 = np.array([-0.04, 0.04, 0.0])
ATOL = [1e-8, 1e-6, 1e-6]
REF_T4E10 = np.array([5.2083474e-08, 2.0833391e-13, 9.9999995e-01])
COUNTERS = ("nst", "nre", "nje", "nni", "netf", "ncfn", "nsetups")
BOMB_THRESH = -0.5  # tests/test_res_failure.py


def _ida(fast, problem=None, with_roots=False):
    problem = problem or roberts_problem(with_roots=with_roots, device="cpu")
    return port.IDA(problem, Y0, YP0, tol_sv(1e-4, ATOL, device="cpu"),
                    IdaOptions(fast_math=fast), device="cpu")


def _jax_ida(fast, problem=None):
    return jida.IDA(problem or jax_roberts(with_roots=False), Y0, YP0,
                    jida.tol_sv(1e-4, jnp.asarray(ATOL)),
                    options=jida.IdaOptions(fast_math=fast))


def _wrms_vs_ref(y):
    w = 1.0 / (1e-4 * np.abs(REF_T4E10) + np.array(ATOL))
    return float(np.sqrt(np.mean(((np.asarray(y) - REF_T4E10) * w) ** 2)))


def _within(a, b, rtol: float, atol) -> bool:
    """|a - b| <= rtol |b| + atol elementwise (``atol`` per component)."""
    return bool(np.all(np.abs(np.asarray(a) - b) <= rtol * np.abs(b) + np.asarray(atol)))


def _counters(st) -> dict:
    return {k: np.asarray(getattr(st, k)).tolist() for k in COUNTERS}


def _same_fields(st, jst, fields=("yy", "yp", "phi", "psi", "beta", "hh", "ns")):
    for f in fields:
        got, want = getattr(st, f).numpy(), np.asarray(getattr(jst, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f


def test_phi_star_scale_is_the_parity_scaling():
    # the implicit scale times unscaled phi is the parity mode's phi-star
    ida = _ida(False)
    ida.solve(0.4)
    from ida_tpu_torch.core.coeffs import set_coeffs

    st = ida.state
    parity, _ = set_coeffs(st)
    fast, _ = set_coeffs(st, fast_math=True)
    assert torch.equal(fast.phi, st.phi) and torch.equal(fast.beta, parity.beta)
    assert torch.equal(fast.phi * phi_star_scale(fast).unsqueeze(1), parity.phi)


@pytest.fixture(scope="module")
def twelve_decades():
    """Per decade yy of the port's fast and parity runs and ida_tpu's jitted
    fast run."""
    runs = {"fast": _ida(True), "parity": _ida(False), "jax_fast": _jax_ida(True)}
    rows = {k: [] for k in runs}
    t = 0.4
    while t <= 4e10:
        for k, ida in runs.items():
            tret, status = ida.solve(t)
            assert status.name == "Success", (k, t)
            rows[k].append(np.asarray(ida.get_yy()).copy())
        t *= 10
    return runs, rows


def test_fast_math_roberts_12_decades_check_ans(twelve_decades):
    runs, rows = twelve_decades
    assert _wrms_vs_ref(rows["fast"][-1]) < 1.0
    assert runs["fast"].get_num_steps() == 375  # ida_tpu's op-by-op count


@pytest.mark.parametrize("other", ["parity", "jax_fast"])
def test_fast_math_tracks_parity_mode_per_decade(twelve_decades, other):
    # both are valid rtol = 1e-4 solutions on their own step sequences
    # (module doc): within rtol 1e-3 and the solve's atol, every decade
    _, rows = twelve_decades
    for k, (yf, yo) in enumerate(zip(rows["fast"], rows[other])):
        assert _within(yf, yo, 1e-3, ATOL), (k, yf, yo)
    # through decade 7 both take the canonical steps, and agree far closer
    for k in range(7):
        np.testing.assert_allclose(rows["fast"][k], rows[other][k], rtol=1e-6, atol=1e-12)


def _bombed_roberts_port():
    """tests/test_res_failure.py::_bombed_roberts: the residual is NaN where
    y < -0.5, which an hin = 100 first step reaches."""

    def res(t, yy, yp):
        r0 = -0.04 * yy[0] + 1.0e4 * yy[1] * yy[2]
        r1 = -r0 - 3.0e7 * yy[1] ** 2 - yp[1]
        r = torch.stack([r0 - yp[0], r1, yy[0] + yy[1] + yy[2] - 1.0])
        bomb = (yy < BOMB_THRESH).any(dim=0)
        return torch.where(bomb, torch.full_like(r, float("nan")), r)

    def jac(t, cj, yy, yp, rr):
        one = torch.ones_like(yy[0])
        return torch.stack([
            torch.stack([-0.04 - cj * one, 1.0e4 * yy[2], 1.0e4 * yy[1]]),
            torch.stack([0.04 * one, -1.0e4 * yy[2] - 6.0e7 * yy[1] - cj, -1.0e4 * yy[1]]),
            torch.stack([one, one, one]),
        ])

    return IdaProblem(n=3, res=res, jac=jac)


def test_fast_math_failure_paths_recover():
    # the restore-free failure path: residual failures at hin = 100 (h/4
    # retries) recover and land on the plain trajectory; bit for bit
    # ida_tpu's op-by-op run of the same problem
    from tests.test_res_failure import _bombed_roberts

    ida = _ida(True, _bombed_roberts_port())
    ida.set_initial_step(100.0)
    tret, status = ida.solve(0.4)
    assert status == IdaSolveStatus.Success
    assert ida.get_num_nonlin_solv_conv_fails() >= 1
    jax_ida = _jax_ida(True, _bombed_roberts())
    jax_ida.set_initial_step(100.0)
    with jax.disable_jit():
        jax_ida.solve(0.4)
    assert _counters(ida.state) == _counters(jax_ida.state)
    _same_fields(ida.state, jax_ida.state, ("yy", "phi"))
    plain = _ida(False)
    plain.solve(0.4)
    np.testing.assert_allclose(ida.get_yy(), plain.get_yy(), rtol=1e-3)


def test_fast_math_dense_output_and_events():
    # the dense sweep and its event buffer: both Roberts events, the first
    # (before the step sequences part) within the root finder's tolerance
    # of the parity sweep's, the second within the integration tolerance
    # (module doc). interp and the root search read phi only after
    # complete_step, which writes true phi rows
    grid = 0.4 * 10.0 ** np.arange(12)
    out = {}
    for fast in (True, False):
        ida = _ida(fast, with_roots=True)
        *rows, ev = ida.solve_grid(grid, max_events=4)
        out[fast] = (rows, ev)
    assert int(out[True][1].count) == int(out[False][1].count) == 2
    t_fast, t_parity = np.asarray(out[True][1].t[:2]), np.asarray(out[False][1].t[:2])
    np.testing.assert_allclose(t_fast[0], t_parity[0], rtol=1e-6)
    np.testing.assert_allclose(t_fast[1], t_parity[1], rtol=1e-3)
    assert _within(out[True][0][2][-1], out[False][0][2][-1], 1e-3, ATOL)


def test_fast_math_batched():
    # B = 64 batch-native: every lane SUCCESS and within tolerance of its
    # parity-mode twin
    b = 64
    params = np.outer(np.exp(np.linspace(-0.1, 0.1, b)), ROBERTS_PARAMS)
    yy0 = np.tile(Y0, (b, 1))
    yp0 = params[:, 0:1] * np.array([-1.0, 1.0, 0.0])
    tol = TolControl(torch.full((b,), 1e-4, dtype=torch.float64),
                     torch.tensor(ATOL, dtype=torch.float64)[:, None].expand(3, b))
    prob = roberts_factory(torch.from_numpy(params.T.copy()))
    outs = {}
    for fm in (False, True):
        opts = IdaOptions(fast_math=fm)
        st = to_native(ensemble_init(roberts_factory, params, yy0, yp0, device="cpu", opts=opts))
        st, tret, ist = tsolve(st, prob, opts, tol, 4000.0)
        assert ist.tolist() == [C.SUCCESS] * b
        outs[fm] = st.yy.numpy()
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-3, atol=1e-10)
