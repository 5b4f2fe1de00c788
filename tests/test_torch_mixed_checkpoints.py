"""The mixed-precision modes round-tripping through checkpoints both ways,
differentiating in reverse and forward mode, the band factor's single
lsetup and lsolve op by op, and refined tracking full over the early
decades (split from tests/test_torch_mixed_precision.py, whose helpers they
share).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.models.heat2d import heat2d_problem as jax_heat2d
from ida_tpu.utils import checkpoint as jax_ck
from ida_tpu_torch import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, heat2d_problem, roberts_factory
from ida_tpu_torch.sensitivity import forward_sensitivity, solve_with_params
from ida_tpu_torch.tol_control import tol_sv
from ida_tpu_torch.utils import checkpoint as ck
from ida_tpu_torch.utils.convert import state_fields
from make_torch_refs import load
from test_torch_mixed_precision import (
    ATOL,
    CANONICAL_NST,
    FWD_REF_INPUTS,
    FWD_V,
    HEAT_M,
    _adjoint,
    _decades,
    _jax_ida,
    _port_ida,
)

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_refined_tracks_full_mode_early_decades():
    # through t = 4e3 (decade 7) one refinement step gives the "full" mode's
    # step decisions exactly (ida_tpu's test_refined_tracks_full_mode_...)
    full = _decades(_port_ida("full"), 7)
    assert _decades(_port_ida("refined"), 7) == full == CANONICAL_NST[:7]


def test_band_single_lsetup_and_lsolve_are_ida_tpus_op_by_op():
    # the band "single" lsetup and lsolve on a heat2d state: the float32
    # band Jacobian, factor and solve, bit for bit ida_tpu's (the solve op by
    # op; jitted, its multiply-adds are contracted). (A
    # whole solve op by op costs ~40 s; jitted, FMA contraction in the
    # float32 factor moves ida_tpu's run: 81 steps against 66 op by op, as
    # here, checked once by hand.)
    from ida_tpu.ops import banded as jb
    from ida_tpu_torch.ops import banded as tb

    rng = np.random.default_rng(4)
    n = HEAT_M * HEAT_M
    yy = rng.normal(size=n) * 0.1
    yp = rng.normal(size=n)
    b = rng.normal(size=n)
    f32 = np.float32

    @jax.jit
    def setup(yy, yp):  # no multiply-add to contract here: jitted is op by op
        ab = jb.band_sys_jacobian(jax_heat2d(HEAT_M), jnp.asarray(0.0, f32),
                                  jnp.asarray(50.0, f32), yy, yp, HEAT_M, HEAT_M).astype(f32)
        return ab, jb.band_factor(ab, HEAT_M, HEAT_M)

    jab, jf = setup(jnp.asarray(yy, f32), jnp.asarray(yp, f32))
    with jax.disable_jit():
        jx = jb.band_solve(jf, jnp.asarray(b, f32))
    t32 = torch.float32
    ab = tb.band_sys_jacobian(heat2d_problem(HEAT_M, device="cpu"), torch.tensor(0.0, dtype=t32),
                              torch.tensor(50.0, dtype=t32), torch.from_numpy(yy).to(t32),
                              torch.from_numpy(yp).to(t32), HEAT_M, HEAT_M).to(t32)
    f = tb.band_factor(ab, HEAT_M, HEAT_M)
    x = tb.band_solve(f, torch.from_numpy(b).to(t32))
    for got, want in ((ab, jab), (f.lu, jf.lu), (f.piv, jf.piv), (x, jx)):
        assert got.dtype == torch.float32 or got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["single", "refined"])
def test_mode_checkpoints_round_trip_both_ways(tmp_path, mode):
    # the float32 lu and the refined point [N] load into ida_tpu as they
    # are, and an ida_tpu archive of the mode loads into the port
    mine = _port_ida(mode)
    mine.solve(0.4)
    path = str(tmp_path / "port.npz")
    ck.save_state(path, mine.state)
    jst = jax_ck.load_state(path)
    for f, x in state_fields(jst).items():
        if f != "pdata":
            got = getattr(mine.state, f).numpy()
            assert got.dtype == x.dtype and np.array_equal(got, x), f
    assert np.asarray(jst.lu).dtype == np.float32
    jax_ida = _jax_ida(mode)
    jax_ida.solve(0.4)
    jpath = str(tmp_path / "jax.npz")
    jax_ck.save_state(jpath, jax_ida.state)
    st = ck.load_state(jpath, device="cpu")
    assert st.lu.dtype == torch.float32 and tuple(st.ls_yy.shape) == np.asarray(
        jax_ida.state.ls_yy).shape
    resumed = _port_ida(mode)
    resumed.state = ck.load_state(path, device="cpu")
    resumed.solve(4.0)
    mine.solve(4.0)
    assert torch.equal(resumed.state.yy, mine.state.yy)


def test_modes_differentiate_in_reverse_and_forward():
    # the casts and the float32 LU Functions keep the graph: the gradient
    # through "single" and "refined" is the "full" one to the float32
    # solves' accuracy; in forward mode the refinement's J v comes from the
    # vmapped vjps (core/nls.py _res_jvp), and the tangent is ida_tpu's
    # (pinned: jax_forward_refined_live) and the central differences'
    _, g_full, ist = _adjoint("full")
    assert int(ist) == 0
    for mode in ("single", "refined"):
        _, g, ist = _adjoint(mode)
        assert int(ist) == 0 and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), g_full.numpy(), rtol=1e-3)
    yy0_of = lambda p: torch.tensor(ROBERTS_YY0)  # noqa: E731
    yp0_of = lambda p: p[0] * torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float64)  # noqa: E731
    tol, opts = tol_sv(1e-4, ATOL, device="cpu"), IdaOptions(ls_precision="refined")
    y, dy = forward_sensitivity(roberts_factory, ROBERTS_PARAMS, yy0_of, yp0_of, tol, 0.4, FWD_V,
                                opts, device="cpu")
    ref = load("mixed_forward_refined_jax", FWD_REF_INPUTS)
    np.testing.assert_allclose(y.numpy(), ref["y"], rtol=1e-10)
    np.testing.assert_allclose(dy.numpy(), ref["dy"], rtol=1e-6)
    f = solve_with_params(roberts_factory, None, yy0_of, yp0_of, tol, 0.4, opts)
    p0, eps = torch.tensor(ROBERTS_PARAMS), 1e-7
    fd = (f(p0 + eps * torch.tensor(FWD_V)) - f(p0 - eps * torch.tensor(FWD_V))) / (2 * eps)
    np.testing.assert_allclose(dy.numpy(), fd.numpy(), rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), f(p0).numpy(), rtol=1e-12)
