"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU, since a CUDA kernel has no CPU mode).

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors: following the plain version's order of operations with one rounding
per operation (``-fmad=false`` for the LU kernels, the never-contracted
intrinsics of ``csrc/rounded.cuh`` for the whole-solve kernel), it must agree
bit for bit. For the whole-solve kernel
(``ops.fused_solve``) the plain version is the eager ensemble solve, and
for each stage kernel (``ops.fused_stages``) the eager stage.
"""

import numpy as np
import pytest
import torch

from ida_tpu_torch import constants as C
from ida_tpu_torch.core.solve import TASK_ONE_STEP
from ida_tpu_torch.core.solve import solve as core_solve
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.ops import dense_lu, fused_solve, fused_stages, small_lu
from ida_tpu_torch.parallel import ensemble_init, from_native, make_ensemble_solve, to_native
from ida_tpu_torch.tol_control import TolControl, tol_sv

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _system(n, dtype, device, bsz=4096, seed=0):
    rng = np.random.default_rng(seed + n)
    a = rng.normal(size=(n, n, bsz)) + 3.0 * np.eye(n)[:, :, None]
    b = rng.normal(size=(n, bsz))
    return torch.from_numpy(a).to(device, dtype), torch.from_numpy(b).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 16])
def test_kernel_matches_plain_bitwise(cuda, n, dtype):
    a, b = _system(n, dtype, cuda)
    f, g = small_lu.lu_factor(a), dense_lu.lu_factor_unrolled(a)
    x, y = small_lu.lu_solve(f, b), dense_lu.lu_solve_unrolled(g, b)
    torch.cuda.synchronize()
    assert torch.equal(f.lu, g.lu) and torch.equal(f.piv, g.piv)
    assert torch.equal(f.fail_col, g.fail_col) and torch.equal(x, y)


def test_kernel_reports_singular_columns(cuda):
    a = torch.zeros((3, 3, 4), dtype=torch.float64)
    a[0, 0, 0] = 1.0
    a[:, 1:, 1] = 1.0
    a[:, :, 2] = 2.0 * torch.eye(3, dtype=torch.float64)
    a[:, :, 3] = torch.eye(3, dtype=torch.float64)
    a[2, 2, 3] = 0.0
    f = small_lu.lu_factor(a.to(cuda))
    assert f.fail_col.cpu().tolist() == [2, 1, 0, 3]
    assert torch.equal(f.fail_col.cpu(), dense_lu.lu_factor_unrolled(a).fail_col)


def test_wrappers_count_only_kernel_launches(cuda):
    a, b = _system(3, torch.float64, cuda)
    small_lu.reset_launch_counts()
    f = small_lu.lu_factor(a)
    small_lu.lu_solve(f, b)
    small_lu.lu_solve(f, b)
    dense_lu.lu_solve_unrolled(f, b)
    assert (small_lu.FACTOR_LAUNCHES, small_lu.SOLVE_LAUNCHES) == (1, 2)


def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    a, b = _system(3, torch.float64, cuda)
    with pytest.raises(TypeError):
        small_lu.lu_factor(a.to(torch.float16))
    with pytest.raises(ValueError):
        small_lu.lu_factor(torch.zeros((17, 17, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        small_lu.lu_factor(a.transpose(0, 1))
    f = small_lu.lu_factor(a)
    with pytest.raises(TypeError):
        small_lu.lu_solve(f._replace(piv=f.piv.long()), b)
    with pytest.raises(ValueError):
        small_lu.lu_solve(f, b[:, :100].contiguous())
    # above N = 16 the solver's dispatch takes the looped LU by size, on the
    # card too, and launches no kernel
    big = torch.from_numpy(np.random.default_rng(20).normal(size=(20, 20, 8))).to(cuda)
    small_lu.reset_launch_counts()
    g = dense_lu.lu_factor_auto(big)
    assert torch.equal(g.lu, dense_lu.lu_factor(big).lu) and small_lu.FACTOR_LAUNCHES == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 6, 13, 16])
def test_transposed_solve_kernel_matches_plain_bitwise(cuda, n, dtype):
    """``small_lu_solve_t`` (A^T lam = g from K1's factors) against
    ``dense_lu.lu_solve_unrolled_t`` on the same CUDA tensors."""
    a, g = _system(n, dtype, cuda, seed=7)
    f = small_lu.lu_factor(a)
    small_lu.reset_launch_counts()
    lam = small_lu.lu_solve_t(f, g)
    torch.cuda.synchronize()
    assert small_lu.SOLVE_T_LAUNCHES == 1
    assert torch.equal(lam, dense_lu.lu_solve_unrolled_t(f, g))
    if dtype == torch.float64:
        lead = a.permute(2, 0, 1).transpose(1, 2)
        want = torch.linalg.solve(lead, g.t().unsqueeze(-1)).squeeze(-1).t()
        assert torch.allclose(lam, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["contiguous", "pdata", "factor_view"])
@pytest.mark.parametrize("kernel", ["solve", "solve_t"])
def test_solve_kernels_bitwise_on_each_layout(cuda, kernel, layout, dtype):
    """The solve and the transposed solve read each layout by strides
    (``tests/test_torch_lu_layouts.py::operands``: batch-last contiguous,
    ``ida_tpu``'s pdata, the factor's own views as ``foodweb.prec_solve``
    hands them) at N = 1..16 and B = 1 (one lane), 129 (lane by lane, a
    block not filled) and 200 (pairs of lanes), one launch each, bit for
    bit their plain versions, the result in the right-hand side's layout."""
    from test_torch_lu_layouts import operands

    launch = small_lu.lu_solve if kernel == "solve" else small_lu.lu_solve_t
    plain = dense_lu.lu_solve_unrolled if kernel == "solve" else dense_lu.lu_solve_unrolled_t
    for n in range(1, 17):
        for bsz in (1, 129, 200):
            f, b = operands(layout, n, bsz, dtype)
            f = dense_lu.DenseLU(f.lu.to(cuda), f.piv.to(cuda), None)
            b = b.to(cuda)
            small_lu.reset_launch_counts()
            x = launch(f, b)
            torch.cuda.synchronize()
            assert small_lu.SOLVE_LAUNCHES + small_lu.SOLVE_T_LAUNCHES == 1
            assert x.stride() == b.stride()
            assert torch.equal(x, plain(f, b)), (n, bsz)


def test_prec_solve_is_one_launch_and_no_copy_on_the_card(cuda):
    """One ``foodweb.prec_solve`` at 20 x 20, B = 128 runs one device
    kernel, the K1 solve, and gives the CPU's bits."""
    from ida_tpu_torch.models import foodweb_ic, foodweb_problem

    c0, _ = foodweb_ic(20, 20)
    rng = np.random.default_rng(5)
    yy = torch.from_numpy(np.outer(c0, np.linspace(0.95, 1.05, 128)))
    cj = torch.from_numpy(1e3 * (1.0 + rng.random(128)))
    r = torch.from_numpy(rng.normal(size=(800, 128)))
    out, args = {}, {}
    for dev in ("cpu", cuda):
        prob = foodweb_problem(20, 20, device=dev)
        y, c = yy.to(dev), cj.to(dev)
        args[str(dev)] = (prob.prec_setup(0.0, c, y, torch.zeros_like(y), torch.zeros_like(y)),
                          r.to(dev), c)
        out[str(dev)] = prob.prec_solve(*args[str(dev)])
    torch.cuda.synchronize()
    small_lu.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(1000)  # the profiler may drop a window's first device activity
        torch.cuda.synchronize()
        prob.prec_solve(*args["cuda"])
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key}
    assert small_lu.SOLVE_LAUNCHES == 1
    assert sum(kernels.values()) == 1 and "solve_kernel" in next(iter(kernels)), kernels
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


def test_lu_function_gradcheck_on_the_card(cuda):
    """The LU Functions' derivatives through K1 and ``small_lu_solve_t``:
    reverse, forward and second order at N = 3, B = 5, f64; the backward
    launches the transposed-solve kernel and never the plain version."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(3, 3, 5)) + 3.0 * np.eye(3)[:, :, None]).to(cuda)
    b = torch.from_numpy(rng.normal(size=(3, 5))).to(cuda)
    a.requires_grad_()
    b.requires_grad_()

    def solve(a, b):
        return dense_lu.lu_solve_auto(dense_lu.lu_factor_auto(a), b)

    assert torch.autograd.gradcheck(solve, (a, b), check_forward_ad=True)
    assert torch.autograd.gradgradcheck(solve, (a, b))
    small_lu.reset_launch_counts()
    x = solve(a, b)
    torch.autograd.grad(x.sum(), (a, b))
    assert (small_lu.FACTOR_LAUNCHES, small_lu.SOLVE_LAUNCHES, small_lu.SOLVE_T_LAUNCHES) == (1, 1, 1)


def test_adjoint_gradient_on_the_card_matches_the_cpu(cuda):
    """``sensitivity.adjoint_gradient`` on one Roberts lane: the card (K1 and
    its transposed solve) against the CPU run of the same lane."""
    from ida_tpu_torch.sensitivity import adjoint_gradient

    def run(dev):
        w = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, device=dev)
        return adjoint_gradient(
            roberts_factory, ROBERTS_PARAMS,
            lambda p: torch.tensor(ROBERTS_YY0, dtype=torch.float64, device=dev),
            lambda p: p[0] * torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float64, device=dev),
            tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device=dev), 0.4, lambda y: (y * w).sum(),
            max_attempts=48, device=dev)

    small_lu.reset_launch_counts()
    v, g, ist = run(cuda)
    assert int(ist) == 0 and small_lu.SOLVE_T_LAUNCHES > 0
    vc, gc, _ = run("cpu")
    assert torch.allclose(v.cpu(), vc, rtol=1e-12)
    assert torch.allclose(g.cpu(), gc, rtol=1e-9)


def test_lu_factor_solve_solves_on_the_card(cuda):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(512, 5, 5)) + 3.0 * np.eye(5)
    b = rng.normal(size=(512, 5))
    x = small_lu.lu_factor_solve(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    np.testing.assert_allclose(np.einsum("bij,bj->bi", a, x.cpu().numpy()), b, atol=1e-10)


def test_ensemble_goes_through_the_kernels(cuda):
    bsz = 64
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, bsz)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (bsz, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    out = {}
    for dev in ("cpu", cuda):
        st = ensemble_init(roberts_factory, params, yy0, yp0, device=dev)
        small_lu.reset_launch_counts()
        out[str(dev)] = make_ensemble_solve(roberts_factory)(
            st, params, tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device=dev), 4.0
        )
        launched = small_lu.FACTOR_LAUNCHES > 0 and small_lu.SOLVE_LAUNCHES > 0
        assert launched == (str(dev) != "cpu")
    (sg, _, ig), (sc, _, ic) = out["cuda"], out["cpu"]
    assert bool((ig.cpu() == C.SUCCESS).all()) and bool((ic == C.SUCCESS).all())
    w = 1.0 / (1e-4 * sc.yy.abs() + torch.tensor([1e-8, 1e-6, 1e-6], dtype=torch.float64))
    assert float(((w * (sg.yy.cpu() - sc.yy)) ** 2).mean(dim=1).sqrt().max()) < 1.0


ATOL = [1e-8, 1e-6, 1e-6]


def _ensemble(bsz, device, dtype=torch.float64, opts=IdaOptions()):
    params = np.outer(np.exp(np.linspace(-0.5, 0.5, bsz)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (bsz, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, ensemble_init(roberts_factory, params, yy0, yp0, device=device, dtype=dtype,
                                 opts=opts)


def _bits(x):
    from chip_smoke import BITS

    return x.contiguous().view(BITS[x.dtype]) if x.is_floating_point() else x


def _same_states(a, b):
    """The fields of ``a`` whose bits differ from ``b``'s (+0 and -0 differ)."""
    return [f for f, x in zip(a._fields, a)
            if isinstance(x, torch.Tensor) and not torch.equal(_bits(x), _bits(getattr(b, f)))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernel_matches_the_eager_path_bitwise(cuda, dtype):
    params, st0 = _ensemble(256, cuda, dtype)
    tol = tol_sv(1e-4, ATOL, device=cuda, dtype=dtype)
    fused_solve.reset_launch_counts()
    st, tret, ist = fused_solve.make_fused_solve(roberts_factory, tol)(st0, params, 400.0)
    assert fused_solve.launch_count("solve") == 1
    est, etret, eist = make_ensemble_solve(roberts_factory)(st0, params, tol, 400.0)
    assert bool((ist == C.SUCCESS).all())
    assert torch.equal(ist, eist) and torch.equal(tret, etret)
    if dtype == torch.float64:
        assert _same_states(st, est) == []
    else:
        # f32: the counters; pow in f32 may round apart in a last bit
        for f in ("nst", "nre", "nje", "nni", "netf", "ncfn"):
            assert torch.equal(getattr(st, f), getattr(est, f)), f


def test_budgeted_kernel_is_bitwise_the_unbudgeted_kernel(cuda):
    params, st0 = _ensemble(256, cuda)
    tol = tol_sv(1e-4, ATOL, device=cuda)
    ref = fused_solve.make_fused_solve(roberts_factory, tol)(st0, params, 400.0)
    fused_solve.reset_launch_counts()
    got = fused_solve.make_fused_solve(roberts_factory, tol, attempt_budget=7)(st0, params, 400.0)
    assert fused_solve.launch_count("init") == 1 and fused_solve.launch_count("cont") > 3
    assert fused_solve.launch_count("solve") == 0
    assert _same_states(got[0], ref[0]) == []
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


def test_budgeted_kernel_launches_are_the_eager_budgeted_calls(cuda):
    # the plain version of K3/K4: after every launch (K3 out of place, K4 in
    # place on its result), the state and the 9-field carry are bit for bit
    # those of the eager solve(max_attempts=7, resume_carry=...) call on the
    # same card
    _budgeted_launches_are_the_eager_calls(cuda, IdaOptions())


# the whole-solve kernel's non-parity modes: (fast_math, ls_precision)
NON_PARITY = [(False, "single"), (False, "refined"), (True, "full"), (True, "single"),
              (True, "refined")]


def _mode_id(mode):
    return "-".join((["fast_math"] if mode[0] else []) + [mode[1]])


@pytest.mark.parametrize("budget", [None, 7], ids=["k2", "k3_k4"])
@pytest.mark.parametrize("mode", NON_PARITY, ids=_mode_id)
def test_fused_kernel_in_each_mode_is_bitwise_the_eager_mode(cuda, mode, budget):
    # K2, and K3 + K4 at budget 7, in each mode: every lane SUCCESS and
    # every field bit for bit the eager solve under the same options on the
    # card; only that mode's kernels launch
    opts = IdaOptions(fast_math=mode[0], ls_precision=mode[1])
    params, st0 = _ensemble(256, cuda, opts=opts)
    tol = tol_sv(1e-4, ATOL, device=cuda)
    fused_solve.reset_launch_counts()
    st, tret, ist = fused_solve.make_fused_solve(roberts_factory, tol, opts,
                                                 attempt_budget=budget)(st0, params, 400.0)
    assert {m for _, m, _ in fused_solve.MODE_LAUNCHES} == {fused_solve.mode_name(opts)}
    assert {k for k, _, _ in fused_solve.MODE_LAUNCHES} == (
        {"init", "cont"} if budget else {"solve"})
    est, etret, eist = make_ensemble_solve(roberts_factory, opts)(st0, params, tol, 400.0)
    assert bool((ist == C.SUCCESS).all())
    assert _same_states(st, est) == []
    assert torch.equal(ist, eist) and torch.equal(tret, etret)


# the whole-solve kernel's other linear solvers, and their horizons: under
# the inexact band (1, 1) lanes meet mxstep before 4
LINEAR = {"band2_2": (IdaOptions(linear_solver="band", band_mu=2, band_ml=2), 400.0),
          "band1_1": (IdaOptions(linear_solver="band", band_mu=1, band_ml=1), 0.4),
          "spgmr": (IdaOptions(linear_solver="spgmr"), 400.0)}


@pytest.mark.parametrize("budget", [None, 7], ids=["k2", "k3_k4"])
@pytest.mark.parametrize("case", LINEAR)
def test_fused_kernel_with_band_and_krylov_solvers_is_bitwise_the_eager_solve(cuda, case,
                                                                               budget):
    # the band and spgmr libraries, K2 and K3 + K4 at budget 7, at B = 256:
    # every lane SUCCESS, every field (the band factor, the Krylov counters)
    # bit for bit the eager solve under the same options on the card, and
    # only that library's kernels launched
    opts, tout = LINEAR[case]
    params, st0 = _ensemble(256, cuda, opts=opts)
    tol = tol_sv(1e-4, ATOL, device=cuda)
    fused_solve.reset_launch_counts()
    st, tret, ist = fused_solve.make_fused_solve(roberts_factory, tol, opts,
                                                 attempt_budget=budget)(st0, params, tout)
    assert {m for _, m, _ in fused_solve.MODE_LAUNCHES} == {fused_solve.mode_name(opts)}
    assert sum(fused_solve.MODE_LAUNCHES.values()) >= 1
    est, etret, eist = make_ensemble_solve(roberts_factory, opts)(st0, params, tol, tout)
    assert bool((ist == C.SUCCESS).all())
    assert _same_states(st, est) == []
    assert torch.equal(ist, eist) and torch.equal(tret, etret)
    assert bool((st.nli > 0).all()) == (case == "spgmr")


@pytest.mark.parametrize("mode", NON_PARITY, ids=_mode_id)
def test_fused_kernel_in_each_mode_takes_the_eager_steps_in_float32(cuda, mode):
    # float32 states: the counters, istate and tret, as for parity above
    opts = IdaOptions(fast_math=mode[0], ls_precision=mode[1])
    params, st0 = _ensemble(256, cuda, torch.float32, opts)
    tol = tol_sv(1e-4, ATOL, device=cuda, dtype=torch.float32)
    st, tret, ist = fused_solve.make_fused_solve(roberts_factory, tol, opts)(st0, params, 400.0)
    est, etret, eist = make_ensemble_solve(roberts_factory, opts)(st0, params, tol, 400.0)
    assert bool((ist == C.SUCCESS).all()) and st.lu.dtype == torch.float32
    assert torch.equal(ist, eist) and torch.equal(tret, etret)
    for f in ("nst", "nre", "nje", "nni", "netf", "ncfn"):
        assert torch.equal(getattr(st, f), getattr(est, f)), f


@pytest.mark.parametrize("mode", [(True, "full"), (False, "refined"), (True, "refined")],
                         ids=_mode_id)
def test_budgeted_kernel_launches_in_the_modes_are_the_eager_budgeted_calls(cuda, mode):
    # as for parity: under fast_math phi is unscaled at each budget
    # boundary, under "refined" the lsetup point carries across launches
    _budgeted_launches_are_the_eager_calls(
        cuda, IdaOptions(fast_math=mode[0], ls_precision=mode[1]))


def _budgeted_launches_are_the_eager_calls(cuda, opts):
    params, st0 = _ensemble(256, cuda, opts=opts)
    p_b = torch.as_tensor(params, device=cuda).contiguous()
    p = p_b.t().contiguous()
    problem = roberts_factory(p)
    eager = (to_native(st0), None, None, None)
    inputs = fused_solve.lane_inputs(eager[0], p, tol_sv(1e-4, ATOL, device=cuda), 400.0, 3)
    tol = TolControl(inputs[1], inputs[2])
    tol_in = fused_solve.tol_inputs(tol_sv(1e-4, ATOL, device=cuda), 3, 256, torch.float64, cuda)
    dst = fused_solve.empty_result(st0, opts, fused_solve.ROBERTS)
    carry = fused_solve.new_carry(256, torch.float64, cuda, True)

    def step(resume):
        nonlocal eager
        istate = fused_solve.launch("cont" if resume else "init", dst if resume else st0, dst,
                                    p_b, tol_in, 400.0, carry, opts, fused_solve.ROBERTS, 7)
        eager = core_solve(eager[0], problem, opts, tol, inputs[3], max_attempts=7,
                           resume_carry=eager[3] if resume else None)
        assert _same_states(to_native(dst), eager[0]) == [], resume
        for f, want in zip(fused_solve.CARRY_FIELDS, eager[3]):
            assert torch.equal(carry[f], want.to(carry[f].dtype)), (resume, f)
        return istate

    assert fused_solve.run_until_done(step) > 3
    assert bool((carry["istate"] == C.SUCCESS).all())


@pytest.mark.parametrize("bsz", [1, 129, 200])
def test_fused_kernel_takes_batches_that_do_not_fill_a_block(cuda, bsz):
    params, st0 = _ensemble(bsz, cuda)
    tol = tol_sv(1e-4, ATOL, device=cuda)
    before = [x.clone() if isinstance(x, torch.Tensor) else x for x in st0]
    st, tret, ist = fused_solve.make_fused_solve(roberts_factory, tol)(st0, params, 400.0)
    est, etret, eist = make_ensemble_solve(roberts_factory)(st0, params, tol, 400.0)
    assert _same_states(st, est) == []
    assert torch.equal(ist, eist) and torch.equal(tret, etret)
    # out of place: the input keeps its bits, untouched fields pass through
    touched = fused_solve.touched_fields(IdaOptions(), fused_solve.ROBERTS)
    for f, x, was in zip(st0._fields, st0, before):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, was), f
            assert (getattr(st, f) is x) == (f not in touched), f


def test_fused_kernel_takes_per_lane_tolerances(cuda):
    params, st0 = _ensemble(256, cuda)
    rng = np.random.default_rng(11)
    rtol = torch.from_numpy(1e-4 * np.exp(rng.uniform(-1, 1, 256))).to(cuda)
    atol = torch.from_numpy(np.array(ATOL) * np.exp(rng.uniform(-1, 1, (256, 3)))).to(cuda)
    st, tret, ist = fused_solve.make_fused_solve(roberts_factory, TolControl(rtol, atol))(
        st0, params, 400.0)
    p = torch.as_tensor(params, device=cuda).t().contiguous()
    ref = core_solve(to_native(st0), roberts_factory(p), IdaOptions(),
                     TolControl(rtol, atol.t().contiguous()),
                     torch.full((256,), 400.0, dtype=torch.float64, device=cuda))
    assert _same_states(st, from_native(ref[0])) == []
    assert torch.equal(ist, ref[2]) and torch.equal(tret, ref[1])


def test_solve_kernel_occupancy_is_reported(cuda):
    occ = fused_solve.occupancy(torch.float64)
    assert occ["threads"] == 64 and occ["blocks_per_sm"] >= 1
    assert occ["dynamic_shared_bytes"] == 64 * 8 * 6 * (3 + 5)


def test_entry_points_default_to_the_card(cuda):
    params, _ = _ensemble(4, cuda)
    yy0 = np.tile(ROBERTS_YY0, (4, 1))
    st = ensemble_init(roberts_factory, params, yy0, np.zeros_like(yy0))
    assert st.phi.is_cuda and tol_sv(1e-4, ATOL).rtol.is_cuda


@pytest.fixture(scope="module")
def mid_flight():
    """Real states after 1 and 8 ONE_STEP calls of the eager path on the
    card, and the latter with hh x16 (failed attempts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    params, st = _ensemble(256, "cuda")
    tol = tol_sv(1e-4, ATOL, device="cuda")
    fn = make_ensemble_solve(roberts_factory, itask=TASK_ONE_STEP)
    snaps = {"init": to_native(st)}
    for k in range(1, 9):
        st, _, _ = fn(st, params, tol, 400.0)
        if k in (1, 8):
            snaps[f"step{k}"] = to_native(st)
    snaps["hh_x16"] = snaps["step8"]._replace(hh=snaps["step8"].hh * 16.0)
    return torch.from_numpy(params.T).contiguous().to("cuda"), tol, snaps


@pytest.mark.parametrize("stage", sorted(fused_stages.STAGES))
def test_stage_kernel_matches_its_eager_stage(mid_flight, stage):
    params, tol, snaps = mid_flight
    names = ["init"] if stage == "prologue" else ["step1", "step8", "hh_x16"]
    for name in names:
        st = snaps[name]
        if stage in ("nls", "error_test", "complete_step"):
            # these run inside an attempt: after set_coeffs, predict, tn += hh
            st, _ = fused_stages.plain_stage("set_coeffs", st, params, tol, 400.0)
            st = st._replace(tn=st.tn + st.hh)
        fused_stages.reset_launch_counts()
        got_st, got = fused_stages.run_stage(stage, st, params, tol, 400.0)
        assert fused_stages.STAGE_LAUNCHES[stage] == 1
        ref_st, ref = fused_stages.plain_stage(stage, st, params, tol, 400.0)
        assert _same_states(got_st, ref_st) == [], (name, stage)
        for k, v in ref.items():
            assert torch.equal(got[k].to(v.dtype), v), (name, stage, k)


def test_fused_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    params, st0 = _ensemble(8, cuda)
    tol = tol_sv(1e-4, ATOL, device=cuda)
    fn = fused_solve.make_fused_solve(roberts_factory, tol)
    with pytest.raises(ValueError):
        fn(st0._replace(phi=st0.phi.transpose(1, 2)), params, 4.0)
    with pytest.raises(TypeError):
        fn(st0._replace(kk=st0.kk.long()), params, 4.0)


# ------------------------------- roots, dense output and the user surface


def _rooted(p):
    return roberts_factory(p, with_roots=True)


def test_scan_ties_pick_the_first_component_on_the_card(cuda):
    from ida_tpu_torch.core.root import _scan

    glo = torch.tensor([[-1.0, 1.0], [-1.0, 1.0]], device=cuda)
    gnew = torch.tensor([[1.0, 2.0], [1.0, 2.0]], device=cuda)
    act = torch.ones_like(glo, dtype=torch.bool)
    _, sgnchg, imax = _scan(act, torch.zeros_like(glo, dtype=torch.int32), glo, gnew)
    assert sgnchg.tolist() == [True, False] and imax.tolist() == [0, 0]


def test_rooted_ensemble_on_the_card_equals_the_cpu_run(cuda):
    from ida_tpu_torch.parallel import EnsembleIDA

    bsz = 64
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, bsz)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (bsz, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    runs = {}
    for dev in ("cuda", "cpu"):
        ens = EnsembleIDA(_rooted, params, yy0, yp0, tol_sv(1e-4, ATOL, device=dev), device=dev)
        first = ens.solve(0.4)
        iroots = ens.states.iroots.cpu().numpy()
        runs[dev] = (first, iroots, ens.solve(0.4), ens.solve(400.0), ens.states)
    (g1, gi, g2, g3, gst), (c1, ci, c2, c3, cst) = runs["cuda"], runs["cpu"]
    assert g1[1].tolist() == c1[1].tolist() == [C.ROOT_RETURN] * bsz
    assert gi.tolist() == ci.tolist() == [[0, 1]] * bsz
    np.testing.assert_allclose(g1[0], c1[0], rtol=1e-9, atol=0)
    assert g2[1].tolist() == g3[1].tolist() == [C.SUCCESS] * bsz and g3[0].tolist() == [400.0] * bsz
    for f in ("nst", "nge", "nre", "nni"):
        assert torch.equal(getattr(gst, f).cpu(), getattr(cst, f)), f


def test_solve_dense_rows_equal_chained_solve_kernel_launches(cuda):
    from ida_tpu_torch.core.solve import solve_dense

    bsz, touts = 256, [0.4, 4.0, 40.0, 400.0]
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, bsz)), ROBERTS_PARAMS)
    yy0 = np.tile(ROBERTS_YY0, (bsz, 1))
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    tol = tol_sv(1e-4, ATOL, device=cuda)
    lead = ensemble_init(roberts_factory, params, yy0, yp0, device=cuda)
    p = torch.as_tensor(params, device=cuda).t().contiguous()
    native = to_native(lead)
    inputs = fused_solve.lane_inputs(native, p, tol, 400.0, 3)
    out = solve_dense(native, roberts_factory(p), IdaOptions(), TolControl(inputs[1], inputs[2]), touts)
    fn = fused_solve.make_fused_solve(roberts_factory, tol)
    for k, tout in enumerate(touts):
        lead, tret, ist = fn(lead, params, tout)
        assert torch.equal(out[1][k], tret) and torch.equal(out[2][k], ist)
        assert torch.equal(out[3][k], lead.yy.t()) and torch.equal(out[4][k], lead.yp.t())
        assert torch.equal(out[5][k], lead.nst)


def test_ida_runs_on_the_card_by_default(cuda):
    from ida_tpu_torch import IDA, IdaSolveStatus
    from ida_tpu_torch.models import ROBERTS_YP0, roberts_problem

    ida = IDA(roberts_problem(), ROBERTS_YY0, ROBERTS_YP0, tol_sv(1e-4, ATOL))
    assert ida.device.type == "cuda" and ida.state.phi.is_cuda
    tret, status = ida.solve(0.4)
    assert status == IdaSolveStatus.Root and ida.get_root_info().tolist() == [0, 1]
    assert abs(tret - 0.2640160014306263) < 1e-9 * tret
    assert ida.solve(0.4) == (0.4, IdaSolveStatus.Success)
    assert (ida.get_num_steps(), ida.get_num_g_evals()) == (29, 44)
    t = ida.get_current_time() - 0.5 * ida.get_last_step()
    assert np.array_equal(ida.get_dky(t, 0), ida.get_solution(t)[0])


def test_kernel_at_n2_with_two_batch_axes_matches_plain_bitwise(cuda):
    # the foodweb preconditioner's blocks: [2, 2, npts, B], factored and
    # solved as npts x B systems in one launch each
    from ida_tpu_torch.models.foodweb import prec_blocks

    rng = np.random.default_rng(2)
    yy = torch.from_numpy(rng.uniform(1.0, 2.0, size=(2 * 36, 5))).to(cuda)
    cj = torch.from_numpy(rng.uniform(10.0, 1e3, size=5)).to(cuda)
    blocks = prec_blocks(6, 6, cj, yy)
    assert tuple(blocks.shape) == (2, 2, 36, 5) and blocks.is_contiguous()
    b = torch.from_numpy(rng.normal(size=(2, 36, 5))).to(cuda)
    small_lu.reset_launch_counts()
    f, g = small_lu.lu_factor(blocks), dense_lu.lu_factor_unrolled(blocks)
    x, y = small_lu.lu_solve(f, b), dense_lu.lu_solve_unrolled(g, b)
    torch.cuda.synchronize()
    assert (small_lu.FACTOR_LAUNCHES, small_lu.SOLVE_LAUNCHES) == (1, 1)
    assert torch.equal(f.lu, g.lu) and torch.equal(f.piv, g.piv)
    assert torch.equal(f.fail_col, g.fail_col) and torch.equal(x, y)


def test_spgmr_on_the_card_matches_the_cpu(cuda):
    # a batch of diagonally dominant systems with a diagonal preconditioner;
    # every sum over the long axis (the products with A included) is the
    # same pairwise tree on both devices, so the counters agree exactly
    from ida_tpu_torch.ops.spgmr import spgmr_solve
    from ida_tpu_torch.utils.numerics import sum0

    rng = np.random.default_rng(3)
    n, bsz = 300, 4
    a = np.eye(n)[:, :, None] * 4.0 + rng.normal(size=(n, n, bsz)) * 0.05
    d = np.abs(rng.normal(size=(n, bsz))) + 1.0
    b = rng.normal(size=(n, bsz))

    def run(device):
        at, dt, bt = (torch.from_numpy(v).to(device) for v in (a, d, b))
        w = 1.0 / (dt + 1.0)
        return spgmr_solve(lambda v: sum0((at * v[None]).movedim(1, 0)), bt, torch.tensor(1e-10, device=device),
                           psolve=lambda r: r / dt, s1=w, s2=w, maxl=5, max_restarts=10)

    gpu, cpu = run(cuda), run("cpu")
    for k in ("converged", "nli", "nps", "natimes"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
    assert bool(cpu.converged.all())
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=1e-12, atol=1e-12)


def _constrained(bsz, device):
    """``bsz`` lanes of the constraints probe (rtol 1e-2, every y >= 0), the
    last lane at the nominal parameters."""
    params, st = _ensemble(bsz, device)
    params[-1] = ROBERTS_PARAMS
    st = ensemble_init(roberts_factory, params, np.tile(ROBERTS_YY0, (bsz, 1)),
                       params[:, :1] * np.array([-1.0, 1.0, 0.0]), device=device)
    st = st._replace(constraints=torch.ones_like(st.constraints),
                     constraints_set=torch.ones_like(st.constraints_set))
    return params, st


def test_fused_kernel_keeps_the_constraints(cuda):
    # the constraints probe over 12 decades: K2 and the budgeted K3/K4 bit
    # for bit the eager solve in every field, y >= 0, and the nominal lane's
    # 148 steps and 219 residual evaluations (ida_tpu's)
    params, st0 = _constrained(256, cuda)
    tol = tol_sv(1e-2, [1e-5, 1e-3, 1e-3], device=cuda)
    fused = fused_solve.make_fused_solve(roberts_factory, tol)
    budgeted = fused_solve.make_fused_solve(roberts_factory, tol, attempt_budget=32)
    eager = make_ensemble_solve(roberts_factory)
    k2 = k34 = e = st0
    for k in range(12):
        tout = 0.4 * 10**k
        k2, tret, ist = fused(k2, params, tout)
        k34, tret_b, ist_b = budgeted(k34, params, tout)
        e, etret, eist = eager(e, params, tol, tout)
        assert _same_states(k2, e) == [] and _same_states(k34, e) == [], tout
        assert torch.equal(ist, eist) and torch.equal(ist_b, eist) and torch.equal(tret, etret)
        # y >= 0 to the rounding of the correction that pulls a violation
        # back (late decades give -1e-37 here as in ida_tpu run op by op);
        # exactly for the nominal lane
        floor = -torch.finfo(torch.float64).eps * torch.tensor([1e-5, 1e-3, 1e-3], device=cuda)
        assert bool((eist == C.SUCCESS).all()) and bool((e.yy >= floor).all())
        assert bool((e.yy[-1] >= 0.0).all())
    assert int(e.nst[-1]) == 148 and int(e.nre[-1]) == 219


# ------------------------- mixed precision, fast_math, slider-crank, scopes


def _modes_ensemble(device, opts, bsz=64, tout=4.0):
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, bsz)), ROBERTS_PARAMS)
    st = ensemble_init(roberts_factory, params, np.tile(ROBERTS_YY0, (bsz, 1)),
                       params[:, :1] * np.array([-1.0, 1.0, 0.0]), device=device, opts=opts)
    return make_ensemble_solve(roberts_factory, opts)(
        st, params, tol_sv(1e-4, ATOL, device=device), tout)


@pytest.mark.parametrize("mode", ["single", "refined"])
def test_dense_mixed_modes_run_the_float32_kernels(cuda, mode):
    # "single" and "refined" factor and solve through K1's float32 kernels
    # at N = 3 and launch no float64 LU; the lanes end within the
    # integration tolerance of the CPU run of the mode
    opts = IdaOptions(ls_precision=mode)
    small_lu.reset_launch_counts()
    sg, _, ig = _modes_ensemble(cuda, opts)
    counts = dict(small_lu.LAUNCHES)
    sc, _, ic = _modes_ensemble("cpu", opts)
    assert counts.get(("factor", "f32", 3), 0) > 0 and counts.get(("solve", "f32", 3), 0) > 0
    assert not any(tag == "f64" for _, tag, _ in counts), counts
    assert sg.lu.dtype == torch.float32 and sg.lu.is_cuda
    assert bool((ig.cpu() == C.SUCCESS).all()) and bool((ic == C.SUCCESS).all())
    w = 1.0 / (1e-4 * sc.yy.abs() + torch.tensor(ATOL, dtype=torch.float64))
    assert float(((w * (sg.yy.cpu() - sc.yy)) ** 2).mean(dim=1).sqrt().max()) < 1.0


def test_fast_math_on_the_card_tracks_parity(cuda):
    sf, _, i_f = _modes_ensemble(cuda, IdaOptions(fast_math=True))
    sp, _, i_p = _modes_ensemble(cuda, IdaOptions())
    assert bool((i_f == C.SUCCESS).all()) and bool((i_p == C.SUCCESS).all())
    diff = (sf.yy - sp.yy).abs().cpu()
    assert bool((diff <= 1e-3 * sp.yy.abs().cpu() + torch.tensor(ATOL)).all())


def test_krylov_single_runs_the_float32_n2_solve(cuda):
    # foodweb's block preconditioner under Krylov "single": K1's float32
    # solve at N = 2, no float64 LU launch
    from ida_tpu_torch import IDA
    from ida_tpu_torch.models import foodweb_ic, foodweb_problem
    from ida_tpu_torch.tol_control import tol_ss

    c0, cp0 = foodweb_ic(4, 4)
    ida = IDA(foodweb_problem(4, 4), c0, cp0, tol_ss(1e-5, 1e-5),
              IdaOptions(linear_solver="spgmr", ls_precision="single", mxstep=5000))
    ida.calc_ic("ya_ydp", tout1=1e-3)  # the predators' guess is not consistent
    small_lu.reset_launch_counts()
    assert ida.solve(1e-3)[1].name == "Success"
    counts = dict(small_lu.LAUNCHES)
    assert counts.get(("solve", "f32", 2), 0) > 0 and counts.get(("factor", "f64", 2), 0) > 0
    assert not any(k == "solve" and tag == "f64" for k, tag, _ in counts), counts


def test_slider_crank_runs_k1_at_n10(cuda):
    from ida_tpu_torch import IDA
    from ida_tpu_torch.models import slider_crank_ic, slider_crank_problem
    from ida_tpu_torch.tol_control import tol_ss

    yy0, yp0 = slider_crank_ic()
    ida = IDA(slider_crank_problem(), yy0, yp0, tol_ss(1e-6, 1e-6),
              IdaOptions(mxstep=50000, suppressalg=True))
    small_lu.reset_launch_counts()
    assert ida.solve(0.1)[1].name == "Success"
    # the lsetup runs every outer Newton pass and is kept where it is due,
    # so factors are launched at least once a Jacobian evaluation
    assert small_lu.LAUNCHES["factor", "f64", 10] >= ida.get_num_jac_evals() > 0
    assert small_lu.LAUNCHES["solve", "f64", 10] > 0
    # one lane at N = 10: both on the group skeleton
    for kernel in ("factor", "solve"):
        assert small_lu.GROUP_LAUNCHES[kernel, "f64", 10] == small_lu.LAUNCHES[kernel, "f64", 10]
    y = ida.get_yy()
    assert abs(-np.sin(y[2]) - 0.5 * np.sin(y[0])) < 1e-8


def test_profile_records_the_scopes_and_the_card(cuda, tmp_path):
    from ida_tpu_torch.utils import profiling

    with profiling.profile(str(tmp_path / "trace")) as prof:
        _modes_ensemble(cuda, IdaOptions(), bsz=256, tout=0.04)
        torch.cuda.synchronize()
    events = prof.key_averages()
    names = {e.key for e in events}
    assert {"ida.step.attempt", "ida.lsetup", "ida.nonlinear_solve"} <= names
    dev = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    assert dev > 0 and (tmp_path / "trace" / "trace.json").exists()


def _lane_counts():
    """1, 2, 3, 31 and 1,024 lanes, and each end of each range of lanes of
    the rule +- 1."""
    from test_torch_lu_groups import RULE

    counts = {1, 2, 3, 31, 1024}
    for _, lo, hi, _ in RULE.values():
        counts |= {e + d for e in (lo, hi) for d in (-1, 0, 1) if e + d >= 1}
    return sorted(counts)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_both_skeletons_are_bitwise_the_plain_versions(cuda, dtype):
    """K1's factor and solve at N = 1..16 on each lane count of
    :func:`_lane_counts`, so on both sides of every crossover of the rule:
    bit for bit the plain versions, the launch counted on the skeleton the
    rule names."""
    from test_torch_lu_groups import same_bits

    tag = small_lu.DTYPE_TAGS[dtype]
    for n in range(1, 17):
        for lanes in _lane_counts():
            a, b = _system(n, dtype, cuda, bsz=lanes, seed=lanes)
            small_lu.reset_launch_counts()
            f, g = small_lu.lu_factor(a), dense_lu.lu_factor_unrolled(a)
            x, y = small_lu.lu_solve(g, b), dense_lu.lu_solve_unrolled(g, b)
            torch.cuda.synchronize()
            assert same_bits(f.lu, g.lu) and torch.equal(f.piv, g.piv), (n, lanes)
            assert torch.equal(f.fail_col, g.fail_col) and same_bits(x, y), (n, lanes)
            want = {(k, tag, n): int(small_lu.uses_groups(k, tag, n, lanes))
                    for k in ("factor", "solve")}
            assert {k: small_lu.GROUP_LAUNCHES[k] for k in want} == want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_both_skeletons_on_adversarial_columns_and_layouts(cuda, dtype):
    """Ties, NaN at the diagonal and below it, +-0, +-Inf and zero pivots
    (``fail``) at N = 1..16, factor and solve; then the solve on the one-lane
    layout (lu [N, N], b [N]) and on ``prec_solve``'s views of a few lanes:
    each bit for bit its plain version."""
    from test_torch_lu_groups import adversarial, same_bits
    from test_torch_lu_layouts import operands

    for n in range(1, 17):
        for lanes in (1, 12, 1024):
            a = torch.from_numpy(adversarial(n, max(lanes, 12), 7 * n)[..., :lanes]).to(cuda, dtype)
            b = torch.from_numpy(np.random.default_rng(n).normal(size=(n, lanes))).to(cuda, dtype)
            f, g = small_lu.lu_factor(a), dense_lu.lu_factor_unrolled(a)
            x, y = small_lu.lu_solve(g, b), dense_lu.lu_solve_unrolled(g, b)
            torch.cuda.synchronize()
            assert same_bits(f.lu, g.lu) and torch.equal(f.piv, g.piv), (n, lanes)
            assert torch.equal(f.fail_col, g.fail_col) and same_bits(x, y), (n, lanes)
        a, b = _system(n, dtype, cuda, bsz=1, seed=3)
        one = dense_lu.lu_factor_unrolled(a[:, :, 0])
        assert same_bits(small_lu.lu_factor(a[:, :, 0].contiguous()).lu, one.lu)
        assert same_bits(small_lu.lu_solve(one, b[:, 0]), dense_lu.lu_solve_unrolled(one, b[:, 0]))
        for bsz in (1, 3):
            f, b = operands("factor_view", n, bsz, dtype)
            f = dense_lu.DenseLU(f.lu.to(cuda), f.piv.to(cuda), None)
            b = b.to(cuda)
            x = small_lu.lu_solve(f, b)
            assert x.stride() == b.stride() and same_bits(x, dense_lu.lu_solve_unrolled(f, b))


def test_the_rule_launches_the_skeleton_it_counts(cuda):
    """The kernel the card runs (torch.profiler's names) is the one
    ``small_lu.uses_groups`` counts, on both sides of the N = 10 factor's and
    the N = 6 solve's range ends, at the headline's and foodweb's shapes
    and at the adjoints' N = 3 (1,024 and 4,096 lanes). A window holds 20 launches: one that holds a single launch was
    seen to come back empty."""
    cases = [(3, 65536), (2, 51200), (3, 1024), (3, 4096), (10, 1), (10, 1024), (10, 1025),
             (6, 1024), (6, 8192), (6, 8193)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for n, lanes in cases:
        a, b = _system(n, torch.float64, cuda, bsz=lanes)
        f = small_lu.lu_factor(a)
        torch.cuda.synchronize()
        for kernel, go in (("factor", lambda: small_lu.lu_factor(a)),
                           ("solve", lambda: small_lu.lu_solve(f, b))):
            names = {}
            for _ in range(3):  # a window that recorded nothing is taken again
                with torch.profiler.profile(activities=acts) as prof:
                    torch.cuda._sleep(1000)  # the profiler may drop a window's first activity
                    torch.cuda.synchronize()
                    for _ in range(20):
                        go()
                    torch.cuda.synchronize()
                names = {e.key: e.count for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA and "spin" not in e.key}
                if names:
                    break
            group = small_lu.uses_groups(kernel, "f64", n, lanes)
            want = f"{kernel}_group_kernel" if group else f"{kernel}_kernel"
            assert names and all(want in name for name in names), (n, lanes, names)


def test_continuous_adjoint_keeps_its_bits_on_the_group_skeleton(cuda, monkeypatch):
    """The continuous adjoint (KKT systems at N = 6 through K1) on 16 lanes:
    the loss and gradients with the shipped build equal, bit for bit, those
    with the parent's dispatch (``-DIDA_LU_GROUP=0``: one thread a lane),
    and the shipped build launched its N = 6 solves, and only those, on the
    groups."""
    from ida_tpu_torch import sensitivity
    from ida_tpu_torch.ops import _build
    from ida_tpu_torch.tol_control import tol_sv as tol

    bsz = 16
    params = np.outer(np.exp(np.linspace(-0.05, 0.05, bsz)), ROBERTS_PARAMS)
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    w = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, device=cuda)

    def run():
        return sensitivity.batched_continuous_adjoint(
            roberts_factory, params, ROBERTS_YY0, yp0, tol(1e-4, ATOL, device=cuda), 4.0,
            lambda y: (y * w).sum(), grid=np.logspace(-4, np.log10(4.0), 64),
            opts=IdaOptions(mxstep=20000), device=cuda)

    small_lu.reset_launch_counts()
    new = run()
    torch.cuda.synchronize()
    # the N = 6 solves alone take the groups: N = 3 keeps one thread a lane
    assert small_lu.LAUNCHES["solve", "f64", 6] > 0
    assert dict(small_lu.GROUP_LAUNCHES) == {("solve", "f64", 6): small_lu.LAUNCHES["solve", "f64", 6]}
    parent = _build.build_library("small_lu.cu", ("small_lu.cuh", "rounded.cuh"),
                                  flags=("-fmad=false", "-DIDA_LU_GROUP=0"))
    small_lu.bind(parent["lib"])
    monkeypatch.setattr(small_lu, "build", lambda: parent)
    small_lu.reset_launch_counts()
    old = run()
    torch.cuda.synchronize()
    # counted by the library that launched: the parent's took no groups
    assert not small_lu.GROUP_LAUNCHES and small_lu.LAUNCHES["solve", "f64", 6] > 0
    for u, v in zip(new, old):
        assert torch.equal(u, v)


def _lorenz_factory(params):
    """Lorenz '63 with per-lane [sigma, rho, beta] and an analytic J: a
    factory whose model the whole-solve kernel generates."""
    from ida_tpu_torch.problem import IdaProblem

    sigma, rho, beta = params[0], params[1], params[2]

    def res(t, yy, yp):
        x, y, z = yy[0], yy[1], yy[2]
        return torch.stack([yp[0] - sigma * (y - x), yp[1] - (x * (rho - z) - y),
                            yp[2] - (x * y - beta * z)])

    def jac(t, cj, yy, yp, rr):
        x, y, z = yy[0], yy[1], yy[2]
        zero = torch.zeros_like(x)
        return torch.stack([torch.stack([cj + sigma, -sigma, zero]),
                            torch.stack([z - rho, cj + 1.0, x]),
                            torch.stack([-y, -x, cj + beta])])

    return IdaProblem(n=3, res=res, jac=jac)


@pytest.mark.parametrize("budget", [None, 7], ids=["k2", "budget7"])
def test_generated_model_kernel_matches_the_eager_path_bitwise(cuda, budget):
    # 256 Lorenz lanes to t = 1 through the generated model's library: bit
    # for bit the eager solve on the same CUDA tensors, launches counted
    # under the model's name
    bsz = 256
    params = np.outer(np.exp(np.linspace(-0.05, 0.05, bsz)), [10.0, 28.0, 8.0 / 3.0])
    yp0 = np.stack([np.zeros(bsz), params[:, 1] - 2.0, 1.0 - params[:, 2]], axis=1)
    st0 = ensemble_init(_lorenz_factory, params, np.ones((bsz, 3)), yp0, device=cuda)
    tol = tol_sv(1e-4, [1e-6] * 3, device=cuda)
    p_b = torch.as_tensor(params, device=cuda).contiguous()
    model = fused_solve.model_of(_lorenz_factory, p_b.t())
    fused_solve.reset_launch_counts()
    st, tret, ist = fused_solve.make_fused_solve(_lorenz_factory, tol, attempt_budget=budget)(
        st0, p_b, 1.0)
    est, etret, eist = make_ensemble_solve(_lorenz_factory)(st0, params, tol, 1.0)
    assert {m for _, _, m in fused_solve.MODE_LAUNCHES} == {model.name}
    assert bool((ist == C.SUCCESS).all())
    assert torch.equal(ist, eist) and torch.equal(tret, etret)
    assert _same_states(st, est) == []


def test_generated_roberts_is_bitwise_the_hand_written_library(cuda):
    params, st0 = _ensemble(256, cuda)
    tol = tol_sv(1e-4, ATOL, device=cuda)

    def roberts_generated(p):
        return roberts_factory(p)

    hand = fused_solve.make_fused_solve(roberts_factory, tol)(st0, params, 400.0)
    gen = fused_solve.make_fused_solve(roberts_generated, tol)(st0, params, 400.0)
    assert _same_states(gen[0], hand[0]) == []
    assert torch.equal(gen[1], hand[1]) and torch.equal(gen[2], hand[2])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generated_model_ops_are_the_eager_problems(cuda, dtype):
    # the table of ops: res, jac and J v of 4,096 random lanes through the
    # model's evaluation kernel, bit for bit the eager problem's
    rng = np.random.default_rng(5)

    def lanes(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda).contiguous()

    p0 = np.array([10.0, 28.0, 8.0 / 3.0])
    args = (lanes(p0[:, None] * np.exp(rng.uniform(-0.2, 0.2, (3, 4096)))),
            lanes(rng.uniform(0, 5, 4096)), lanes(np.exp(rng.uniform(-3, 5, 4096))),
            *(lanes(rng.normal(size=(3, 4096))) for _ in range(3)))
    fused_solve.reset_launch_counts()
    got = fused_solve.eval_model(_lorenz_factory, *args)
    want = fused_solve.eval_model_plain(_lorenz_factory, *args)
    assert sum(fused_solve.EVAL_LAUNCHES.values()) == 1
    assert got[3] is None and want[3] is None  # no quadratures
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)


# ------------------------------------ quadratures and the kinetics/neuron ops




QUAD_SOLVES = {"k2": (IdaOptions(), None, torch.float64),
               "budget7": (IdaOptions(), 7, torch.float64),
               "refined": (IdaOptions(ls_precision="refined"), None, torch.float64),
               "f32": (IdaOptions(), None, torch.float32)}


@pytest.mark.parametrize("solve", QUAD_SOLVES)
def test_quadrature_kernel_matches_the_eager_path_bitwise(cuda, solve):
    # (a) 256 headline lanes to 400 with quadratures through the generated
    # model's library: every field, yQ included, bit for bit the eager solve
    from chip_smoke import quad_factory

    opts, budget, dtype = QUAD_SOLVES[solve]
    bsz = 256
    params = np.outer(np.exp(np.linspace(-0.5, 0.5, bsz)), ROBERTS_PARAMS)
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    st0 = ensemble_init(quad_factory, params, np.tile(ROBERTS_YY0, (bsz, 1)), yp0, device=cuda,
                        dtype=dtype, opts=opts)
    tol = tol_sv(1e-4, ATOL, device=cuda, dtype=dtype)
    p_b = torch.as_tensor(params, device=cuda, dtype=dtype).contiguous()
    model = fused_solve.model_of(quad_factory, p_b.t())
    fused_solve.reset_launch_counts()
    st, tret, ist = fused_solve.make_fused_solve(quad_factory, tol, opts, attempt_budget=budget)(
        st0, p_b, 400.0)
    est, etret, eist = make_ensemble_solve(quad_factory, opts)(st0, params, tol, 400.0)
    assert model.nq == 2 and {m for _, _, m in fused_solve.MODE_LAUNCHES} == {model.name}
    assert torch.equal(ist, eist) and torch.equal(tret, etret)
    assert _same_states(st, est) == [] and not torch.equal(st.yQ, st0.yQ)


@pytest.mark.parametrize("solve", ["k2", "budget7", "refined"])
def test_morris_lecar_kernel_matches_the_eager_path_bitwise(cuda, solve):
    # (b) 256 Morris-Lecar lanes over I in [0, 300] to 10 ms: tanh and cosh in
    # the residual, two quadratures; bit for bit the eager solve
    from ida_tpu_torch.models.morris_lecar import morris_lecar_factory, morris_lecar_inputs
    from ida_tpu_torch.tol_control import tol_ss

    opts, budget, _ = QUAD_SOLVES[solve]
    params, yy0, yp0 = morris_lecar_inputs(256)
    st0 = ensemble_init(morris_lecar_factory, params, yy0, yp0, device=cuda, opts=opts)
    tol = tol_ss(1e-6, 1e-8, device=cuda)
    p_b = torch.as_tensor(params, device=cuda).contiguous()
    st, tret, ist = fused_solve.make_fused_solve(morris_lecar_factory, tol, opts,
                                                 attempt_budget=budget)(st0, p_b, 10.0)
    est, etret, eist = make_ensemble_solve(morris_lecar_factory, opts)(st0, params, tol, 10.0)
    assert bool((ist == C.SUCCESS).all())
    assert torch.equal(ist, eist) and torch.equal(tret, etret)
    assert _same_states(st, est) == []


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_new_ops_and_quadratures_are_the_eager_problems_on_the_card(cuda, dtype):
    # (c) the table of ops: the new ops' zoo on 4,096 lanes, a quarter of them
    # NaN, +-0 or +-inf, and Morris-Lecar's res, jac, J v and quad: bit for
    # bit (the sign of a zero included, NaN equal to NaN) the eager
    # problem's on the same CUDA tensors
    from chip_smoke import ops_zoo_factory, same
    from ida_tpu_torch.models.morris_lecar import morris_lecar_factory
    from test_torch_fused_ops import zoo_inputs

    args = tuple(x.to(cuda) for x in zoo_inputs(dtype))
    got = fused_solve.eval_model(ops_zoo_factory, *args)
    want = fused_solve.eval_model_plain(ops_zoo_factory, *args)
    for g, w in zip(got[:3], want[:3]):
        assert same(g, w)
    rng = np.random.default_rng(9)

    def lanes(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda).contiguous()

    n = 4096
    args = (lanes(100.0 * np.exp(rng.uniform(-1.0, 1.0, (1, n)))), lanes(rng.uniform(0, 5, n)),
            lanes(np.exp(rng.uniform(-3, 5, n))),
            lanes(np.stack([rng.uniform(-80, 60, n), rng.uniform(0, 1, n)])),
            lanes(rng.normal(size=(2, n))), lanes(rng.normal(size=(2, n))))
    got = fused_solve.eval_model(morris_lecar_factory, *args)
    want = fused_solve.eval_model_plain(morris_lecar_factory, *args)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
