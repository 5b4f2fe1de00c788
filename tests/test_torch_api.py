"""The port's user surface: ``IDA``, ``solve_dae``, ``EnsembleIDA``.

The same numpy inputs go to the JAX objects and, through
``utils.convert.ida_from_numpy`` / ``ensemble_from_numpy``, to the port's:
statuses, counters and root signs must agree exactly, floats to rtol 1e-9
(the JAX objects jit their solve, which contracts multiply-adds). The rest
holds the port's objects to their documented behaviour: every getter and
setter, ``reinit``, the failure taxonomy, the two ``solve_grid`` forms, the
``solve_dae`` options, the failure reports, and each refusal of a feature
that is not ported yet.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ida_tpu
import ida_tpu_torch as port
from ida_tpu.models import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0
from ida_tpu.models import roberts_factory as jroberts
from ida_tpu.models import roberts_problem as jroberts_problem
from ida_tpu.parallel import EnsembleIDA as JEnsembleIDA
from ida_tpu.tol_control import tol_sv as jtol_sv
from ida_tpu_torch import constants as C
from ida_tpu_torch.models import roberts_factory, roberts_problem
from ida_tpu_torch.parallel import EnsembleIDA
from ida_tpu_torch.utils.convert import ensemble_from_numpy, ida_from_numpy

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

ATOL = np.array([1e-8, 1e-6, 1e-6])
TOL = {"rtol": np.asarray(1e-4), "atol": ATOL}
GETTERS = (
    "get_last_order", "get_current_order", "get_num_steps", "get_num_res_evals",
    "get_num_lin_solv_setups", "get_num_err_test_fails", "get_num_jac_evals",
    "get_num_nonlin_solv_iters", "get_num_lin_res_evals", "get_num_lin_iters",
    "get_num_prec_solves", "get_num_lin_conv_fails", "get_num_jtsetup_evals",
    "get_num_jtimes_evals", "get_num_nonlin_solv_conv_fails", "get_num_g_evals",
)
FLOAT_GETTERS = (
    "get_actual_init_step", "get_last_step", "get_current_step", "get_current_setp",
    "get_current_time", "get_tol_scale_factor",
)


def _ida(options=port.IdaOptions(), with_roots=True, **kw):
    return ida_from_numpy(roberts_problem(with_roots=with_roots, device="cpu"), ROBERTS_YY0,
                          ROBERTS_YP0, TOL, device="cpu", options=options, **kw)


def _ensemble_inputs(b):
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, b)), ROBERTS_PARAMS)
    return params, np.tile(ROBERTS_YY0, (b, 1)), params[:, :1] * np.array([-1.0, 1.0, 0.0])


def rooted_factory(p):
    return roberts_factory(p, with_roots=True)


# ------------------------------------------------------------- IDA vs ida_tpu


@pytest.fixture(scope="module")
def both_at_first_root():
    """The JAX ``IDA`` and the port's, fed the same arrays, after the solve
    call that returns the first root and the one that lands on 0.4."""
    jida = ida_tpu.IDA(jroberts_problem(), ROBERTS_YY0, ROBERTS_YP0, jtol_sv(1e-4, jnp.asarray(ATOL)))
    tida = _ida()
    out = []
    for ida in (jida, tida):
        r1 = ida.solve(0.4)
        info = np.asarray(ida.get_root_info()).tolist()
        r2 = ida.solve(0.4)
        out.append((r1, info, r2))
    return jida, tida, out


def test_ida_returns_match_the_jax_object(both_at_first_root):
    _, _, ((j1, jinfo, j2), (t1, tinfo, t2)) = both_at_first_root
    assert j1[1].name == t1[1].name == "Root" and j2[1].name == t2[1].name == "Success"
    assert jinfo == tinfo == [0, 1]
    assert isinstance(t1[0], float) and t2[0] == 0.4 == float(j2[0])
    np.testing.assert_allclose(t1[0], float(j1[0]), rtol=1e-9, atol=0)


@pytest.mark.parametrize("getter", GETTERS)
def test_ida_integer_getters_match_the_jax_object(both_at_first_root, getter):
    jida, tida, _ = both_at_first_root
    got = getattr(tida, getter)()
    assert isinstance(got, int) and got == int(getattr(jida, getter)())


@pytest.mark.parametrize("getter", FLOAT_GETTERS)
def test_ida_float_getters_match_the_jax_object(both_at_first_root, getter):
    jida, tida, _ = both_at_first_root
    got = getattr(tida, getter)()
    assert isinstance(got, float)
    np.testing.assert_allclose(got, float(getattr(jida, getter)()), rtol=1e-9, atol=0)


def test_ida_vector_getters_match_the_jax_object(both_at_first_root):
    jida, tida, _ = both_at_first_root
    for name in ("get_yy", "get_yp"):
        got = getattr(tida, name)()
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, np.asarray(getattr(jida, name)()), rtol=1e-9, atol=0)
    t = tida.get_current_time() - 0.3 * tida.get_last_step()
    for a, b in zip(tida.get_solution(t), jida.get_solution(t)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=0)
    for k in range(tida.get_last_order() + 1):
        np.testing.assert_allclose(tida.get_dky(t, k), np.asarray(jida.get_dky(t, k)), rtol=1e-8, atol=0)
    assert np.array_equal(tida.get_dky(t, 0), tida.get_solution(t)[0])


def test_get_dky_and_get_solution_refuse_bad_arguments(both_at_first_root):
    _, tida, _ = both_at_first_root
    with pytest.raises(port.IdaError) as e:
        tida.get_dky(tida.get_current_time(), tida.get_last_order() + 1)
    assert e.value.code == C.BAD_K and e.value.name == "BAD_K"
    with pytest.raises(port.IdaError) as e:
        tida.get_dky(tida.get_current_time(), -1)
    assert e.value.code == C.BAD_K
    far = tida.get_current_time() - 10.0 * tida.get_last_step()
    for call in (lambda: tida.get_dky(far, 0), lambda: tida.get_solution(far)):
        with pytest.raises(port.IdaError) as e:
            call()
        assert e.value.code == C.BAD_T and e.value.t == far


# ----------------------------------------------------------- IDA, port alone


def test_exports_carry_the_jax_names():
    for name in ida_tpu.__all__:
        assert hasattr(port, name), name
    assert [t.name for t in port.IdaTask] == [t.name for t in ida_tpu.IdaTask]
    assert {s.name: s.value for s in port.IdaSolveStatus} == {
        s.name: s.value for s in ida_tpu.IdaSolveStatus}
    for name in ("solve_dense", "DenseEvents"):
        assert hasattr(port, name)
    from ida_tpu_torch.core import interp, root

    assert all(hasattr(root, n) for n in ("r_check1", "r_check2", "r_check3"))
    assert hasattr(interp, "get_dky")


def test_entry_points_default_to_the_card():
    args = (roberts_problem(device="cpu"), ROBERTS_YY0, ROBERTS_YP0,
            port.tol_sv(1e-4, ATOL, device="cpu"))
    if torch.cuda.is_available():
        assert port.IDA(*args).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.IDA(*args)
    params, yy0, yp0 = _ensemble_inputs(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnsembleIDA(roberts_factory, params, yy0, yp0, args[3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.solve_dae(args[0].res, (0.0, 1.0), ROBERTS_YY0, ROBERTS_YP0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roberts_problem()


def test_one_step_task_and_tstop():
    ida = _ida(with_roots=False)
    ida.set_stop_time(0.01)
    t_prev, n = 0.0, 0
    while True:
        tret, status = ida.solve(1.0, port.IdaTask.OneStep)
        n += 1
        assert tret > t_prev
        t_prev = tret
        if status == port.IdaSolveStatus.TStop:
            break
        assert status == port.IdaSolveStatus.Success and ida.get_num_steps() == n
    assert tret == 0.01 and abs(ida.get_current_time() - 0.01) < 1e-15
    ida.clear_stop_time()
    assert ida.solve(0.02)[1] == port.IdaSolveStatus.Success
    ida.set_stop_time(0.001)  # behind the current time
    with pytest.raises(port.IdaError) as e:
        ida.solve(1.0)
    assert e.value.code == C.ILL_INPUT


def test_step_setters():
    ida = _ida(with_roots=False)
    ida.set_initial_step(1.0e-6)
    ida.set_max_step(0.003)
    ida.set_epcon(0.2)
    ida.solve(0.1)
    assert ida.get_actual_init_step() == 1.0e-6
    assert 0.0 < ida.get_last_step() <= 0.003 and ida.get_current_step() <= 0.003
    assert float(ida.state.epcon) == 0.2 and float(ida.state.eps_newt) == 0.2
    free = _ida(with_roots=False)
    free.solve(0.1)
    assert free.get_num_steps() < ida.get_num_steps()
    ida.set_max_step(0)
    assert float(ida.state.hmax_inv) == 0.0


def test_root_direction_filters_events():
    ida = _ida()
    ida.set_root_direction([0, -1])  # g1 only when falling: its rising crossing is ignored
    assert ida.solve(0.4) == (0.4, port.IdaSolveStatus.Success)
    assert ida.state.rootdir.tolist() == [0, -1] and ida.state.rootdir.dtype == torch.int32


def test_reinit_follows_ida_tpu():
    """Counters, history and time reset; roots active again at the new t0;
    the sign convention (+1 rising) and the per-lane settings survive."""
    ida = _ida()
    ida.set_root_direction([0, 1])
    ida.set_max_step(0.05)
    first = ida.solve(0.4)
    assert first[1] == port.IdaSolveStatus.Root and ida.get_root_info().tolist() == [0, 1]
    ida.solve(0.4)
    ida.set_stop_time(5.0)
    ida.reinit(ROBERTS_YY0, ROBERTS_YP0, t0=2.0)
    st = ida.state
    assert ida.get_num_steps() == 0 and ida.get_num_g_evals() == 0 and ida.get_current_time() == 2.0
    assert float(st.tlo) == 2.0 and bool(st.gactive.all()) and not bool(st.irfnd)
    assert st.rootdir.tolist() == [0, 1] and float(st.hmax_inv) == 20.0
    assert bool(st.tstop_set) and float(st.tstop) == 5.0
    again = ida.solve(2.4)
    assert again[1] == port.IdaSolveStatus.Root and ida.get_root_info().tolist() == [0, 1]
    np.testing.assert_allclose(again[0] - 2.0, first[0], rtol=1e-9)  # autonomous: shifted by t0
    assert ida.solve(2.4) == (2.4, port.IdaSolveStatus.Success)
    assert ida.solve(9.0) == (5.0, port.IdaSolveStatus.TStop)  # the clamp lands on tstop


def test_nonzero_t0_and_backward_integration():
    ida = _ida(with_roots=False, t0=3.0)
    assert ida.get_current_time() == 3.0 and float(ida.state.tlo) == 3.0
    tret, status = ida.solve(2.9)  # decreasing t
    assert status == port.IdaSolveStatus.Success and tret == 2.9
    assert ida.get_last_step() < 0.0


def test_failures_raise_ida_error():
    ida = _ida(port.IdaOptions(mxstep=5), with_roots=False)
    with pytest.raises(port.IdaError) as e:
        ida.solve(0.4)
    assert e.value.code == C.TOO_MUCH_WORK and e.value.name == "TOO_MUCH_WORK"
    assert e.value.t == ida.get_current_time() and "TOO_MUCH_WORK at t = " in str(e.value)
    assert ida.get_num_steps() == 5
    with pytest.raises(port.IdaError) as e:
        _ida(with_roots=False).solve(0.0)  # tout == t0
    assert e.value.code == C.ILL_INPUT


def test_poor_performance_monitor_warns():
    ida = _ida(with_roots=False)
    with pytest.warns(RuntimeWarning, match="nonlinear convergence failure rate is 1.00"):
        ida._ls_perf((10, 20, 10, 0, 0), 1.5)
    with pytest.warns(RuntimeWarning, match="linear convergence failure rate"):
        ida._ls_perf((20, 40, 10, 0, 19), 2.5)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ida.solve(0.01)  # a healthy call stays silent (and re-bases the counters)
    assert ida._perf0[0] == ida.get_num_steps()


def test_solve_grid_forms_agree():
    touts = [0.1, 0.4, 4.0, 40.0]
    fused = _ida(with_roots=False).solve_grid(touts)
    scan = _ida(with_roots=False).solve_grid(touts, fused=False)
    through_roots = _ida().solve_grid(touts)  # roots on: the scan form, re-entered
    for a, b, c in zip(fused, scan, through_roots):
        assert isinstance(a, np.ndarray) and np.array_equal(a, b) and np.array_equal(a, c)
    assert fused[0].tolist() == touts and fused[1].tolist() == [C.SUCCESS] * 4
    assert fused[2].shape == fused[3].shape == (4, 3)
    ida = _ida()
    out = ida.solve_grid(touts, max_events=2)
    assert all(np.array_equal(a, b) for a, b in zip(out[:4], fused))
    ev = out[4]
    assert isinstance(ev, port.DenseEvents) and isinstance(ev.t, np.ndarray)
    assert int(ev.count) == 1 and ev.iroots[0].tolist() == [0, 1] and 0.26 < ev.t[0] < 0.27
    assert ida.get_num_steps() == 68
    with pytest.raises(ValueError, match="cannot record events"):
        _ida().solve_grid(touts, fused=False, max_events=2)


def test_f32_in_gives_f32_out():
    ida = ida_from_numpy(roberts_problem(device="cpu"), ROBERTS_YY0.astype(np.float32),
                         ROBERTS_YP0.astype(np.float32),
                         {"rtol": np.float32(1e-3), "atol": (ATOL * 10).astype(np.float32)},
                         device="cpu")
    tret, status = ida.solve(0.4)
    assert status == port.IdaSolveStatus.Root and ida.get_yy().dtype == np.float32
    for f in ida.state._fields:
        x = getattr(ida.state, f)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            assert x.dtype == torch.float32, f
    assert _ida().state.dtype == torch.float64  # float64 unless told otherwise


@pytest.mark.parametrize(
    "call, match",
    [
        (lambda ida: ida.set_constraints([1.0, 1.0, 1.0]), "enable_constraints"),
        (lambda ida: ida.get_quad(), "no quadratures"),
    ],
    ids=["set_constraints", "get_quad"],
)
def test_unported_ida_features_name_their_roadmap_item(call, match):
    # both features are ported now (ROADMAP.md Queue 1, done); what is left
    # of the case is each one's own refusal, as ida_tpu words it: constraints
    # on a solver built without the block, quadratures of a problem with none
    with pytest.raises(ValueError, match=match):
        call(_ida(options=port.IdaOptions(enable_constraints=False)))


def test_quadratures_are_refused_at_the_problem():
    # quadratures are ported: a quad function is taken, a size without one
    # is refused (ida_tpu's check)
    assert port.IdaProblem(n=1, res=lambda t, y, yp: yp, quad=lambda t, y, yp: y,
                           nquad=1).nquad == 1
    with pytest.raises(ValueError, match="requires a quad function"):
        port.IdaProblem(n=1, res=lambda t, y, yp: yp, nquad=1)


# ------------------------------------------------------------------ solve_dae


def _dae(**kw):
    prob = roberts_problem(device="cpu")
    args = dict(rtol=1e-4, atol=ATOL, jac=prob.jac, device="cpu")
    args.update(kw)
    return port.solve_dae(prob.res, args.pop("t_span", (0.0, 40.0)), ROBERTS_YY0,
                          args.pop("yp0", ROBERTS_YP0), **args)


def test_solve_dae_equals_the_driven_object_and_has_the_jax_result_type():
    """``solve_dae`` with events is the ``IDA`` loop it wraps (the JAX ``IDA``
    is held against the port's above), and its result has the JAX
    ``DAESolution``'s fields and stats."""
    import dataclasses

    got = _dae(t_eval=[0.4, 4.0, 40.0], roots=roberts_problem(device="cpu").root)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(ida_tpu.DAESolution)]
    assert list(got.stats) == ["nst", "nre", "nje", "nni", "netf", "ncfn", "nge", "last_order",
                               "last_step"]
    ida = _ida()
    rows, events = [], []
    for tout in (0.4, 4.0, 40.0):
        while True:
            tret, status = ida.solve(tout)
            if status != port.IdaSolveStatus.Root:
                break
            events.append((tret, ida.get_yy()))
        rows.append((tret, ida.get_yy(), ida.get_yp()))
    assert got.success and got.message.startswith("The solver successfully reached the end")
    assert got.status.tolist() == [0, 0, 0] and got.status.dtype == np.int32
    assert got.t.tolist() == [r[0] for r in rows] == [0.4, 4.0, 40.0]
    assert np.array_equal(got.y, np.stack([r[1] for r in rows]))
    assert np.array_equal(got.yp, np.stack([r[2] for r in rows]))
    assert got.t_events.tolist() == [e[0] for e in events] and len(events) == 1
    assert np.array_equal(got.y_events, np.stack([e[1] for e in events]))
    assert got.stats["nst"] == ida.get_num_steps() == 68
    assert got.stats["nge"] == ida.get_num_g_evals() and got.stats["last_order"] == ida.get_last_order()
    assert got.stats["last_step"] == ida.get_last_step()
    np.testing.assert_allclose(got.y_events[0, 2], 0.01, rtol=1e-10)  # on the g1 surface


def test_solve_dae_backward_and_f32():
    # y' = -y backward from t = 1 to 0, then in float32
    res = lambda t, y, yp: yp + y  # noqa: E731
    y1 = np.exp(-1.0)
    sol = port.solve_dae(res, (1.0, 0.0), [y1], [-y1], t_eval=[0.5, 0.0], rtol=1e-8, atol=1e-10,
                         device="cpu")
    assert sol.success and sol.t.tolist() == [0.5, 0.0]
    np.testing.assert_allclose(sol.y[:, 0], np.exp([-0.5, 0.0]), rtol=1e-6)
    assert sol.stats["last_step"] < 0.0
    f32 = port.solve_dae(res, (0.0, 1.0), [1.0], [-1.0], rtol=1e-4, atol=1e-6, dtype=torch.float32,
                         device="cpu")
    assert f32.success and f32.y.dtype == np.float32 and f32.yp.dtype == np.float32
    np.testing.assert_allclose(f32.y[0, 0], np.exp(-1.0), rtol=1e-3)


@pytest.mark.parametrize("roots", [False, True], ids=["grid", "events"])
def test_solve_dae_reports_failure_instead_of_raising(roots):
    kw = {"roots": roberts_problem(device="cpu").root} if roots else {}
    sol = _dae(t_eval=[0.4, 4.0], options=port.IdaOptions(mxstep=20), **kw)
    assert not sol.success and sol.message == "Solver failure: TOO_MUCH_WORK"
    assert sol.status[0] == C.TOO_MUCH_WORK and sol.stats["nst"] >= 20
    if roots:
        assert len(sol.status) == 1  # the event-driven loop stops at the first failure


def test_solve_dae_argument_checks():
    with pytest.raises(ValueError, match="t_eval"):
        _dae(t_eval=[])
    with pytest.raises(ValueError, match="t_eval"):
        _dae(t_eval=[[0.4, 4.0]])
    one = port.solve_dae(lambda t, y, yp: yp + y, (0.0, 0.1), [1.0], [-1.0], device="cpu",
                         roots=lambda t, y, yp: y[0] - 0.95)  # a scalar root function
    assert one.success and one.t_events.shape == (1,)
    np.testing.assert_allclose(one.t_events[0], -np.log(0.95), rtol=1e-4)


# ---------------------------------------------------------------- EnsembleIDA


@pytest.fixture(scope="module")
def ensembles():
    """The JAX ``EnsembleIDA`` and the port's on the same B = 4 arrays, roots
    on, after the call that returns every lane's first root."""
    params, yy0, yp0 = _ensemble_inputs(4)
    jens = JEnsembleIDA(lambda p: jroberts(p, with_roots=True), jnp.asarray(params), yy0, yp0,
                        jtol_sv(1e-4, jnp.asarray(ATOL)))
    tens = ensemble_from_numpy(rooted_factory, params, yy0, yp0, TOL, device="cpu")
    return jens, tens, jens.solve(0.4), tens.solve(0.4)


def test_ensemble_report_and_format_failures():
    params, yy0, yp0 = _ensemble_inputs(3)
    ens = ensemble_from_numpy(roberts_factory, params, yy0, yp0, TOL, device="cpu",
                              options=port.IdaOptions(mxstep=5))
    _, ist = ens.solve(400.0)
    assert ens.status_names(ist) == ["TOO_MUCH_WORK"] * 3
    rows = ens.report_failures(ist)
    assert [r["lane"] for r in rows] == [0, 1, 2]
    assert set(rows[0]) == {"lane", "status", "status_name", "t", "nst", "hh", "hused", "kused",
                            "ncfn", "netf"}
    st = ens.states
    for r in rows:
        i = r["lane"]
        assert r["status"] == C.TOO_MUCH_WORK and r["status_name"] == "TOO_MUCH_WORK"
        assert r["nst"] == 5 and isinstance(r["nst"], int) and isinstance(r["t"], float)
        assert r["t"] == float(st.tn[i]) and r["hh"] == float(st.hh[i])
        assert r["hused"] == float(st.hused[i]) and r["kused"] == int(st.kused[i])
    assert ens.report_failures() == rows  # the statuses stored in the states
    # one failed lane among healthy ones
    mixed = np.array([C.SUCCESS, C.CONV_FAIL, C.SUCCESS])
    assert [r["lane"] for r in ens.report_failures(mixed)] == [1]
    lines = ens.format_failures(ist).splitlines()
    assert len(lines) == 3
    assert lines[2].startswith("lane 2: TOO_MUCH_WORK at t=") and "nst=5" in lines[2]


def test_ensemble_solve_grid_forms_and_grids():
    params, yy0, yp0 = _ensemble_inputs(3)
    touts = [0.1, 0.4, 4.0]
    new = lambda fac: ensemble_from_numpy(fac, params, yy0, yp0, TOL, device="cpu")  # noqa: E731
    fused = new(roberts_factory).solve_grid(touts)
    scan = new(roberts_factory).solve_grid(touts, fused=False)
    rooted_scan = new(rooted_factory).solve_grid(touts)  # roots on, no buffer: the scan form
    ens = new(rooted_factory)
    dense = ens.solve_grid(touts, max_events=2)
    for k in range(4):
        assert fused[k].shape == ((3, 3) if k < 2 else (3, 3, 3))
        for other in (scan, rooted_scan, dense):
            assert np.array_equal(fused[k], other[k]), k
    assert fused[1].dtype == np.int32 and (fused[1] == C.SUCCESS).all()
    ev = dense[4]
    assert ev.t.shape == (3, 2) and ev.iroots.shape == (3, 2, 2) and ev.yy.shape == (3, 2, 3)
    assert ev.count.tolist() == [1, 1, 1] and ev.iroots[:, 0].tolist() == [[0, 1]] * 3
    plain = new(roberts_factory)
    plain.solve_grid(touts)
    assert np.array_equal(ens.nst, plain.nst)  # events do not change a step
    # per-lane grids [T, B]
    grid = np.outer(touts, [1.0, 0.5, 2.0])
    per_lane = new(roberts_factory).solve_grid(grid)
    per_lane_scan = new(roberts_factory).solve_grid(grid, fused=False)
    assert np.array_equal(per_lane[0], grid)
    for a, b in zip(per_lane, per_lane_scan):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="cannot record events"):
        new(rooted_factory).solve_grid(touts, fused=False, max_events=1)


def test_ensemble_f32_stays_f32():
    params, yy0, yp0 = _ensemble_inputs(2)
    ens = ensemble_from_numpy(roberts_factory, params.astype(np.float32), yy0.astype(np.float32),
                              yp0.astype(np.float32),
                              {"rtol": np.float32(1e-3), "atol": (ATOL * 10).astype(np.float32)},
                              device="cpu")
    tret, ist = ens.solve(0.4)
    assert tret.dtype == np.float32 and ens.yy.dtype == np.float32 and ist.tolist() == [0, 0]
