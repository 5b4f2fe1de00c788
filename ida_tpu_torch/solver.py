"""User-facing solver API (host side).

Port of ``ida_tpu/solver.py``. Mirrors the reference public surface:
``Ida::new`` (src/lib.rs:278), ``Ida::solve`` (src/impl_solve.rs:69),
``get_dky`` (src/lib.rs:424), ``get_solution`` (src/lib.rs:1274) and the
statistics getters (src/ida_io.rs:10-118), plus the option setters the
reference lacks.

The class is a thin stateful shell: all numerics happen in the functional
core (``ida_tpu_torch.core``) on tensors of the chosen device (the current
CUDA device unless ``device="cpu"`` is asked for); the shell holds the
current ``IdaState``, decodes statuses into Python enums and exceptions, and
hands results back as Python numbers and numpy arrays. Each ``solve`` call
reads what it needs from the device in ONE transfer.
"""

from __future__ import annotations

import enum
import warnings

import torch

from . import constants as C
from .core import interp
from .core import quad as core_quad
from .core.calc_ic import IC_CODES
from .core.calc_ic import calc_ic as core_calc_ic
from .core.solve import TASK_NORMAL, TASK_ONE_STEP, solve_dense
from .core.solve import solve as core_solve
from .core.state import IdaOptions, init_state
from .problem import IdaProblem
from .tol_control import TolControl
from .utils.device import resolve_device


class IdaTask(enum.Enum):
    """reference src/lib.rs:52-55"""

    Normal = TASK_NORMAL
    OneStep = TASK_ONE_STEP


class IdaSolveStatus(enum.Enum):
    """reference src/lib.rs:57-63"""

    Success = C.SUCCESS
    TStop = C.TSTOP_RETURN
    Root = C.ROOT_RETURN


class IdaError(RuntimeError):
    """A failure status from the solver core (reference src/error.rs taxonomy)."""

    def __init__(self, code: int, t: float | None = None):
        self.code = int(code)
        self.t = t
        self.name = C.STATUS_NAMES.get(self.code, f"UNKNOWN({self.code})")
        msg = f"IDA failure {self.name}"
        if t is not None:
            msg += f" at t = {t:.6e}"
        super().__init__(msg)


class IDA:
    """Implicit DAE solver for ``F(t, y, y') = 0`` (single instance).

    For large ensembles use :class:`ida_tpu_torch.parallel.EnsembleIDA`
    instead of many ``IDA`` objects. ``yy0``/``yp0`` may be numpy arrays,
    lists or tensors; they and ``tol`` are moved to ``device`` (None: the
    current CUDA device) in ``dtype`` (float64 unless told otherwise).
    """

    def __init__(
        self,
        problem: IdaProblem,
        yy0,
        yp0,
        tol: TolControl,
        options: IdaOptions = IdaOptions(),
        *,
        t0: float = 0.0,
        dtype: torch.dtype = torch.float64,
        device=None,
    ):
        self.device = resolve_device(device)
        self.problem = problem
        self.options = options
        self.tol = TolControl(
            torch.as_tensor(tol.rtol, dtype=dtype, device=self.device),
            torch.as_tensor(tol.atol, dtype=dtype, device=self.device),
        )
        self.state = init_state(problem, yy0, yp0, device=self.device, dtype=dtype, opts=options)
        if t0 != 0.0:
            self.state = self.state._replace(tn=self._real(t0), tlo=self._real(t0))
        self._perf0 = (0, 0, 0, 0, 0)
        self._nwarn = 0

    def _real(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.state.dtype, device=self.device)

    def _flag(self, x: bool) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.bool, device=self.device)

    def reinit(self, yy0, yp0, t0: float = 0.0) -> None:
        """Reinitialize for a new problem instance of the same shape
        (C IDAReInit): resets history, counters and time (roots active
        again at t0), keeps options, tolerances and the per-lane settings."""
        st = self.state
        keep = dict(
            hin=st.hin, hmax_inv=st.hmax_inv, epcon=st.epcon, tstop=st.tstop,
            tstop_set=st.tstop_set, constraints=st.constraints,
            constraints_set=st.constraints_set, rootdir=st.rootdir,
        )
        self.state = init_state(self.problem, yy0, yp0, device=self.device, dtype=st.dtype,
                                opts=self.options)
        self.state = self.state._replace(tn=self._real(t0), tlo=self._real(t0), **keep)
        self._perf0 = (0, 0, 0, 0, 0)

    # ------------------------------------------------------------------
    # option setters (absent in the reference)
    # ------------------------------------------------------------------
    def set_initial_step(self, hin: float) -> None:
        self.state = self.state._replace(hin=self._real(hin))

    def set_max_step(self, hmax: float) -> None:
        self.state = self.state._replace(hmax_inv=self._real(0.0 if hmax == 0 else 1.0 / hmax))

    def set_stop_time(self, tstop: float) -> None:
        self.state = self.state._replace(tstop=self._real(tstop), tstop_set=self._flag(True))

    def clear_stop_time(self) -> None:
        self.state = self.state._replace(tstop_set=self._flag(False))

    def set_root_direction(self, rootdir) -> None:
        self.state = self.state._replace(
            rootdir=torch.as_tensor(rootdir, dtype=torch.int32, device=self.device).reshape(
                self.state.rootdir.shape
            )
        )

    def set_epcon(self, epcon: float) -> None:
        self.state = self.state._replace(epcon=self._real(epcon))

    def set_constraints(self, constraints) -> None:
        """Inequality constraints on y (C IDASetConstraints), one code per
        component: 2 => y > 0, 1 => y >= 0, -1 => y <= 0, -2 => y < 0, 0 =>
        none. Refused under ``IdaOptions(enable_constraints=False)``."""
        if not self.options.enable_constraints:
            raise ValueError(
                "IdaOptions(enable_constraints=False) leaves the constraints block out of the "
                "solver; build it with enable_constraints=True"
            )
        self.state = self.state._replace(
            constraints=self._real(constraints).reshape(self.state.constraints.shape),
            constraints_set=self._flag(True),
        )

    # ------------------------------------------------------------------
    # consistent initial conditions (C IDACalcIC)
    # ------------------------------------------------------------------
    def calc_ic(self, icopt: str, tout1: float) -> None:
        """Compute consistent initial conditions before the first solve.
        ``icopt`` is "ya_ydp" (the algebraic y and the differential y', which
        needs ``problem.id``) or "y" (all of y given y'). Raises
        :class:`IdaError` (CONV_FAIL) when it fails; the state is then left
        as it was."""
        state, ok = core_calc_ic(self.state, self.problem, self.options, self.tol,
                                 IC_CODES[icopt], self._real(tout1))
        if not bool(ok):
            raise IdaError(C.CONV_FAIL, t=float(self.state.tn))
        self.state = state

    def get_consistent_ic(self):
        """(y0, y'0) after calc_ic (C IDAGetConsistentIC), numpy [N] each."""
        return self.state.phi[0].cpu().numpy(), self.state.phi[1].cpu().numpy()

    # ------------------------------------------------------------------
    # main entry point (reference impl_solve.rs:69)
    # ------------------------------------------------------------------
    def solve(self, tout: float, itask: IdaTask = IdaTask.Normal):
        """Integrate toward ``tout``. Returns ``(tret, IdaSolveStatus)``;
        raises :class:`IdaError` on failure statuses."""
        state, tret, istate = core_solve(
            self.state, self.problem, self.options, self.tol, tout, itask.value
        )
        self.state = state
        # one transfer: the return values and the performance monitor's counters
        host = torch.stack(
            [x.to(torch.float64) for x in (tret, istate, state.nst, state.nni, state.ncfn,
                                           state.nli, state.ncfl, state.tn)]
        ).tolist()
        self._ls_perf(tuple(int(x) for x in host[2:7]), host[7])
        code = int(host[1])
        if code < 0:
            raise IdaError(code, t=host[0])
        return host[0], IdaSolveStatus(code)

    def solve_grid(self, touts, fused: bool | None = None, max_events: int = 0):
        """Dense trajectory output: integrate through every point of a
        monotone time grid, returning the interpolated solution at each.

        Two forms, bit for bit the same on success paths:

        * ``fused=True``: ``core.solve.solve_dense``, ONE loop that records
          each grid row the moment it is crossed. With roots, pass
          ``max_events`` (the event-buffer size) and the return gains a
          trailing :class:`~ida_tpu_torch.core.solve.DenseEvents` holding
          every root crossing in the swept span. ``tstop`` follows the scan
          form's semantics (TSTOP_RETURN row at t = tstop, later rows
          integrate past it).
        * ``fused=False``: one ``solve`` call per row. Root crossings do NOT
          stop the sweep: each grid point re-solves through ROOT_RETURNs
          until ``tout`` is reached (use :meth:`solve` when the events
          themselves are wanted).

        ``fused=None`` (default) picks the fused form whenever it applies
        (``max_events > 0`` makes it apply to problems with roots).

        Returns ``(tret [T], istate [T], yy [T, N], yp [T, N])`` as numpy
        arrays, plus ``DenseEvents`` (of numpy arrays) when the fused form
        runs with roots; per-point failures are status codes, not
        exceptions.
        """
        touts = torch.as_tensor(touts, dtype=self.state.dtype, device=self.device)
        nroots = self.problem.nroots
        if fused is None:
            fused = nroots == 0 or max_events > 0
        if max_events > 0 and not fused:
            raise ValueError(
                "solve_grid: the scan form (fused=False) cannot record events; drop "
                "fused=False, or use solve() for ROOT_RETURN-driven stepping"
            )

        if fused:
            out = solve_dense(self.state, self.problem, self.options, self.tol, touts,
                              max_events=max_events if nroots else 0)
            self.state = out[0]
            rows = tuple(x.cpu().numpy() for x in out[1:5])
            if nroots:
                return rows + (type(out[6])(*(x.cpu().numpy() for x in out[6])),)
            return rows

        rows = []
        st = self.state
        for k in range(touts.shape[0]):
            st, tret, ist = core_solve(st, self.problem, self.options, self.tol, touts[k])
            # continue through root crossings to the grid point
            while int(ist) == C.ROOT_RETURN:
                st, tret, ist = core_solve(st, self.problem, self.options, self.tol, touts[k])
            # on success state.yy/yp hold y(tret) (stop-test interpolation)
            rows.append((tret, ist, st.yy, st.yp))
        self.state = st
        return tuple(torch.stack([r[j] for r in rows]).cpu().numpy() for j in range(4))

    def _ls_perf(self, counters: tuple, tn: float) -> None:
        """Poor-performance monitor (reference idaLsPerf,
        src/ida_ls.rs:458-499): warn when the nonlinear or linear
        convergence failure rate since the last solve call exceeds 0.9.
        ``counters`` is (nst, nni, ncfn, nli, ncfl) after the call."""
        nst0, nni0, ncfn0, _, ncfl0 = self._perf0
        self._perf0 = counters
        nst, nni, ncfn, _, ncfl = counters
        nstd, nnid = nst - nst0, nni - nni0
        # each rate needs only its own denominator: a call whose every attempt
        # failed has nstd == 0, and the linear rate is still meaningful
        rcfn = (ncfn - ncfn0) / nstd if nstd > 0 else 0.0
        rcfl = (ncfl - ncfl0) / nnid if nnid > 0 else 0.0
        for rate, kind in ((rcfn, "nonlinear"), (rcfl, "linear")):
            if rate > 0.9 and self._nwarn <= 10:
                self._nwarn += 1
                warnings.warn(
                    f"ida_tpu_torch: at t = {tn:.6e}, poor iterative algorithm performance: "
                    f"{kind} convergence failure rate is {rate:.2f}.",
                    RuntimeWarning,
                )

    # ------------------------------------------------------------------
    # interpolated output
    # ------------------------------------------------------------------
    def get_solution(self, t: float):
        """y(t), y'(t) inside the last step (reference src/lib.rs:1274-1343)."""
        state, ok = interp.get_solution(self.state, self._real(t))
        if not bool(ok):
            raise IdaError(C.BAD_T, t=t)
        self.state = state
        return state.yy.cpu().numpy(), state.yp.cpu().numpy()

    def get_dky(self, t: float, k: int):
        """k-th derivative of the interpolating polynomial at t
        (reference src/lib.rs:424-529)."""
        if k < 0 or k > int(self.state.kused):
            raise IdaError(C.BAD_K)
        dky, ok = interp.get_dky(self.state, self._real(t), k)
        if not bool(ok):
            raise IdaError(C.BAD_T, t=t)
        return dky.cpu().numpy()

    # ------------------------------------------------------------------
    # observability getters (reference src/ida_io.rs:10-118)
    # ------------------------------------------------------------------
    def get_yy(self):
        return self.state.yy.cpu().numpy()

    def get_yp(self):
        return self.state.yp.cpu().numpy()

    def get_last_order(self) -> int:
        return int(self.state.kused)

    def get_current_order(self) -> int:
        return int(self.state.kk)

    def get_actual_init_step(self) -> float:
        return float(self.state.h0u)

    def get_last_step(self) -> float:
        return float(self.state.hused)

    def get_current_step(self) -> float:
        return float(self.state.hh)

    # drop-in alias for the reference's misspelled getter (ida_io.rs:42)
    get_current_setp = get_current_step

    def get_current_time(self) -> float:
        return float(self.state.tn)

    def get_tol_scale_factor(self) -> float:
        return float(self.state.tolsf)

    def get_num_steps(self) -> int:
        return int(self.state.nst)

    def get_num_res_evals(self) -> int:
        return int(self.state.nre)

    def get_num_lin_solv_setups(self) -> int:
        return int(self.state.nsetups)

    def get_num_err_test_fails(self) -> int:
        return int(self.state.netf)

    def get_num_jac_evals(self) -> int:
        return int(self.state.nje)

    def get_num_nonlin_solv_iters(self) -> int:
        return int(self.state.nni)

    def get_num_lin_res_evals(self) -> int:
        return 0  # the difference-quotient Jacobian is subsumed by AD: no extra res calls

    def get_num_lin_iters(self) -> int:
        return int(self.state.nli)

    def get_num_prec_solves(self) -> int:
        return int(self.state.nps)

    def get_num_lin_conv_fails(self) -> int:
        """Linear (Krylov) convergence failures (reference ida_ls.rs:52)."""
        return int(self.state.ncfl)

    def get_num_jtsetup_evals(self) -> int:
        """jtimes-setup calls (reference ida_ls.rs:56)."""
        return int(self.state.njtsetup)

    def get_num_jtimes_evals(self) -> int:
        """Jacobian-vector products (reference ida_ls.rs:58)."""
        return int(self.state.njtimes)

    def get_num_nonlin_solv_conv_fails(self) -> int:
        return int(self.state.ncfn)

    def get_num_g_evals(self) -> int:
        return int(self.state.nge)

    def get_root_info(self):
        return self.state.iroots.cpu().numpy()

    def get_quad(self, t: float | None = None):
        """The quadratures ``int q dt`` from t0 to ``t`` (default: the last
        return time), IDAS IDAGetQuad; needs ``problem.nquad > 0``. As for
        get_solution, ``t`` must lie within the last step. numpy [nquad]."""
        if self.problem.nquad == 0:
            raise ValueError("problem has no quadratures (nquad == 0)")
        st = self.state
        tt = st.tretlast if t is None else self._real(t)
        if not bool(interp.check_t_legal(st, tt)):
            raise IdaError(C.BAD_T, t=float(tt))
        return core_quad.get_quad(st, self.problem, tt).cpu().numpy()
