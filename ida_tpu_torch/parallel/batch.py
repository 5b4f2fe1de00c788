"""Ensemble (batch) integration: many independent DAE instances in lockstep.

Port of ``ida_tpu/parallel/batch.py``'s ``ensemble_init``,
``make_ensemble_solve``, ``EnsembleIDA`` and the stratified solve
(``make_stratified_solve``, ``pilot_cost``). The public layout is the JAX package's: states,
params and results are batch-LEADING. Inside, one batch-native solve runs
over states whose batch axis is TRAILING (the layout of
``bench.py::_native_setup``), which also makes the LU kernel's loads
coalesced. Per-lane parameters reach the residual through a
``problem_factory(params)`` that receives batch-last params [P, B].
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .. import constants as C
from ..core.calc_ic import IC_CODES
from ..core.calc_ic import calc_ic as core_calc_ic
from ..core.solve import TASK_NORMAL, TASK_ONE_STEP, solve, solve_dense
from ..core.state import IdaOptions, IdaState, init_state
from ..problem import IdaProblem
from ..tol_control import TolControl
from ..utils.device import resolve_device
from ..utils.tree import masked_while_loop
from . import mesh as _mesh

ProblemFactory = Callable[[Any], IdaProblem]


def _move_batch(states: IdaState, src: int, dst: int) -> IdaState:
    return _mesh.map_tensors(states, lambda x: x.movedim(src, dst).contiguous())


def to_native(states: IdaState) -> IdaState:
    """Batch-leading -> batch-native (batch axis last, contiguous)."""
    return _move_batch(states, 0, -1)


def from_native(states: IdaState) -> IdaState:
    """Batch-native -> batch-leading."""
    return _move_batch(states, -1, 0)


def ensemble_init(
    problem_factory: ProblemFactory,
    params,
    yy0,
    yp0,
    *,
    device=None,
    dtype: torch.dtype = torch.float64,
    opts: IdaOptions = IdaOptions(),
) -> IdaState:
    """Batch-leading IdaState for ``params`` [B, P], ``yy0``/``yp0`` [B, N]
    (the JAX package's vmap of ``init_state``; ``opts`` sizes the linear
    solver's workspace). ``device`` None is the current CUDA device (raises
    when there is none)."""
    device = resolve_device(device)
    params = torch.as_tensor(params, dtype=dtype, device=device)
    problem = problem_factory(params.t())
    return init_state(problem, yy0, yp0, device=device, dtype=dtype, opts=opts)


def make_ensemble_solve(
    problem_factory: ProblemFactory,
    opts: IdaOptions = IdaOptions(),
    itask: int = TASK_NORMAL,
):
    """Build ``fn(states, params, tol, tout) -> (states, tret[B], istate[B])``
    over batch-leading states and params [B, P]. ``tol`` is shared by every
    lane (scalar rtol, scalar or [N] atol); ``tout`` is a number."""

    def fn(states: IdaState, params, tol: TolControl, tout):
        native = to_native(states)
        dtype, dev = native.dtype, native.phi.device
        p = torch.as_tensor(params, dtype=dtype, device=dev).t().contiguous()
        tol_native = _native_shared_tol(tol, native)
        st, tret, istate = solve(native, problem_factory(p), opts, tol_native, tout, itask)
        return from_native(st), tret, istate

    return fn


def _native_shared_tol(tol: TolControl, native: IdaState) -> TolControl:
    """A tolerance shared by every lane (scalar rtol, scalar or [N] atol) as
    the batch-native core takes it: rtol [B], atol [N, B] (views)."""
    dtype, dev = native.dtype, native.phi.device
    n, bsz = native.yy.shape
    rtol = torch.as_tensor(tol.rtol, dtype=dtype, device=dev)
    atol = torch.as_tensor(tol.atol, dtype=dtype, device=dev)
    return TolControl(
        rtol=rtol.expand(bsz),
        atol=(atol.reshape(-1, 1) if atol.dim() else atol).expand(n, bsz),
    )


class EnsembleIDA:
    """Stateful convenience wrapper over the batch-native solver (host side).

    Port of ``ida_tpu.parallel.EnsembleIDA``: drives a [B]-batch and exposes
    per-lane statuses instead of exceptions (for a single instance prefer
    :class:`ida_tpu_torch.IDA`). ``params`` [B, P], ``yy0``/``yp0`` [B, N]
    and ``tol`` (shared by every lane) are as the JAX class takes them;
    results come back as numpy arrays, batch-leading. The problem is built
    once, from the batch-last params, and the state is kept batch-native on
    the device between calls (``states`` gives the batch-leading view).
    ``device`` None is the current CUDA device.

    ``mesh`` (:func:`ida_tpu_torch.parallel.make_mesh`): the lanes are split
    over the mesh's first axis, data parallelism over ranks. Every rank
    constructs the class with the same full inputs (SPMD, one process a
    device) and keeps its contiguous share of the lanes on its device
    (``mesh_device``); the batch must divide by the axis' size. Each rank's
    solve runs its own lanes until they finish, with no collective; the
    results, ``states`` and the other getters then gather the whole batch,
    so every rank gets what the same call without a mesh returns."""

    def __init__(
        self,
        problem_factory: ProblemFactory,
        params: Any,
        yy0,
        yp0,
        tol: TolControl,
        options: IdaOptions = IdaOptions(),
        *,
        dtype: torch.dtype = torch.float64,
        device=None,
        mesh=None,
    ):
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else _mesh.mesh_device(mesh)
        self.factory = problem_factory
        self.options = options
        self.params = torch.as_tensor(params, dtype=dtype, device=self.device)
        yy0 = torch.as_tensor(yy0, dtype=dtype, device=self.device)
        yp0 = torch.as_tensor(yp0, dtype=dtype, device=self.device)
        if mesh is not None:
            self._axis = mesh.mesh_dim_names[0]
            self.params, yy0, yp0 = _mesh.shard_ensemble((self.params, yy0, yp0), mesh, self._axis)
        self.problem = problem_factory(self.params.t().contiguous())
        self._native = to_native(init_state(self.problem, yy0, yp0, device=self.device,
                                            dtype=dtype, opts=options))
        self.tol = tol
        self._tol_native = _native_shared_tol(tol, self._native)

    def _whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``, whose ``dim`` runs over this rank's lanes, over all lanes."""
        return x if self.mesh is None else _mesh.gather(x, self.mesh, self._axis, dim)

    @property
    def states(self) -> IdaState:
        """The batch-leading IdaState (a copy in that layout; every lane's
        under a mesh)."""
        return from_native(_mesh.map_tensors(self._native, lambda x: self._whole(x, -1)))

    def solve(self, tout: float, one_step: bool = False):
        """Advance every lane toward ``tout`` (or by one internal step each
        with ``one_step``). Returns (tret[B], istate[B]) as numpy arrays;
        lane failures are status codes, not exceptions."""
        itask = TASK_ONE_STEP if one_step else TASK_NORMAL
        self._native, tret, istate = solve(
            self._native, self.problem, self.options, self._tol_native, tout, itask
        )
        return self._whole(tret, 0).cpu().numpy(), self._whole(istate, 0).cpu().numpy()

    def solve_grid(self, touts, fused: bool | None = None, max_events: int = 0):
        """Dense trajectory output for the whole ensemble: sweep a monotone
        time grid (see ``IDA.solve_grid``). ``touts`` is [T] (shared grid) or
        [T, B] (per-lane grids). Returns numpy ``(tret [T, B], istate [T, B],
        yy [T, B, N], yp [T, B, N])``.

        ``fused=None`` selects the dense-output form
        (``core.solve.solve_dense``) when the problem has no roots, or when
        it has roots AND ``max_events > 0``; then the return gains a
        trailing per-lane :class:`~ida_tpu_torch.core.solve.DenseEvents`
        (leading axis B) holding every root crossing in the swept span.
        Lanes advance through their rows independently instead of waiting
        for the whole batch at every row; row values are bit for bit the
        same either way."""
        nroots = self.problem.nroots
        if fused is None:
            fused = nroots == 0 or max_events > 0
        if max_events > 0 and not fused:
            raise ValueError(
                "solve_grid: the scan form (fused=False) cannot record events; drop "
                "fused=False, or use solve() for ROOT_RETURN-driven stepping"
            )
        st = self._native
        touts = torch.as_tensor(touts, dtype=st.dtype, device=self.device)

        if touts.dim() == 2 and self.mesh is not None:
            touts = _mesh.shard_ensemble(touts.t(), self.mesh, self._axis).t()

        def lead(x):  # [T, (N,) B] -> numpy [T, B(, N)]
            return self._whole(x.movedim(-1, 1), 1).cpu().numpy()

        if fused:
            out = solve_dense(st, self.problem, self.options, self._tol_native, touts,
                              max_events=max_events if nroots else 0)
            self._native = out[0]
            rows = tuple(lead(x) for x in out[1:5])
            if nroots:
                # events keep a leading B (per-lane buffers)
                return rows + (type(out[6])(*(self._whole(x.movedim(-1, 0), 0).cpu().numpy()
                                              for x in out[6])),)
            return rows

        rows = []
        for k in range(touts.shape[0]):
            tout = touts[k]
            st, tret, ist = solve(st, self.problem, self.options, self._tol_native, tout)
            # continue lanes stopped at a root crossing (per-lane masked;
            # finished lanes freeze): dense output samples the grid, it does
            # not stop at events
            st, tret, ist = masked_while_loop(
                lambda c: c[2] == C.ROOT_RETURN,
                lambda c: solve(c[0], self.problem, self.options, self._tol_native, tout),
                (st, tret, ist),
            )
            rows.append((tret, ist, st.yy, st.yp))
        self._native = st
        return tuple(lead(torch.stack([r[j] for r in rows])) for j in range(4))

    def calc_ic(self, icopt: str, tout1: float):
        """Per-lane consistent initial conditions (IDACalcIC on every lane
        at once). ``icopt`` is "ya_ydp" or "y". Returns a numpy bool [B]
        success mask; a lane that fails keeps its guesses."""
        self._native, ok = core_calc_ic(
            self._native, self.problem, self.options, self._tol_native, IC_CODES[icopt],
            torch.as_tensor(tout1, dtype=self._native.dtype, device=self.device),
        )
        return self._whole(ok, 0).cpu().numpy()

    @property
    def yy(self):
        return self._whole(self._native.yy.t(), 0).cpu().numpy()

    @property
    def nst(self):
        return self._whole(self._native.nst, 0).cpu().numpy()

    def status_names(self, istate) -> list[str]:
        return [C.STATUS_NAMES.get(int(s), str(int(s))) for s in istate]

    def report_failures(self, istate=None) -> list[dict]:
        """Host-side decode of failed lanes: which lane failed, why, at what
        t, after how many steps. Pass the ``istate`` array returned by
        :meth:`solve`, or omit it to use the statuses stored in the states.

        Returns one dict per failed lane:
        ``{lane, status, status_name, t, nst, hh, hused, kused, ncfn, netf}``.
        The fields come off the device in one transfer."""
        st = self._native
        dt = torch.float64  # holds the int32 fields and counters below 2**53 exactly
        table = self._whole(torch.stack(
            [x.to(dt) for x in (st.status, st.tn, st.nst, st.hh, st.hused, st.kused, st.ncfn,
                                st.netf)]
        ), 1).cpu().numpy()
        status = table[0].astype(np.int64) if istate is None else np.asarray(istate)
        tn, nst, hh, hused, kused, ncfn, netf = table[1:]
        return [
            {
                "lane": int(i),
                "status": int(status[i]),
                "status_name": C.STATUS_NAMES.get(int(status[i]), str(int(status[i]))),
                "t": float(tn[i]),
                "nst": int(nst[i]),
                "hh": float(hh[i]),
                "hused": float(hused[i]),
                "kused": int(kused[i]),
                "ncfn": int(ncfn[i]),
                "netf": int(netf[i]),
            }
            for i in np.nonzero(status < 0)[0]
        ]

    def format_failures(self, istate=None) -> str:
        """Readable multi-line report of :meth:`report_failures` (empty
        string when every lane is healthy)."""
        return "\n".join(
            f"lane {r['lane']}: {r['status_name']} at t={r['t']:.6e} "
            f"(nst={r['nst']}, h={r['hh']:.3e}, last h={r['hused']:.3e}, "
            f"k={r['kused']}, ncfn={r['ncfn']}, netf={r['netf']})"
            for r in self.report_failures(istate)
        )


# ----------------------------------------------------------------------
# Straggler control: the stratified (sorted sub-batch) ensemble solve
# ----------------------------------------------------------------------


def make_stratified_solve(
    problem_factory: ProblemFactory,
    opts: IdaOptions = IdaOptions(),
    *,
    n_chunks: int = 4,
):
    """Build ``fn(states, params, tol, tout, cost_key) -> (states, tret[B],
    istate[B])`` (``ida_tpu``'s ``make_stratified_solve``): the lanes are
    sorted by ``cost_key`` [B] (any per-lane cost proxy, e.g. the step
    counts of :func:`pilot_cost`; a stable sort), ``n_chunks`` contiguous
    sub-batches of similar cost are solved one after another through
    :func:`make_ensemble_solve`, so that each runs only as long as its own
    slowest lane, and the results come back in the original lane order.
    States and params are batch-leading as in ``make_ensemble_solve``, and
    ``tol`` is shared by every lane. B must be divisible by ``n_chunks``.
    The eager solve is lane-independent, so every lane's result is the plain
    solve's bit for bit; whether the chunks save time depends on how much a
    lockstep batch pays for its idle lanes (one kernel thread a lane on the
    card)."""
    base = make_ensemble_solve(problem_factory, opts)

    def fn(states: IdaState, params, tol: TolControl, tout, cost_key):
        b = states.tn.shape[0]
        if b % n_chunks:
            raise ValueError(f"batch {b} is not divisible into {n_chunks} chunks")
        dev = states.tn.device
        order = torch.argsort(torch.as_tensor(cost_key, device=dev), stable=True)
        inv = torch.argsort(order)
        params = torch.as_tensor(params, dtype=states.dtype, device=dev)

        def take(x, idx):
            if isinstance(x, torch.Tensor):
                return x.index_select(0, idx)
            return tuple(take(y, idx) for y in x)  # pdata

        states_s, params_s = IdaState(*(take(x, order) for x in states)), params[order]
        csz = b // n_chunks
        outs = [base(IdaState(*(take(x, torch.arange(c * csz, (c + 1) * csz, device=dev))
                                for x in states_s)),
                     params_s[c * csz:(c + 1) * csz], tol, tout)
                for c in range(n_chunks)]

        def cat(*xs):
            if isinstance(xs[0], torch.Tensor):
                return torch.cat(xs)
            return tuple(cat(*ys) for ys in zip(*xs))

        st = IdaState(*(take(cat(*fs), inv) for fs in zip(*(o[0] for o in outs))))
        return st, torch.cat([o[1] for o in outs])[inv], torch.cat([o[2] for o in outs])[inv]

    return fn


def pilot_cost(
    problem_factory: ProblemFactory,
    states: IdaState,
    params,
    tol: TolControl,
    tout_pilot,
    opts: IdaOptions = IdaOptions(),
) -> torch.Tensor:
    """A cheap per-lane cost key for :func:`make_stratified_solve`: each
    lane's step count after a solve to the short horizon ``tout_pilot``
    (early stiffness predicts the total cost of Roberts-class kinetics).
    Solves a copy: ``states`` is not changed."""
    st, _, _ = make_ensemble_solve(problem_factory, opts)(states, params, tol, tout_pilot)
    return st.nst
