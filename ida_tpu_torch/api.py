"""One-call convenience API: ``solve_dae`` (SciPy ``solve_ivp`` idiom).

Port of ``ida_tpu/api.py``: wraps :class:`ida_tpu_torch.IDA` in a single
functional call for users arriving from SciPy/Assimulo-style interfaces.
Everything here is sugar: the object API remains the primary surface (and
the only one for ensembles, see :mod:`ida_tpu_torch.parallel`). The callables
take and return torch tensors on ``device`` (None: the current CUDA device).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import constants as C
from .core.state import IdaOptions
from .problem import IdaProblem
from .solver import IDA, IdaError, IdaSolveStatus
from .tol_control import TolControl
from .utils.device import resolve_device


@dataclasses.dataclass
class DAESolution:
    """Result of :func:`solve_dae`.

    Attributes:
      t: [T] output times actually reached (== requested grid on success).
      y, yp: [T, N] solution / derivative rows at ``t``.
      status: [T] integer status per output point (``constants.STATUS_NAMES``).
      success: True when every output point returned SUCCESS/TSTOP/ROOT.
      t_events, y_events: root-crossing times and states (only when the
        problem has a root function; events do not truncate the sweep).
      stats: solver counters after the run (nst, nre, nje, nni, netf, ...).
      message: human-readable status summary.
    """

    t: np.ndarray
    y: np.ndarray
    yp: np.ndarray
    status: np.ndarray
    success: bool
    t_events: np.ndarray
    y_events: np.ndarray
    stats: dict
    message: str


def _stats(ida: IDA) -> dict:
    """The counters and last-step data, read in one transfer."""
    st = ida.state
    vals = torch.stack(
        [x.to(torch.float64) for x in (st.nst, st.nre, st.nje, st.nni, st.netf, st.ncfn, st.nge,
                                       st.kused, st.hused)]
    ).tolist()
    names = ("nst", "nre", "nje", "nni", "netf", "ncfn", "nge", "last_order")
    return {**{k: int(v) for k, v in zip(names, vals)}, "last_step": vals[8]}


def solve_dae(
    res: Callable,
    t_span,
    y0,
    yp0=None,
    *,
    t_eval=None,
    rtol: float = 1.0e-6,
    atol=1.0e-8,
    jac: Optional[Callable] = None,
    roots: Optional[Callable] = None,
    id=None,
    options: IdaOptions | None = None,
    dtype: torch.dtype = torch.float64,
    calc_ic: Optional[str] = None,
    device=None,
) -> DAESolution:
    """Solve the DAE ``F(t, y, y') = 0`` from ``t_span[0]`` to ``t_span[1]``.

    Args:
      res: residual ``(t, y, yp) -> F`` of shape [N] (torch tensors).
      t_span: (t0, tf).
      y0: initial state [N].
      yp0: initial derivative [N]. May be None when ``id`` is given: then
        consistent (y0_algebraic, yp0) are computed with IDACalcIC
        (``icopt="ya_ydp"``) before integrating.
      t_eval: output grid inside t_span (default: just [tf]). Must be
        monotone increasing (or decreasing for backward integration).
      rtol, atol: scalar rtol; atol scalar or per-component [N].
      jac: optional analytic system Jacobian ``(t, cj, y, yp, rr) -> [N,N]``
        (default: forward-mode AD of ``res``).
      roots: optional event function ``(t, y, yp) -> g [nroots]``; located
        crossings are collected into ``t_events``/``y_events`` and the
        sweep continues through them.
      id: optional bool [N], True for differential variables (enables
        ``calc_ic="ya_ydp"``).
      options: advanced :class:`IdaOptions` (suppressalg, maxord, ...).
      dtype: torch.float64 (default) or torch.float32.
      calc_ic: force an IDACalcIC pass before integrating, "ya_ydp" or "y"
        (default: "ya_ydp" only when ``yp0`` is None).
      device: where to run; None is the current CUDA device.

    Returns:
      :class:`DAESolution`.
    """
    device = resolve_device(device)
    t0, tf = (float(t_span[0]), float(t_span[1]))
    y0 = torch.as_tensor(y0, dtype=dtype, device=device)
    n = int(y0.shape[0])

    nroots = 0
    if roots is not None:
        probe = roots(torch.as_tensor(t0, dtype=dtype, device=device), y0, torch.zeros_like(y0))
        nroots = int(probe.shape[0]) if probe.dim() else 1

    if yp0 is None:
        if id is None and calc_ic != "y":
            raise ValueError(
                "yp0=None requires `id` (differential-variable mask) so consistent ICs can be "
                "computed with calc_ic='ya_ydp'"
            )
        yp0 = torch.zeros_like(y0)
        calc_ic = calc_ic or "ya_ydp"
    yp0 = torch.as_tensor(yp0, dtype=dtype, device=device)

    problem = IdaProblem(
        n=n, res=res, jac=jac, root=roots, nroots=nroots,
        id=None if id is None else torch.as_tensor(id, dtype=torch.bool, device=device),
    )
    atol_arr = torch.as_tensor(atol, dtype=dtype, device=device).expand(n)
    tol = TolControl(torch.as_tensor(rtol, dtype=dtype, device=device), atol_arr)
    ida = IDA(problem, y0, yp0, tol, options or IdaOptions(), t0=t0, dtype=dtype, device=device)

    if t_eval is None:
        t_eval = np.asarray([tf], dtype=np.float64)
    else:
        t_eval = np.asarray(t_eval, dtype=np.float64)
        if t_eval.ndim != 1 or t_eval.size == 0:
            raise ValueError("t_eval must be a non-empty 1-D grid")

    if calc_ic is not None:
        ida.calc_ic(calc_ic, float(t_eval[0]))

    t_events: list[float] = []
    y_events: list[np.ndarray] = []

    if nroots == 0:
        tret, istate, yy, yp = ida.solve_grid(t_eval)
    else:
        # events present: host loop per output row (the reference's own
        # loop, examples/roberts.rs:55-70), collecting ROOT_RETURNs
        rows_t, rows_i, rows_y, rows_p = [], [], [], []
        for tout in t_eval:
            code = C.SUCCESS
            try:
                while True:
                    tr, status = ida.solve(float(tout))
                    if status == IdaSolveStatus.Root:
                        t_events.append(tr)
                        y_events.append(ida.get_yy())
                        continue
                    break
                code = status.value
            except IdaError as err:
                tr, code = err.t, err.code
            rows_t.append(float(tr))
            rows_i.append(code)
            rows_y.append(ida.get_yy())
            rows_p.append(ida.get_yp())
            if code < 0:
                break
        tret = np.asarray(rows_t)
        istate = np.asarray(rows_i, dtype=np.int32)
        yy = np.stack(rows_y)
        yp = np.stack(rows_p)

    status = np.asarray(istate)
    ok_codes = (C.SUCCESS, C.TSTOP_RETURN, C.ROOT_RETURN)
    success = bool(np.all(np.isin(status, ok_codes))) and len(status) == len(t_eval)
    worst = status[np.argmin(np.isin(status, ok_codes))]
    message = (
        "The solver successfully reached the end of the integration interval."
        if success
        else f"Solver failure: {C.STATUS_NAMES.get(int(worst), worst)}"
    )
    return DAESolution(
        t=np.asarray(tret), y=np.asarray(yy), yp=np.asarray(yp), status=status, success=success,
        t_events=np.asarray(t_events),
        y_events=(np.stack(y_events) if y_events else np.zeros((0, n))),
        stats=_stats(ida), message=message,
    )
