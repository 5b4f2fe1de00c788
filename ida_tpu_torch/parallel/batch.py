"""Ensemble (batch) integration: many independent DAE instances in lockstep.

Port of ``ida_tpu/parallel/batch.py``'s ``ensemble_init`` and
``make_ensemble_solve``. The public layout is the JAX package's: states,
params and results are batch-LEADING. Inside, one batch-native solve runs
over states whose batch axis is TRAILING (the layout of
``bench.py::_native_setup``), which also makes the LU kernel's loads
coalesced. Per-lane parameters reach the residual through a
``problem_factory(params)`` that receives batch-last params [P, B].
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.solve import TASK_NORMAL, solve
from ..core.state import IdaOptions, IdaState, init_state
from ..problem import IdaProblem
from ..tol_control import TolControl
from ..utils.device import resolve_device

ProblemFactory = Callable[[Any], IdaProblem]


def _move_batch(states: IdaState, src: int, dst: int) -> IdaState:
    return IdaState(
        *(
            x.movedim(src, dst).contiguous() if isinstance(x, torch.Tensor) else x
            for x in states
        )
    )


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
) -> IdaState:
    """Batch-leading IdaState for ``params`` [B, P], ``yy0``/``yp0`` [B, N]
    (the JAX package's vmap of ``init_state``). ``device`` None is the
    current CUDA device (raises when there is none)."""
    device = resolve_device(device)
    params = torch.as_tensor(params, dtype=dtype, device=device)
    problem = problem_factory(params.t())
    return init_state(problem, yy0, yp0, device=device, dtype=dtype)


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
        bsz = native.tn.shape[0]
        n = native.yy.shape[0]
        p = torch.as_tensor(params, dtype=dtype, device=dev).t().contiguous()
        rtol = torch.as_tensor(tol.rtol, dtype=dtype, device=dev)
        atol = torch.as_tensor(tol.atol, dtype=dtype, device=dev)
        tol_native = TolControl(
            rtol=rtol.expand(bsz),
            atol=(atol.reshape(-1, 1) if atol.dim() else atol).expand(n, bsz),
        )
        st, tret, istate = solve(native, problem_factory(p), opts, tol_native, tout, itask)
        return from_native(st), tret, istate

    return fn
