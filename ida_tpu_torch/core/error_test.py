"""Local truncation error estimation and order-decrease decision (L4).

Port of ``ida_tpu/core/error_test.py`` (reference ``test_error``,
src/lib.rs:967-1039): errors at orders k, k-1, k-2, the proposal ``knew``,
and the local error test ``ck * enorm_k <= 1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..norms import wrms_norm_bnd
from ..problem import IdaProblem
from ..utils.profiling import scope
from ..utils.sharding import state_axis
from ..utils.tree import take1, take_row
from .coeffs import phi_star_scale
from .state import IdaOptions, IdaState


class ErrorTestResult(NamedTuple):
    err_k: torch.Tensor
    err_km1: torch.Tensor
    converged: torch.Tensor  # bool: error test passed


def _norm(state: IdaState, problem: IdaProblem, opts: IdaOptions, x: torch.Tensor) -> torch.Tensor:
    """WRMS norm with the suppressalg mask (reference src/lib.rs:1353-1370),
    over the data axis of a batch-native array (across the shards of a
    state vector sharded over N)."""
    mask = problem.id if (opts.suppressalg and problem.id is not None) else None
    return wrms_norm_bnd(x, state.ewt, problem.n, state.tn.dim(), mask, state_axis())


@scope("error_test")
def error_test(
    state: IdaState,
    problem: IdaProblem,
    opts: IdaOptions,
    ck: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> tuple[IdaState, ErrorTestResult]:
    kk = state.kk
    kkf = kk.to(state.dtype)
    km1 = (kk - 1).clamp(min=0)
    km2 = (kk - 2).clamp(min=0)

    # error estimate vectors at orders k, k-1, k-2 (src/lib.rs:982-1007)
    row_k, row_km1 = take_row(state.phi, kk), take_row(state.phi, km1)
    if opts.fast_math:
        # phi is unscaled: the two picked rows take their phi-star scale
        s = phi_star_scale(state)
        row_k = row_k * take1(s, kk).unsqueeze(0)
        row_km1 = row_km1 * take1(s, km1).unsqueeze(0)
    delta1 = row_k + state.ee
    delta2 = delta1 + row_km1
    enorm_k = _norm(state, problem, opts, state.ee)
    enorm_km1 = _norm(state, problem, opts, delta1)
    enorm_km2 = _norm(state, problem, opts, delta2)

    err_k = take1(state.sigma, kk) * enorm_k
    terr_k = err_k * (kkf + 1.0)
    err_km1_val = take1(state.sigma, km1) * enorm_km1
    terr_km1 = kkf * err_km1_val
    err_km2 = take1(state.sigma, km2) * enorm_km2
    terr_km2 = (kkf - 1.0) * err_km2

    # order-decrease decision (src/lib.rs:999-1022)
    knew_gt2 = torch.where(torch.maximum(terr_km1, terr_km2) <= terr_k, kk - 1, kk)
    knew_eq2 = torch.where(terr_km1 <= 0.5 * terr_k, kk - 1, kk)
    knew = torch.where(kk > 2, knew_gt2, knew_eq2)
    knew = torch.where(kk > 1, knew, kk)
    err_km1 = torch.where(kk > 1, err_km1_val, torch.zeros_like(err_km1_val))

    converged = (ck * enorm_k) <= 1.0  # (src/lib.rs:1032)

    if mask is not None:
        knew = torch.where(mask, knew, state.knew)
    state = state._replace(knew=knew)
    return state, ErrorTestResult(err_k=err_k, err_km1=err_km1, converged=converged)
