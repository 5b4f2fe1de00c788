"""SPGMR: scaled preconditioned restarted GMRES, the Krylov linear path.

Port of ``ida_tpu/ops/spgmr.py`` (SUNDIALS ``sunlinsol_spgmr`` semantics):
solve A x = b with a left preconditioner P and row/column scalings s1, s2
by running GMRES on

    (s1 P^{-1} A s2^{-1}) (s2 x) = s1 P^{-1} b .

A is never formed: the caller passes ``atimes`` (for IDA one jvp of the
residual). Every dot product and norm is a sum over the DATA axis 0
(``utils.numerics.sum0``), so ``b`` may carry trailing batch axes
([N, *batch]) and every lane runs its own restarted GMRES in lockstep; the
restarts are a per-lane masked while loop. On a state vector sharded over N
(``utils.sharding``) those sums, and only those, run across the shards;
the basis combinations, the Givens algebra and the back substitution are
local.

The JAX module runs all ``maxl`` Arnoldi iterations of a cycle with masked
commits. Here the host stops a cycle once every lane is done: the skipped
iterations commit nothing for any lane, and the zero rows they would leave
add only zeros to the back substitution and the correction, so every value
is the same. Each Arnoldi iteration is one host read (``bool(any)``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.numerics import sqrt_, sum0
from ..utils.sharding import state_axis, sum_over
from ..utils.tree import masked_while_loop

Atimes = Callable[[torch.Tensor], torch.Tensor]
Psolve = Callable[[torch.Tensor], torch.Tensor]


class SpgmrResult(NamedTuple):
    x: torch.Tensor
    converged: torch.Tensor  # bool
    res_norm: torch.Tensor  # final scaled-preconditioned residual norm
    nli: torch.Tensor  # int32 linear iterations
    nps: torch.Tensor  # int32 psolve calls
    res0: torch.Tensor  # initial scaled-preconditioned residual norm (||s1 P^-1 b||)
    natimes: torch.Tensor  # int32 A-times (Jacobian-vector product) calls

    @property
    def reduced(self) -> torch.Tensor:
        """SUNLS_RES_REDUCED: not converged to tol, but the scaled
        preconditioned residual did shrink (idaLsSolve accepts it on the
        first Newton iteration)."""
        return ~self.converged & (self.res_norm < self.res0)


class _Carry(NamedTuple):
    x: torch.Tensor
    res: torch.Tensor
    converged: torch.Tensor
    restarts: torch.Tensor
    nli: torch.Tensor
    nps: torch.Tensor
    res0: torch.Tensor


def _dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return sum_over(a * c, state_axis())


def spgmr_solve(
    atimes: Atimes,
    b: torch.Tensor,
    tol: torch.Tensor,
    *,
    psolve: Optional[Psolve] = None,
    s1: Optional[torch.Tensor] = None,
    s2: Optional[torch.Tensor] = None,
    maxl: int = 5,
    max_restarts: int = 5,
    storage_dtype=None,
    gs: str = "modified",
    active: Optional[torch.Tensor] = None,
) -> SpgmrResult:
    """Solve A x = b from x0 = 0 (IDA starts Newton corrections at zero).

    ``b`` is [N] or [N, *batch]; convergence, counters and ``x`` come back
    per lane. ``gs`` is "modified" (MGS, the SUNDIALS default) or
    "classical" (CGS2: classical Gram-Schmidt with one full
    reorthogonalization pass). ``storage_dtype`` (e.g. ``torch.bfloat16``)
    stores the Krylov basis V in that dtype, cast back to ``b.dtype`` at
    every read, while every reduction (dot products, norms, the Givens
    algebra, the back substitution) stays in ``b.dtype``; None stores it in
    ``b.dtype``. Lanes whose ``active`` is False are not solved: they come
    back with x = 0, converged False and zero counts, for the caller to
    discard."""
    if gs not in ("modified", "classical"):
        raise ValueError(f"gs must be 'modified' or 'classical', got {gs!r}")
    lane = b.shape[1:]
    dev = b.device
    sdt = storage_dtype or b.dtype

    def basis(rows):
        """V[rows] in the solve's dtype (no copy when stored in it)."""
        return rows.to(b.dtype)

    def prec_scaled(r):
        """s1 * P^{-1} r"""
        z = r if psolve is None else psolve(r)
        return z if s1 is None else s1 * z

    def unscale(v):
        return v if s2 is None else v / s2

    def cycle(x, nli, nps, first: bool, running):
        """One GMRES(maxl) cycle from ``x``. Returns (x_new, res_norm,
        converged, nli, nps, beta), beta the cycle's starting norm."""
        # r = b - A x; the first cycle starts at x = 0, so r = b
        r = b if first else b - atimes(x)
        z = prec_scaled(r)
        nps = nps + 1
        beta = sqrt_(_dot(z, z))
        V = torch.empty((maxl + 1,) + tuple(b.shape), dtype=sdt, device=dev)
        V[0] = torch.where(beta > 0.0, z / beta, z)
        zero = torch.zeros_like(beta)
        H = [[None] * maxl for _ in range(maxl + 1)]  # H[i][j]; None is 0
        cs, sn = [zero] * maxl, [zero] * maxl
        g = [beta] + [zero] * maxl
        done = (beta <= tol) | ~running
        jmax = 0
        for j in range(maxl):
            if not bool((~done).any()):
                break
            jmax = j + 1
            act = ~done
            w = prec_scaled(atimes(unscale(basis(V[j]))))
            inc = act.to(torch.int32)
            nps, nli = nps + inc, nli + inc
            if gs == "classical":
                # CGS2 against V[0..j] (the JAX module contracts the whole
                # basis, whose rows above j are still zero)
                vs = basis(V[: j + 1])
                hs = sum_over((vs * w).movedim(1, 0), state_axis())
                w = w - sum0(hs.unsqueeze(1) * vs)
                hs2 = sum_over((vs * w).movedim(1, 0), state_axis())
                w = w - sum0(hs2.unsqueeze(1) * vs)
                col = list(hs + hs2)
            else:
                col = []
                for i in range(j + 1):
                    vi = basis(V[i])
                    hij = _dot(w, vi)
                    w = w - hij * vi
                    col.append(hij)
            hnorm = sqrt_(_dot(w, w))
            col.append(hnorm)
            V[j + 1] = torch.where(hnorm > 0.0, w / hnorm, w)

            # the earlier Givens rotations, then a new one to annihilate col[j+1]
            for i in range(j):
                tmp = cs[i] * col[i] - sn[i] * col[i + 1]
                col[i + 1] = sn[i] * col[i] + cs[i] * col[i + 1]
                col[i] = tmp
            denom = sqrt_(col[j] * col[j] + col[j + 1] * col[j + 1])
            pos = denom > 0.0
            c_new = torch.where(pos, col[j] / denom, torch.ones_like(denom))
            s_new = torch.where(pos, -col[j + 1] / denom, zero)
            col[j] = c_new * col[j] - s_new * col[j + 1]

            # masked commit (column j and the rotation were zero before)
            for i in range(j + 1):
                H[i][j] = torch.where(act, col[i], zero)
            cs[j] = torch.where(act, c_new, zero)
            sn[j] = torch.where(act, s_new, zero)
            g[j], g[j + 1] = torch.where(act, c_new * g[j], g[j]), torch.where(act, s_new * g[j], g[j + 1])
            done = done | (g[j + 1].abs() <= tol)

        # back substitution H y = g over the columns that ran (a column a
        # lane never entered has H[j][j] = 0 and gives y[j] = 0)
        y = [zero] * jmax
        for j in range(jmax - 1, -1, -1):
            terms = [H[j][k] * y[k] for k in range(j + 1, jmax)]
            s = g[j] - sum0(torch.stack(terms)) if terms else g[j]
            hjj = H[j][j]
            y[j] = torch.where(hjj != 0.0, s / hjj, zero)
        if jmax:
            x_new = x + unscale(sum0(torch.stack(y).unsqueeze(1) * basis(V[:jmax])))
        else:
            x_new = x
        # the true preconditioned scaled residual decides the restart
        r_true = prec_scaled(b - atimes(x_new))
        nps = nps + 1
        res_true = sqrt_(_dot(r_true, r_true))
        return x_new, res_true, res_true <= tol, nli, nps, beta

    if active is None:
        active = torch.ones(lane, dtype=torch.bool, device=dev)

    def cond(c: _Carry):
        return ~c.converged & (c.restarts < max_restarts + 1) & active

    n_cycles = 0

    def body(c: _Carry):
        nonlocal n_cycles
        x, res, conv, nli, nps, beta = cycle(c.x, c.nli, c.nps, n_cycles == 0, cond(c))
        n_cycles += 1
        return _Carry(
            x=x, res=res, converged=conv, restarts=c.restarts + 1, nli=nli, nps=nps,
            res0=torch.where(c.restarts == 0, beta, c.res0),
        )

    i32 = torch.int32
    inf = torch.full(lane, float("inf"), dtype=b.dtype, device=dev)
    out = masked_while_loop(
        cond, body,
        _Carry(
            x=torch.zeros_like(b), res=inf, converged=torch.zeros(lane, dtype=torch.bool, device=dev),
            restarts=torch.zeros(lane, dtype=i32, device=dev),
            nli=torch.zeros(lane, dtype=i32, device=dev),
            nps=torch.zeros(lane, dtype=i32, device=dev), res0=inf,
        ),
    )
    return SpgmrResult(
        x=out.x, converged=out.converged, res_norm=out.res, nli=out.nli, nps=out.nps,
        res0=out.res0,
        # per cycle: one atimes for the starting residual, one per active
        # Arnoldi iteration (== nli), one for the true-residual recompute
        natimes=out.nli + 2 * out.restarts,
    )
