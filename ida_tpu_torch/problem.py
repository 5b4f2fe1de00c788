"""Problem-definition API (L5 layer).

Port of ``ida_tpu/problem.py``. The DAE is ``F(t, y, y') = 0``; the Newton
and linear layers use the system Jacobian ``J = dF/dy + cj * dF/dy'``.
Callables take and return torch tensors. Under the batch-native layout
every argument carries the trailing batch axes: ``yy`` is [N, *batch],
``t``/``cj`` are [*batch] and ``res`` returns [N, *batch].

An analytic Jacobian is optional: the Newton iterate is
``y = yypredict + e``, ``y' = yppredict + cj*e``, so J is the Jacobian of
the residual with respect to the correction ``e``, taken by forward-mode AD
(the N unit tangents through one vmapped ``torch.func.jvp``, as ``ida_tpu``
takes ``jacfwd``; lanes are independent, so each column serves every lane
at once). The residual must therefore be vmap-able, as a JAX residual is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.autograd import forward_ad

# elements of one intermediate of a batched jvp (2**25 f64: 256 MB); unit
# tangents go through in chunks of at most this size
JVP_CHUNK_ELEMENTS = 1 << 25

def jacobian(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """d fn / d x at ``x`` of a lane-separable map [N, *batch] -> [N, *batch],
    as [N (rows), N (columns), *batch]. The N unit tangents, shared by every
    lane, go through one jvp under ``torch.func.vmap`` (in chunks): a
    column's values are those of its own jvp, and N jvps would cost N times
    the host's launches. Inside an open forward-mode level
    (``forward_ad.dual_level``, as in ``sensitivity.forward_sensitivity``),
    where ``torch.func.jvp`` cannot open another, the rows come from vmapped
    vjps instead: the same matrix, whose own tangent then follows that
    level."""
    n = x.shape[0]
    units = torch.eye(n, dtype=x.dtype, device=x.device)
    units = units.reshape((n, n) + (1,) * (x.dim() - 1)).expand((n,) + tuple(x.shape))
    chunk = max(1, min(n, JVP_CHUNK_ELEMENTS // max(x.numel(), 1)))
    if forward_ad._current_level >= 0:
        _, pull = torch.func.vjp(fn, x)
        return torch.func.vmap(lambda u: pull(u)[0], chunk_size=chunk)(units)
    cols = torch.func.vmap(lambda u: torch.func.jvp(fn, (x,), (u,))[1], chunk_size=chunk)(units)
    return cols.movedim(0, 1).contiguous()  # [column, row, ...] -> [row, column, ...]


ResFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
JacFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor
]


@dataclasses.dataclass(frozen=True)
class IdaProblem:
    """A DAE problem ``F(t, y, y') = 0``.

    Attributes:
      n: state dimension N.
      res: residual ``(t, yy, yp) -> F`` of shape [N, *batch].
      jac: optional analytic ``(t, cj, yy, yp, rr) -> J`` of shape
        [N, N, *batch]; forward-mode AD of ``res`` when None.
      root: optional root function ``(t, yy, yp) -> g`` of shape
        [nroots, *batch]; sign changes of each component are located as
        events during ``solve`` (``core/root.py``).
      nroots: number of root functions.
      id: optional bool [N]: differential (True) vs algebraic (False).
      prec_setup, prec_solve, prec_zero: the Krylov path's preconditioner
        (C IDASetPreconditioner): ``prec_setup(t, cj, yy, yp, rr) -> pdata``
        (a tuple of tensors, the factored P), ``prec_solve(pdata, r, cj) ->
        z`` approximately P^-1 r, and ``prec_zero() -> pdata`` of one lane
        (the state's initial value).
      jtimes_setup, jtimes_fn: a user Jacobian-times-vector (C
        IDASetJacTimes): ``jtimes_setup(t, cj, yy, yp, rr) -> jdata`` and
        ``jtimes_fn(jdata, t, cj, yy, yp, v) -> J v``; one jvp of ``res``
        when absent.
      quad, nquad: quadratures along the solution (the IDAS quadrature
        role, ``core/quad.py``): ``quad(t, yy, yp) -> [nquad, *batch]``,
        integrated over every accepted step into ``state.yQ``.
      pdata_rows: the preconditioner hooks run on a rank's own rows of a
        state vector sharded over N (``parallel/mesh.py::sharded_solve``;
        ``utils.sharding.rows`` names them), and this says where each
        ``pdata`` leaf holds them: one ``(axis, rows)`` a leaf, ``axis`` the
        leaf's axis that runs over the rows, counted from the end of its
        one-lane shape (-1 its last; trailing batch axes come after it), and
        ``rows`` the state rows one entry along it covers. A sharded state
        cuts each leaf there (``shard_state_vector``, ``shard_ensemble_2d``),
        and a rank whose rows split an entry is refused. heat2d's diagonal
        ``((-1, 1),)``, the blocked BBD ``((-1, nb), (-1, nb))`` (its blocks
        of nb rows), the food web ``((-3, 2), (-2, 2))`` (its grid points).
        None: a sharded solve runs the hooks on the gathered vectors and
        keeps ``pdata`` whole on every rank. No effect on an unsharded
        solve.
    """

    n: int
    res: ResFn
    jac: Optional[JacFn] = None
    root: Optional[Callable] = None
    nroots: int = 0
    id: Optional[torch.Tensor] = None
    prec_setup: Optional[Callable] = None
    prec_solve: Optional[Callable] = None
    prec_zero: Optional[Callable] = None
    jtimes_setup: Optional[Callable] = None
    jtimes_fn: Optional[Callable] = None
    quad: Optional[Callable] = None
    nquad: int = 0
    pdata_rows: Optional[tuple] = None

    def __post_init__(self):
        if self.root is None and self.nroots:
            raise ValueError("nroots > 0 requires a root function")
        if self.quad is None and self.nquad:
            raise ValueError("nquad > 0 requires a quad function")
        if self.prec_setup is not None and (self.prec_solve is None or self.prec_zero is None):
            raise ValueError("prec_setup requires prec_solve and prec_zero")
        if self.jtimes_setup is not None and self.jtimes_fn is None:
            raise ValueError("jtimes_setup requires jtimes_fn")
        if self.pdata_rows is not None and self.prec_setup is None:
            raise ValueError("pdata_rows names the rows of a preconditioner's pdata: it "
                             "requires prec_setup")

    @property
    def prec_local(self) -> bool:
        """The preconditioner runs on a rank's own rows (``pdata_rows``)."""
        return self.pdata_rows is not None

    def jtimes(self, t, cj, yy, yp, v, jdata=None) -> torch.Tensor:
        """Matrix-free J v = (dF/dy) v + cj (dF/dy') v via one jvp, or the
        user ``jtimes_fn`` when given."""
        if self.jtimes_fn is not None:
            return self.jtimes_fn(jdata, t, cj, yy, yp, v)
        return torch.func.jvp(lambda y, ydot: self.res(t, y, ydot), (yy, yp), (v, cj * v))[1]

    def sys_jacobian(self, t, cj, yy, yp, rr) -> torch.Tensor:
        """System Jacobian ``J = dF/dy + cj*dF/dy'`` at (t, yy, yp),
        [N, N, *batch]: the analytic ``jac`` when given, else forward AD of
        the correction map (the true ``t`` is passed, not the reference's
        ``tt = 0``)."""
        if self.jac is not None:
            return self.jac(t, cj, yy, yp, rr)

        def f_of_e(e):
            return self.res(t, yy + e, yp + cj * e)

        # ida_tpu's jacfwd: the N unit tangents through one vmapped jvp
        return jacobian(f_of_e, torch.zeros_like(yy))
