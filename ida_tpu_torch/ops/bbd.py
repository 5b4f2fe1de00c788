"""Band-block-diagonal preconditioner for the Krylov path (IDABBDPRE).

Port of ``ida_tpu/ops/bbd.py``. The C IDA module IDABBDPRE builds, per MPI
rank, a banded difference-quotient approximation of the local Jacobian and
preconditions SPGMR with its LU. Here, on ``ops/banded.py``:

* the local block is the whole state vector of each lane, or, with
  ``nblocks > 1``, each of ``nblocks`` contiguous slices of it (IDABBDPRE's
  per-rank blocks): band entries that couple two blocks are dropped, and
  the blocks factor and solve in lockstep as one more trailing batch axis
  of the banded LU;
* the banded Jacobian is exact (mu + ml + 1 colored jvps), not the C
  module's difference quotients;
* ``res_local`` plays IDABBDPRE's ``Gres``: a cheaper residual used only
  inside the preconditioner (the problem's residual by default).

On a state vector sharded over N (``parallel/mesh.py::sharded_solve``) the
blocks lie on the state axis: ``nblocks`` a multiple of its ranks, each rank
holds its own blocks (``pdata`` [rows, nb, nblocks / ranks, ...]), and its
factor and every ``prec_solve`` are local, with no collective (IDABBDPRE's
per-rank blocks; ``ida_tpu/ops/bbd.py:22-23``). The setup gathers the
iterate once and takes the banded Jacobian of the residual there, exactly as
unsharded, before it keeps the rank's block columns; the band entries are
therefore the unsharded ones bit for bit.

Usage::

    prec = make_bbd_prec(res, n, mu, ml)  # nblocks=..., res_local=...
    prob = IdaProblem(n=n, res=res, **prec.hooks())
    opts = IdaOptions(linear_solver="spgmr")
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils import sharding
from .banded import BandLU, band_factor, band_jacobian, band_rows, band_solve


class BBDPrec(NamedTuple):
    """The three IdaProblem preconditioner hooks; the bandwidths live in the
    closures, so ``pdata`` holds tensors only (the factored band and its
    pivots)."""

    n: int
    mu: int
    ml: int
    prec_setup: Callable
    prec_solve: Callable
    prec_zero: Callable
    nblocks: int = 1

    def hooks(self) -> dict:
        """Keyword arguments for IdaProblem(...): the rows lie on the last
        axis of each pdata leaf, a block of ``n // nblocks`` rows an entry
        with blocks, a row an entry without."""
        per = self.n // self.nblocks if self.nblocks > 1 else 1
        return dict(prec_setup=self.prec_setup, prec_solve=self.prec_solve,
                    prec_zero=self.prec_zero, pdata_rows=((-1, per), (-1, per)))


def make_bbd_prec(
    res: Callable,
    n: int,
    mu: int,
    ml: int,
    *,
    res_local: Optional[Callable] = None,
    nblocks: int = 1,
    dtype: torch.dtype = torch.float64,
) -> BBDPrec:
    """IDABBDPRE-style hooks for ``res(t, yy, yp)`` (batch-native, like every
    IdaProblem callback). ``mu``/``ml`` are the KEPT half-bandwidths of the
    preconditioner (IDABBDPRE's mukeep/mlkeep), which may be narrower than
    the Jacobian's. ``nblocks`` splits the state into that many contiguous
    blocks of ``n // nblocks`` and drops the coupling between them.
    ``dtype`` is that of ``prec_zero``'s band (the state casts it to its
    own)."""
    g = res_local if res_local is not None else res
    rows = band_rows(mu, ml)
    smu = mu + ml
    if n % nblocks != 0:
        raise ValueError(f"nblocks={nblocks} must divide n={n}")
    nb = n // nblocks
    if nblocks > 1 and nb <= ml:
        raise ValueError(f"block size {nb} must exceed ml={ml} (pivoting fill)")

    same_block = None
    if nblocks > 1:
        # band entry ab[r, j] holds J[i, j] with i = j + r - smu; it is kept
        # when i and j lie in the same block (rows outside the matrix hold 0)
        i = np.arange(n)[None, :] + np.arange(rows)[:, None] - smu
        same_block = (i // nb) == (np.arange(n)[None, :] // nb)
    masks = {}  # (device, dtype) -> the block mask as 1.0 / 0.0

    def _to_blocks(x, ax, count=nblocks):
        """[..., count * nb, *batch] (at ``ax``) -> [..., nb, count, *batch]:
        the block index becomes a trailing batch axis of the banded LU."""
        x = x.reshape(tuple(x.shape[:ax]) + (count, nb) + tuple(x.shape[ax + 1:]))
        return x.movedim(ax, ax + 1)

    def _from_blocks(x, ax):
        x = x.movedim(ax + 1, ax)
        return x.reshape(tuple(x.shape[:ax]) + (-1,) + tuple(x.shape[ax + 2:]))

    def own_blocks():
        """This rank's blocks on a state sharded over N, None unsharded."""
        own = sharding.rows(n)
        if own is None:
            return None
        ranks = n // (own.stop - own.start)
        if nblocks % ranks:
            raise ValueError(f"nblocks={nblocks} must be a multiple of the {ranks} ranks the "
                             "state vector is sharded over")
        return slice(own.start // nb, own.stop // nb)

    def prec_setup(t, cj, yy, yp, rr):
        blocks = own_blocks()
        if blocks is not None:
            yy, yp = sharding.gather_rows(yy), sharding.gather_rows(yp)

        def f_of_e(e):
            return g(t, yy + e, yp + cj * e)

        ab = band_jacobian(f_of_e, torch.zeros_like(yy), mu, ml)
        if nblocks > 1:
            key = (ab.device, ab.dtype)
            if key not in masks:
                masks[key] = torch.as_tensor(same_block, device=ab.device).to(ab.dtype)
            ab = ab * masks[key].reshape((rows, n) + (1,) * (ab.dim() - 2))
            ab = _to_blocks(ab, 1)
            if blocks is not None:
                ab = ab[:, :, blocks]
        f = band_factor(ab, mu, ml)
        return (f.lu, f.piv)

    def prec_solve(pdata, r, cj):
        lu, piv = pdata
        f = BandLU(lu, piv.to(torch.int32), None, mu, ml)
        rb = _to_blocks(r, 0, lu.shape[2]) if nblocks > 1 else r
        x = band_solve(f, rb.to(lu.dtype))
        if nblocks > 1:
            x = _from_blocks(x, 0)
        return x.to(r.dtype)

    def prec_zero():
        if nblocks > 1:
            return (torch.zeros((rows, nb, nblocks), dtype=dtype),
                    torch.zeros((nb, nblocks), dtype=torch.int32))
        return (torch.zeros((rows, n), dtype=dtype), torch.zeros((n,), dtype=torch.int32))

    return BBDPrec(n, mu, ml, prec_setup, prec_solve, prec_zero, nblocks)
