"""Dense LU with partial pivoting (L2 layer), exact SUNDIALS semantics.

Port of ``ida_tpu/ops/dense_lu.py`` (reference
``crates/linear/src/dense.rs:86-206``, SUNDIALS ``denseGETRF``/``denseGETRS``):
the pivot is the FIRST occurrence of the column max at or below the
diagonal (strict ``>``), and the elimination order is preserved, so the
factors match the reference's golden fixtures.

Layout is batch-native: matrices are [N, N, *batch], right-hand sides and
pivots [N, *batch], ``fail_col`` [*batch] (0 on success, else the 1-based
column of the first zero pivot).

The functions here are the plain PyTorch versions. ``lu_factor_auto`` and
``lu_solve_auto`` are what the solver calls: up to N = 16 they go to
:mod:`ida_tpu_torch.ops.small_lu` (the hand-written kernel on a CUDA
tensor, the unrolled plain version on a CPU tensor); larger systems (the
consistent-IC Jacobian of a PDE model) take the looped form on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DenseLU(NamedTuple):
    """LU factorization PA = LU packed SUNDIALS-style: the upper triangle is
    U, the strictly-lower part holds the multipliers; ``piv[k]`` is the row
    swapped with row k at step k."""

    lu: torch.Tensor  # [N, N, *batch]
    piv: torch.Tensor  # [N, *batch] int32
    fail_col: torch.Tensor  # [*batch] int32


def _swap_rows(mat: torch.Tensor, k: int, l: torch.Tensor) -> None:
    """In place, per lane: row l := row k, then row k := the old row l
    (a no-op where l == k)."""
    index = l.long().reshape((1,) * (mat.dim() - l.dim()) + tuple(l.shape))
    index = index.expand((1,) + tuple(mat.shape[1:]))
    row_k = mat[k].clone()
    row_l = torch.gather(mat, 0, index).squeeze(0)
    mat.scatter_(0, index, row_k.unsqueeze(0))
    mat[k] = row_l


def lu_factor(a: torch.Tensor) -> DenseLU:
    """LU-factor [N, N, *batch], ``denseGETRF`` order (reference
    crates/linear/src/dense.rs:86-158): one rank-1 update per column, made
    in place on a copy of ``a`` and only over the trailing block, so a
    column costs O((N-k)^2) and no [N, N, *batch] copy. Every entry sees the
    operations of the masked whole-matrix form in the same order: the same
    factors, bit for bit."""
    n = a.shape[0]
    if a.shape[1] != n:
        raise ValueError(f"lu_factor expects square matrices, got {tuple(a.shape)}")
    bshape = a.shape[2:]
    mat = a.clone()
    piv = []
    fail = torch.zeros(bshape, dtype=torch.int32, device=a.device)
    for k in range(n):
        # pivot: the first max of |a[i, k]| for i >= k
        l = (torch.argmax(mat[k:, k].abs(), dim=0) + k).to(torch.int32)
        piv.append(l)
        pivot_val = torch.gather(mat[:, k], 0, l.long().unsqueeze(0)).squeeze(0)
        zero_piv = pivot_val == 0.0
        fail = torch.where((fail == 0) & zero_piv, k + 1, fail)
        _swap_rows(mat, k, l)

        # scale the sub-diagonal of column k by 1/pivot
        safe_piv = torch.where(zero_piv, torch.ones_like(pivot_val), mat[k, k])
        mult = 1.0 / safe_piv
        mat[k + 1 :, k] = mat[k + 1 :, k] * mult

        # trailing-submatrix rank-1 update: a[i,j] -= a[i,k] * a[k,j]
        mat[k + 1 :, k + 1 :] -= mat[k + 1 :, k].unsqueeze(1) * mat[k, k + 1 :].unsqueeze(0)
    return DenseLU(mat, torch.stack(piv), fail)


def lu_solve(f: DenseLU, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for b [N, *batch] from a factorization,
    ``denseGETRS`` order (reference crates/linear/src/dense.rs:165-206), in
    place on a copy of ``b``."""
    n = b.shape[0]
    lu, piv = f.lu, f.piv
    x = b.clone()
    for k in range(n):
        _swap_rows(x, k, piv[k])
    for k in range(n - 1):
        x[k + 1 :] -= lu[k + 1 :, k] * x[k]
    for k in range(n - 1, 0, -1):
        x[k] = x[k] / lu[k, k]
        x[:k] -= lu[:k, k] * x[k]
    x[0] = x[0] / lu[0, 0]
    return x


def lu_factor_unrolled(a: torch.Tensor) -> DenseLU:
    """Gather-free LU for small static N: the same multiplies and
    subtractions in the same order as :func:`lu_factor`, scalarized over the
    N*N entries (each a [*batch] tensor), pivoting by selects."""
    n = a.shape[0]
    m = [[a[i, j] for j in range(n)] for i in range(n)]
    piv = []
    fail = torch.zeros(a.shape[2:], dtype=torch.int32, device=a.device)
    one = torch.ones((), dtype=a.dtype, device=a.device)

    for k in range(n):
        # pivot row: first occurrence of max |a[i,k]| for i >= k
        best = m[k][k].abs()
        lsel = torch.full(best.shape, k, dtype=torch.int32, device=a.device)
        for i in range(k + 1, n):
            cand = m[i][k].abs()
            take = cand > best
            best = torch.where(take, cand, best)
            lsel = torch.where(take, i, lsel)
        piv.append(lsel)

        # swap rows k and l via per-element selects
        for j in range(n):
            mkj = m[k][j]
            mlj = mkj
            for i in range(k + 1, n):
                mlj = torch.where(lsel == i, m[i][j], mlj)
            m[k][j] = mlj
            for i in range(k + 1, n):
                m[i][j] = torch.where(lsel == i, mkj, m[i][j])

        pivot_val = m[k][k]
        zero_piv = pivot_val == 0.0
        fail = torch.where((fail == 0) & zero_piv, k + 1, fail)
        mult = 1.0 / torch.where(zero_piv, one, pivot_val)
        for i in range(k + 1, n):
            m[i][k] = m[i][k] * mult
        for j in range(k + 1, n):
            mkj = m[k][j]
            for i in range(k + 1, n):
                m[i][j] = m[i][j] - mkj * m[i][k]

    lu = torch.stack([torch.stack(r) for r in m])
    return DenseLU(lu, torch.stack(piv), fail)


def lu_solve_unrolled(f: DenseLU, b: torch.Tensor) -> torch.Tensor:
    """Companion solve to :func:`lu_factor_unrolled`: the arithmetic of
    :func:`lu_solve` (column-oriented back substitution), scalarized."""
    n = b.shape[0]
    lu = f.lu
    piv = [f.piv[i] for i in range(n)]
    x = [b[i] for i in range(n)]

    for k in range(n):
        pk = piv[k]
        xk = x[k]
        xpk = xk
        for i in range(k + 1, n):
            xpk = torch.where(pk == i, x[i], xpk)
        x[k] = xpk
        for i in range(k + 1, n):
            x[i] = torch.where(pk == i, xk, x[i])

    for k in range(n - 1):
        for i in range(k + 1, n):
            x[i] = x[i] - lu[i, k] * x[k]

    for k in range(n - 1, 0, -1):
        x[k] = x[k] / lu[k, k]
        for i in range(k):
            x[i] = x[i] - lu[i, k] * x[k]
    x[0] = x[0] / lu[0, 0]
    return torch.stack(x)


# the kernel (and the unrolled plain form) covers N up to this size
SMALL_N_UNROLL = 16


def lu_factor_auto(a: torch.Tensor) -> DenseLU:
    """The solver's factor, dispatched by size: N <= 16 goes to
    ``small_lu`` (the CUDA kernel on a CUDA tensor, the unrolled form on a
    CPU tensor), larger N to the looped :func:`lu_factor` on any device
    (``ida_tpu``'s ``lu_factor_auto`` does the same)."""
    from . import small_lu

    if a.shape[0] <= SMALL_N_UNROLL:
        return small_lu.lu_factor(a)
    return lu_factor(a)


def lu_solve_auto(f: DenseLU, b: torch.Tensor) -> torch.Tensor:
    """The solver's solve; dispatch as :func:`lu_factor_auto`."""
    from . import small_lu

    if b.shape[0] <= SMALL_N_UNROLL:
        return small_lu.lu_solve(f, b)
    return lu_solve(f, b)
