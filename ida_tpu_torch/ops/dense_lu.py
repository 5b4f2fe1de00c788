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
``lu_solve_auto`` are what the solver calls: on a CUDA tensor they launch
the hand-written kernel of :mod:`ida_tpu_torch.ops.small_lu` (N <= 16) and
raise for anything else; on a CPU tensor they run the plain versions.
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


def _iota(n: int, ndim: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).reshape((n,) + (1,) * ndim)


def lu_factor(a: torch.Tensor) -> DenseLU:
    """LU-factor [N, N, *batch], ``denseGETRF`` order (reference
    crates/linear/src/dense.rs:86-158): one rank-1 update per column."""
    n = a.shape[0]
    if a.shape[1] != n:
        raise ValueError(f"lu_factor expects square matrices, got {tuple(a.shape)}")
    bshape = a.shape[2:]
    idx = _iota(n, len(bshape), a.device)  # [n, *1]
    mat = a
    piv = []
    fail = torch.zeros(bshape, dtype=torch.int32, device=a.device)
    for k in range(n):
        col = mat[:, k]
        masked_abs = torch.where(idx >= k, col.abs(), torch.full_like(col, float("-inf")))
        l = torch.argmax(masked_abs, dim=0).to(torch.int32)  # first max wins
        piv.append(l)
        sel_l = idx == l  # [n, *batch] one-hot of the pivot row
        pivot_val = torch.gather(col, 0, l.long().unsqueeze(0)).squeeze(0)
        zero_piv = pivot_val == 0.0
        fail = torch.where((fail == 0) & zero_piv, k + 1, fail)

        # swap full rows k and l (no-op when l == k)
        row_k = mat[k]
        row_l = torch.gather(mat, 0, l.long().reshape((1, 1) + bshape).expand((1,) + mat.shape[1:])).squeeze(0)
        mat = torch.where(sel_l.unsqueeze(1), row_k.unsqueeze(0), mat)
        mat = torch.cat([mat[:k], row_l.unsqueeze(0), mat[k + 1 :]])

        # scale sub-diagonal entries of column k by 1/pivot
        safe_piv = torch.where(zero_piv, torch.ones_like(pivot_val), mat[k, k])
        mult = 1.0 / safe_piv
        col_k = mat[:, k]
        col_scaled = torch.where(idx > k, col_k * mult, col_k)
        mat = torch.cat([mat[:, :k], col_scaled.unsqueeze(1), mat[:, k + 1 :]], dim=1)

        # trailing-submatrix rank-1 update: a[i,j] -= a[i,k] * a[k,j]
        update = col_scaled.unsqueeze(1) * mat[k].unsqueeze(0)
        mask = (idx > k).unsqueeze(1) & (idx > k).unsqueeze(0)
        mat = mat - torch.where(mask, update, torch.zeros_like(update))
    return DenseLU(mat, torch.stack(piv), fail)


def lu_solve(f: DenseLU, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for b [N, *batch] from a factorization,
    ``denseGETRS`` order (reference crates/linear/src/dense.rs:165-206)."""
    n = b.shape[0]
    idx = _iota(n, b.dim() - 1, b.device)
    lu, piv = f.lu, f.piv
    for k in range(n):
        pk = piv[k]
        bk = b[k]
        bpk = torch.gather(b, 0, pk.long().unsqueeze(0)).squeeze(0)
        b = torch.where(idx == pk, bk.unsqueeze(0), b)
        b = torch.cat([b[:k], bpk.unsqueeze(0), b[k + 1 :]])
    for k in range(n - 1):
        b = b - torch.where(idx > k, lu[:, k] * b[k], torch.zeros_like(b))
    for i in range(n - 1):
        k = n - 1 - i
        bk = b[k] / lu[k, k]
        b = torch.cat([b[:k], bk.unsqueeze(0), b[k + 1 :]])
        b = b - torch.where(idx < k, lu[:, k] * bk, torch.zeros_like(b))
    return torch.cat([(b[0] / lu[0, 0]).unsqueeze(0), b[1:]])


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
    """The solver's factor: the CUDA kernel on a CUDA tensor (N <= 16, else
    raises); on a CPU tensor the unrolled form up to N = 16, the looped one
    above."""
    from . import small_lu

    if a.shape[0] <= SMALL_N_UNROLL or a.device.type != "cpu":
        return small_lu.lu_factor(a)
    return lu_factor(a)


def lu_solve_auto(f: DenseLU, b: torch.Tensor) -> torch.Tensor:
    """The solver's solve; dispatch as :func:`lu_factor_auto`."""
    from . import small_lu

    if b.shape[0] <= SMALL_N_UNROLL or b.device.type != "cpu":
        return small_lu.lu_solve(f, b)
    return lu_solve(f, b)
