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

Gradients. The two ``_auto`` functions are ``torch.autograd.Function``s, so
reverse and forward mode go through the kernel (``ida_tpu`` differentiates
the jnp arithmetic of its solve instead; no TPU kernel has a backward). The
packed ``lu`` stands in for the matrix ``a`` it factors: the factor's
derivative passes a cotangent (or tangent) of ``lu`` on to ``a`` unchanged,
and the solve ``x = A^-1 b`` gives ``lu`` the cotangent of ``A``,
``-lambda x^T`` with ``lambda = A^-T g`` (:func:`lu_solve_unrolled_t`, the
kernel ``small_lu_solve_t`` on the card), and ``b`` the cotangent
``lambda``; its tangent is ``A^-1 (b' - A' x)``. That holds because nothing
but a solve, or a per-lane select or copy, reads ``lu``: the solver keeps it
in its state across steps, and a gradient then reaches the Jacobian of the
step that factored it. Each derivative calls the pair of Functions again,
so a backward is itself differentiable (Hessian-vector products). Pivots
and ``fail_col`` are integers and carry no derivative. Under
``utils.ad_mode.safe_ad`` a zero pivot is divided as 1 in both solves
(``ida_tpu/ops/dense_lu.py:170-226``'s ``smask_den``, applied once to the
factors), so a lane whose matrix is singular or was never factored keeps a
finite cotangent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.ad_mode import is_safe_ad
from ..utils.numerics import differentiated


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


def lu_solve_t(f: DenseLU, g: torch.Tensor) -> torch.Tensor:
    """Solve ``A^T lam = g`` for g [N, *batch] from the factorization of A
    (PA = LU, so A^T = U^T L^T P): forward substitution with U^T, back
    substitution with the unit L^T, then the row swaps undone in reverse
    order. Looped, for any N."""
    n = g.shape[0]
    lu, piv = f.lu, f.piv
    z = list(g.unbind(0))
    for k in range(n):
        z[k] = z[k] / lu[k, k]
        for i in range(k + 1, n):
            z[i] = z[i] - lu[k, i] * z[k]
    for k in range(n - 1, 0, -1):
        for i in range(k):
            z[i] = z[i] - lu[k, i] * z[k]
    w = torch.stack(z)
    for k in range(n - 1, -1, -1):
        _swap_rows(w, k, piv[k])
    return w


def lu_solve_unrolled_t(f: DenseLU, g: torch.Tensor) -> torch.Tensor:
    """Companion transposed solve to :func:`lu_solve_unrolled`: the
    arithmetic of :func:`lu_solve_t` with the swaps by selects; the plain
    version of the kernel ``small_lu_solve_t`` (``csrc/small_lu.cuh``
    ``lu_solve_t_dev``), which does the same operations in the same order."""
    n = g.shape[0]
    lu = f.lu
    piv = [f.piv[i] for i in range(n)]
    z = [g[i] for i in range(n)]

    # forward substitution with U^T, column-oriented
    for k in range(n):
        z[k] = z[k] / lu[k, k]
        for i in range(k + 1, n):
            z[i] = z[i] - lu[k, i] * z[k]
    # back substitution with the unit L^T, column-oriented
    for k in range(n - 1, 0, -1):
        for i in range(k):
            z[i] = z[i] - lu[k, i] * z[k]
    # undo the pivot sequence: swap k with piv[k], k from N-1 down to 0
    for k in range(n - 1, -1, -1):
        pk = piv[k]
        zk = z[k]
        zpk = zk
        for i in range(k + 1, n):
            zpk = torch.where(pk == i, z[i], zpk)
        z[k] = zpk
        for i in range(k + 1, n):
            z[i] = torch.where(pk == i, zk, z[i])
    return torch.stack(z)


# the kernel (and the unrolled plain form) covers N up to this size
SMALL_N_UNROLL = 16


def _factor_any(a: torch.Tensor) -> DenseLU:
    from . import small_lu

    if a.shape[0] <= SMALL_N_UNROLL:
        return small_lu.lu_factor(a.contiguous())
    return lu_factor(a)


def _guarded(lu: torch.Tensor) -> torch.Tensor:
    """``lu`` with zero pivots read as 1 under safe_ad (module doc)."""
    if not is_safe_ad():
        return lu
    n = lu.shape[0]
    idx = torch.arange(n, device=lu.device)
    diag = lu[idx, idx]
    out = lu.clone()
    out[idx, idx] = torch.where(diag == 0.0, torch.ones_like(diag), diag)
    return out


def _solve_any(lu: torch.Tensor, piv: torch.Tensor, b: torch.Tensor, transposed: bool = False):
    """x = A^-1 b (or A^-T b) from the packed factors, without autograd: the
    kernel on a CUDA tensor up to N = 16, else the plain versions."""
    from . import small_lu

    f = DenseLU(_guarded(lu), piv, None)  # no solve reads fail_col
    if b.shape[0] > SMALL_N_UNROLL:
        return lu_solve_t(f, b) if transposed else lu_solve(f, b)
    if b.is_cuda and not small_lu.reads(f, b):
        # the kernels read the solver's and the preconditioners' layouts as
        # they lie; a layout they cannot express (a cotangent that a sum's
        # backward expanded along some lane axes only) is copied here
        f = DenseLU(f.lu.contiguous(), f.piv.contiguous(), f.fail_col)
        b = b.contiguous()
    return small_lu.lu_solve_t(f, b) if transposed else small_lu.lu_solve(f, b)


def _outer(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per lane ``u v^T``: [N, *batch] x [N, *batch] -> [N, N, *batch]."""
    return u.unsqueeze(1) * v.unsqueeze(0)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per lane ``m v``: [N, N, *batch] x [N, *batch] -> [N, *batch]."""
    return (m * v.unsqueeze(0)).sum(dim=1)


class _Factor(torch.autograd.Function):
    """The factorization; ``lu`` carries the derivative of ``a`` (module doc)."""

    @staticmethod
    def forward(a):
        f = _factor_any(a.detach())
        return f.lu, f.piv, f.fail_col

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1], output[2])

    @staticmethod
    def backward(ctx, g_lu, g_piv, g_fail):
        return g_lu

    @staticmethod
    def jvp(ctx, t_a):
        return t_a, None, None


class _Solve(torch.autograd.Function):
    """x = A^-1 b from the packed factors of A."""

    @staticmethod
    def forward(lu, piv, b):
        return _solve_any(lu.detach(), piv, b.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        lu, piv, _ = inputs
        ctx.save_for_backward(lu, piv, output)
        ctx.save_for_forward(lu, piv, output)

    @staticmethod
    def backward(ctx, g):
        lu, piv, x = ctx.saved_tensors
        lam = _SolveT.apply(lu, piv, g)
        return -_outer(lam, x), None, lam

    @staticmethod
    def jvp(ctx, t_lu, t_piv, t_b):
        lu, piv, x = ctx.saved_tensors
        rhs = torch.zeros_like(x) if t_b is None else t_b
        if t_lu is not None:
            rhs = rhs - _matvec(t_lu, x)
        return _solve_any(lu, piv, rhs)


class _SolveT(torch.autograd.Function):
    """lam = A^-T g from the packed factors of A: the backward of
    :class:`_Solve`, and differentiable in turn."""

    @staticmethod
    def forward(lu, piv, g):
        return _solve_any(lu.detach(), piv, g.detach(), transposed=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        lu, piv, _ = inputs
        ctx.save_for_backward(lu, piv, output)
        ctx.save_for_forward(lu, piv, output)

    @staticmethod
    def backward(ctx, g_lam):
        lu, piv, lam = ctx.saved_tensors
        mu = _Solve.apply(lu, piv, g_lam)
        return -_outer(lam, mu), None, mu

    @staticmethod
    def jvp(ctx, t_lu, t_piv, t_g):
        lu, piv, lam = ctx.saved_tensors
        rhs = torch.zeros_like(lam) if t_g is None else t_g
        if t_lu is not None:
            rhs = rhs - _matvec(t_lu.transpose(0, 1), lam)
        return _solve_any(lu, piv, rhs, transposed=True)


def lu_factor_auto(a: torch.Tensor) -> DenseLU:
    """The solver's factor, dispatched by size: N <= 16 goes to
    ``small_lu`` (the CUDA kernel on a CUDA tensor, the unrolled form on a
    CPU tensor), larger N to the looped :func:`lu_factor` on any device
    (``ida_tpu``'s ``lu_factor_auto`` does the same). Differentiable
    (module doc); the Function runs only when a derivative is taken."""
    if differentiated(a):
        return DenseLU(*_Factor.apply(a))
    return _factor_any(a)


def lu_solve_auto(f: DenseLU, b: torch.Tensor) -> torch.Tensor:
    """The solver's solve; dispatch as :func:`lu_factor_auto`.
    Differentiable in ``f.lu`` and ``b`` (module doc)."""
    if differentiated(f.lu, b):
        return _Solve.apply(f.lu, f.piv, b)
    return _solve_any(f.lu, f.piv, b)


def lu_solve_t_auto(f: DenseLU, g: torch.Tensor) -> torch.Tensor:
    """``A^-T g`` from the factorization of A; dispatch and derivatives as
    :func:`lu_solve_auto`."""
    if differentiated(f.lu, g):
        return _SolveT.apply(f.lu, f.piv, g)
    return _solve_any(f.lu, f.piv, g, transposed=True)
