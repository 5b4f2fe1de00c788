"""Banded LU with partial pivoting and colored banded Jacobians (L2 layer).

Port of ``ida_tpu/ops/banded.py``: SUNDIALS ``bandGETRF``/``bandGETRS``
(the C IDA ``IDABand`` solver). Column-oriented elimination, partial
pivoting over the ``ml`` subdiagonal rows of each column (the first of
equal maxima wins), ``ml`` fill rows above the stored band to take row
swaps. The band lives in LAPACK column band storage ``ab[i - j + smu, j]``
with ``smu = mu + ml`` (rows ``0..ml-1`` are fill), ``[2*ml+mu+1, n,
*batch]``: any trailing batch factors in lockstep.

``ida_tpu`` writes each column step as whole-window arithmetic for the TPU
(one-hot corrections in place of scatters). Here a column is a few indexed
updates of one padded copy, in place, with the arithmetic that decides the
bits kept as the reference has it:

* the row swap is two corrections, row k := v1 + (v2 - v1) and row k + d
  := v2 + (v1 - v2) (the same values as the one-hot form; an exact swap
  would differ from it where v1 + (v2 - v1) != v2);
* the multipliers are divisions by the pivot, not products with its
  reciprocal;
* the pivot is the first maximum of |column| over the live rows, a NaN
  counting as the maximum (``jnp.argmax``'s rule), chosen without
  ``torch.argmax``, whose order among ties no backend promises;
* back substitution subtracts one sum of the ``mu + ml`` products of a row,
  added by ``utils.numerics.sum0`` so that the card and the CPU agree.

With finite entries the factor is ``ida_tpu``'s bit for bit. A NaN or inf
spreads differently: the one-hot form multiplies it by zero into every row
of its window column, the indexed form touches rows k and k + d only. The
Newton layer fails ``lsetup`` on a non-finite Jacobian either way.

A column costs a few tens of launches, so a factor of ``n`` columns is
launch bound on the card (``ida_tpu`` has no kernel for it either).

The banded Jacobian takes ``mu + ml + 1`` jvps with Curtis-Powell-Reid
coloring (columns ``j = c (mod mu+ml+1)`` share a probe), run as one
vmapped ``torch.func.jvp``. ``fail_col`` is the 1-based column of the first
zero pivot, 0 on success.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..problem import JVP_CHUNK_ELEMENTS
from ..utils.numerics import sum0


class BandLU(NamedTuple):
    """Banded LU factorization, SUNDIALS band-storage packing.

    ``lu``: [2*ml+mu+1, n, *batch]; rows ``smu+1..smu+ml`` of column k hold
    the multipliers, rows ``0..smu`` hold U (``U[k, k+t] = lu[smu-t,
    k+t]``). ``piv[k]`` is the OFFSET d of the row swapped with row k
    (absolute row k + d, d in [0, ml]). ``fail_col`` is 0 on success, else
    the 1-based first zero-pivot column."""

    lu: torch.Tensor
    piv: torch.Tensor  # [n, *batch] int32 offsets
    fail_col: torch.Tensor  # [*batch] int32
    mu: int
    ml: int


def band_rows(mu: int, ml: int) -> int:
    return 2 * ml + mu + 1


def _trail(t: torch.Tensor, nbatch: int) -> torch.Tensor:
    return t.reshape(tuple(t.shape) + (1,) * nbatch)


def band_from_dense(a: torch.Tensor, mu: int, ml: int) -> torch.Tensor:
    """Pack a dense [n, n, *batch] matrix into band storage (entries outside
    the band are dropped)."""
    n = a.shape[1]
    smu = mu + ml
    cols = torch.arange(n, device=a.device)
    out = a.new_zeros((band_rows(mu, ml), n) + tuple(a.shape[2:]))
    for o in range(-mu, ml + 1):  # o = i - j
        i = cols + o
        valid = _trail((i >= 0) & (i < n), a.dim() - 2)
        out[o + smu] = torch.where(valid, a[i.clamp(0, n - 1), cols], 0.0)
    return out


def band_to_dense(ab: torch.Tensor, mu: int, ml: int) -> torch.Tensor:
    """Unpack band storage to dense [n, n, *batch] (fill rows included, so a
    FACTORED band gives back its U part)."""
    smu = mu + ml
    n = ab.shape[1]
    cols = torch.arange(n, device=ab.device)
    out = ab.new_zeros((n, n) + tuple(ab.shape[2:]))
    for r in range(ab.shape[0]):
        i = cols + (r - smu)
        valid = _trail((i >= 0) & (i < n), ab.dim() - 2)
        out.index_put_((i.clamp(0, n - 1), cols), torch.where(valid, ab[r], 0.0),
                       accumulate=True)
    return out


def _first_max(a: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum over axis 0 (a NaN counts as the maximum,
    the first NaN winning), int64 [*batch]."""
    hit = (a == a.amax(dim=0)) | torch.isnan(a)
    idx = _trail(torch.arange(a.shape[0], device=a.device), a.dim() - 1)
    return torch.where(hit, idx, a.shape[0]).amin(dim=0)


def band_factor(ab: torch.Tensor, mu: int, ml: int) -> BandLU:
    """LU-factor a band matrix, SUNDIALS ``bandGETRF`` semantics, on a
    padded copy of ``ab`` ([2*ml+mu+1, n, *batch], fill rows zero)."""
    smu = mu + ml
    rows = band_rows(mu, ml)
    if ab.shape[0] != rows:
        raise ValueError(f"band_factor: {rows} rows for mu={mu}, ml={ml}, got {tuple(ab.shape)}")
    n = ab.shape[1]
    batch = tuple(ab.shape[2:])
    nb = len(batch)
    dev = ab.device
    w = smu + 1  # the window: columns k..k+smu
    # padding columns keep every window in range
    abp = torch.cat([ab, ab.new_zeros((rows, smu) + batch)], dim=1)

    t = torch.arange(w, device=dev)
    row_k = smu - t  # where row k of the matrix lies in the window's column t
    # the trailing update's entries: rows k+1..k+ml (di) by columns k+1..k+smu (t)
    di = torch.arange(1, ml + 1, device=dev).reshape(-1, 1)
    tt = torch.arange(1, w, device=dev).reshape(1, -1)
    upd_r, upd_t = (smu + di - tt).expand(ml, smu), tt.expand(ml, smu)

    piv = []
    fail = torch.zeros(batch, dtype=torch.int32, device=dev)
    for k in range(n):
        win = abp[:, k:k + w]  # a view: the updates below write abp

        # pivot: rows k..k+ml of column k that lie inside the matrix
        live = min(ml + 1, n - k)
        d = _first_max(win[smu:smu + live, 0].abs())
        piv.append(d.to(torch.int32))

        # swap rows k and k+d across the window (two corrections)
        row_d = (_trail(row_k, nb) + d).unsqueeze(0)  # [1, w, *batch]
        v1 = win[row_k, t]
        v2 = torch.gather(win, 0, row_d).squeeze(0)
        u = v1 + (v2 - v1)
        win.scatter_(0, row_d, (v2 + (v1 - v2)).unsqueeze(0))
        win[row_k, t] = u

        # multipliers, and the first zero pivot
        p = u[0]
        zero_piv = p == 0.0
        fail = torch.where((fail == 0) & zero_piv, k + 1, fail)
        safe_p = torch.where(zero_piv, torch.ones_like(p), p)
        mult = win[smu + 1:, 0] / safe_p  # [ml, *batch]
        win[smu + 1:, 0] = mult

        # the rank-1 update of the trailing band: row k+di, column k+t
        if ml and smu:
            win[upd_r, upd_t] = win[upd_r, upd_t] - mult.unsqueeze(1) * u[1:].unsqueeze(0)
    piv_t = torch.stack(piv) if piv else torch.zeros((0,) + batch, dtype=torch.int32, device=dev)
    return BandLU(abp[:, :n].contiguous(), piv_t, fail, mu, ml)


def band_solve(f: BandLU, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` ([n, *batch]) from a banded factorization,
    SUNDIALS ``bandGETRS`` order: the row swaps interleaved with forward
    substitution, then back substitution."""
    mu, ml = f.mu, f.ml
    smu = mu + ml
    n = b.shape[0]
    batch = tuple(b.shape[1:])
    dev = b.device
    w = smu + 1
    piv = f.piv.long()

    # swaps + forward substitution, in place on a padded copy of b
    x = torch.cat([b, b.new_zeros((ml,) + batch)])
    for k in range(n):
        wv = x[k:k + ml + 1]
        d = piv[k].unsqueeze(0)
        vk = wv[0]
        vd = torch.gather(wv, 0, d).squeeze(0)
        new_k = vk + (vd - vk)
        wv.scatter_(0, d, (vd + (vk - vd)).unsqueeze(0))
        wv[0] = new_k
        if ml:
            wv[1:] = wv[1:] + (-f.lu[smu + 1:, k]) * new_k

    # back substitution: x[k] = (x[k] - sum_t U[k, k+t] x[k+t]) / U[k, k]
    lu_pad = torch.cat([f.lu, f.lu.new_zeros((f.lu.shape[0], smu) + tuple(f.lu.shape[2:]))], dim=1)
    x = torch.cat([x[:n], b.new_zeros((smu,) + batch)])
    t = torch.arange(w, device=dev)
    row_k = smu - t
    for k in range(n - 1, -1, -1):
        urow = lu_pad[:, k:k + w][row_k, t]  # U[k, k+t], [w, *batch]
        xwin = x[k:k + w]
        acc = sum0(urow[1:] * xwin[1:]) if smu else torch.zeros_like(xwin[0])
        x[k] = (xwin[0] - acc) / urow[0]
    return x[:n]


def band_jacobian(fn: Callable[[torch.Tensor], torch.Tensor], y: torch.Tensor, mu: int,
                  ml: int) -> torch.Tensor:
    """Banded Jacobian of ``fn`` at ``y`` ([n, *batch]) in band storage, from
    mu + ml + 1 Curtis-Powell-Reid-colored jvp probes, batched through one
    vmapped ``torch.func.jvp`` (exact forward-mode entries)."""
    n = y.shape[0]
    smu = mu + ml
    width = mu + ml + 1
    nb = y.dim() - 1
    cols = torch.arange(n, device=y.device)
    color = cols % width
    probes = (color.unsqueeze(0) == torch.arange(width, device=y.device).unsqueeze(1)).to(y.dtype)
    probes = _trail(probes, nb).expand((width,) + tuple(y.shape))
    chunk = max(1, min(width, JVP_CHUNK_ELEMENTS // max(y.numel(), 1)))
    jstack = torch.func.vmap(lambda v: torch.func.jvp(fn, (y,), (v,))[1], chunk_size=chunk)(probes)

    # band row o + smu of column j holds J[j + o, j] = jstack[color[j], j + o]
    offs = torch.arange(-mu, ml + 1, device=y.device).unsqueeze(1)
    i = cols.unsqueeze(0) + offs  # [mu+ml+1, n]
    valid = _trail((i >= 0) & (i < n), nb)
    vals = torch.where(valid, jstack[color.unsqueeze(0).expand_as(i), i.clamp(0, n - 1)], 0.0)
    return torch.cat([y.new_zeros((ml, n) + tuple(y.shape[1:])), vals])


def band_sys_jacobian(problem, t, cj, yy, yp, mu: int, ml: int) -> torch.Tensor:
    """The system Jacobian ``J = dF/dy + cj*dF/dy'`` in band storage (the
    band analogue of ``IdaProblem.sys_jacobian``)."""

    def f_of_e(e):
        return problem.res(t, yy + e, yp + cj * e)

    return band_jacobian(f_of_e, torch.zeros_like(yy), mu, ml)
