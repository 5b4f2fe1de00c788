"""Batched small-N LU on the card: the CUDA kernel ``csrc/small_lu.cu``.

The kernel replaces ``ida_tpu/ops/pallas_lu.py::_lu_solve_kernel`` (the
Pallas TPU kernel behind ``pallas_lu_solve``). It is bound by bytes: at N=3
the factor reads 9 values and writes 13 (lu, piv, fail) per lane for a few
dozen flops, so its design is one thread per lane on the batch-last layout
(coalesced loads and stores), the matrix in registers, no shared memory.
See the source's header for the order of operations.

Build: at first use, ``nvcc`` compiles the source (and ``csrc/small_lu.cuh``,
the LU device code it shares with the whole-solve kernel) into a shared
library with a plain C interface under ``build/ida_tpu_torch/`` at the
repository root, keyed by a hash of the sources (:mod:`._build`); ``ctypes``
loads it. A failed build or a failed launch raises. The kernel runs only on
CUDA tensors; on CPU tensors the wrappers run the plain PyTorch versions of
``ops/dense_lu.py``, and on any other device they raise. Nothing falls back
on a CUDA tensor.

``lu_solve_t`` launches ``small_lu_solve_t``, the transposed solve
``A^T lam = g`` from the same packed factors: the backward of every solve
under autograd (``ops/dense_lu.py``'s Functions). Its plain version is
``dense_lu.lu_solve_unrolled_t``.

``FACTOR_LAUNCHES`` / ``SOLVE_LAUNCHES`` / ``SOLVE_T_LAUNCHES`` count kernel
launches (and only those), so a run can show that the solver went through
the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import DTYPE_TAGS, build_library
from .dense_lu import (DenseLU, SMALL_N_UNROLL, lu_factor_unrolled, lu_solve_unrolled,
                       lu_solve_unrolled_t)

FACTOR_LAUNCHES = 0
SOLVE_LAUNCHES = 0
SOLVE_T_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FACTOR_LAUNCHES, SOLVE_LAUNCHES, SOLVE_T_LAUNCHES
    FACTOR_LAUNCHES = 0
    SOLVE_LAUNCHES = 0
    SOLVE_T_LAUNCHES = 0


@functools.cache
def build() -> dict:
    """Compile (once per source hash) and load the kernel library. Returns
    ``{"lib", "path", "seconds", "cached", "log"}``; ``log`` holds nvcc's
    output (registers and spills per kernel, from ``-Xptxas -v``)."""
    info = build_library("small_lu.cu", ("small_lu.cuh", "rounded.cuh"))
    ptrs = [ctypes.c_void_p] * 4
    for dt in DTYPE_TAGS.values():
        for name in (f"small_lu_factor_{dt}", f"small_lu_solve_{dt}", f"small_lu_solve_t_{dt}"):
            fn = getattr(info["lib"], name)
            fn.argtypes = ptrs + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return info


def _check(t: torch.Tensor, name: str, shape, dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({torch.cuda.get_device_name()})")


def lu_factor(a: torch.Tensor) -> DenseLU:
    """Factor [N, N, *batch]. Kernel on CUDA; plain version on CPU."""
    if a.device.type == "cpu":
        return lu_factor_unrolled(a)
    n = a.shape[0]
    if not 1 <= n <= SMALL_N_UNROLL:
        raise ValueError(f"lu_factor: the kernel takes 1 <= N <= {SMALL_N_UNROLL}, got N={n}")
    if a.dtype not in DTYPE_TAGS:
        raise TypeError(f"lu_factor: the kernel takes float32 or float64, got {a.dtype}")
    bshape = a.shape[2:]
    bsz = 1
    for s in bshape:
        bsz *= s
    _check(a, "lu_factor(a)", (n, n) + tuple(bshape), a.dtype)
    lu = torch.empty_like(a)
    piv = torch.empty((n,) + tuple(bshape), dtype=torch.int32, device=a.device)
    fail = torch.empty(tuple(bshape), dtype=torch.int32, device=a.device)
    fn = getattr(build()["lib"], f"small_lu_factor_{DTYPE_TAGS[a.dtype]}")
    err = fn(a.data_ptr(), lu.data_ptr(), piv.data_ptr(), fail.data_ptr(), n, bsz, _stream(a))
    _raise_on(err, "small_lu_factor")
    global FACTOR_LAUNCHES
    FACTOR_LAUNCHES += 1
    return DenseLU(lu, piv, fail)


def _solve_launch(f: DenseLU, b: torch.Tensor, kernel: str) -> torch.Tensor:
    """Launch ``small_lu_<kernel>_<dtype>`` on b [N, *batch] and the factors."""
    n = b.shape[0]
    if not 1 <= n <= SMALL_N_UNROLL:
        raise ValueError(f"lu_{kernel}: the kernel takes 1 <= N <= {SMALL_N_UNROLL}, got N={n}")
    if b.dtype not in DTYPE_TAGS:
        raise TypeError(f"lu_{kernel}: the kernel takes float32 or float64, got {b.dtype}")
    bshape = tuple(b.shape[1:])
    bsz = 1
    for s in bshape:
        bsz *= s
    _check(b, f"lu_{kernel}(b)", (n,) + bshape, b.dtype)
    _check(f.lu, f"lu_{kernel}(lu)", (n, n) + bshape, b.dtype)
    _check(f.piv, f"lu_{kernel}(piv)", (n,) + bshape, torch.int32)
    x = torch.empty_like(b)
    fn = getattr(build()["lib"], f"small_lu_{kernel}_{DTYPE_TAGS[b.dtype]}")
    err = fn(f.lu.data_ptr(), f.piv.data_ptr(), b.data_ptr(), x.data_ptr(), n, bsz, _stream(b))
    _raise_on(err, f"small_lu_{kernel}")
    return x


def lu_solve(f: DenseLU, b: torch.Tensor) -> torch.Tensor:
    """Solve from a factorization, b [N, *batch]. Kernel on CUDA; plain
    version on CPU."""
    if b.device.type == "cpu":
        return lu_solve_unrolled(f, b)
    x = _solve_launch(f, b, "solve")
    global SOLVE_LAUNCHES
    SOLVE_LAUNCHES += 1
    return x


def lu_solve_t(f: DenseLU, g: torch.Tensor) -> torch.Tensor:
    """Solve ``A^T lam = g`` from the factorization of A, g [N, *batch].
    Kernel on CUDA; plain version on CPU."""
    if g.device.type == "cpu":
        return lu_solve_unrolled_t(f, g)
    lam = _solve_launch(f, g, "solve_t")
    global SOLVE_T_LAUNCHES
    SOLVE_T_LAUNCHES += 1
    return lam


def lu_factor_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counterpart of ``pallas_lu_solve``: ``a`` [B, N, N], ``b`` [B, N]
    (batch-leading, its signature) -> x [B, N]; the factor kernel then the
    solve kernel on the batch-last copies."""
    if a.dim() != 3 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"lu_factor_solve: expected a [B,N,N], b [B,N]; got {tuple(a.shape)}, {tuple(b.shape)}")
    f = lu_factor(a.permute(1, 2, 0).contiguous())
    return lu_solve(f, b.t().contiguous()).t()
