"""Batched small-N LU on the card: the CUDA kernels ``csrc/small_lu.cu``.

The kernels replace ``ida_tpu/ops/pallas_lu.py::_lu_solve_kernel`` (the
Pallas TPU kernel behind ``pallas_lu_solve``). See the source's header for
the order of operations and the design.

The factor keeps its first skeleton: one thread a lane on the batch-last
contiguous layout, the matrix in registers, no shared memory. It is bound
by bytes (at N=3 it reads 9 values and writes 13 a lane for a few dozen
flops) and takes contiguous tensors.

The solves (``lu_solve``, ``lu_solve_t``) are bound by bytes plus a fixed
cost a launch (one DRAM round trip, the ramp and drain of the grid), which
at N = 2 on the foodweb blocks is as large as the bytes' time. Their
skeleton reads every operand by strides, so no copy surrounds a launch: the
layout of ``lu`` [N, N, *lanes], ``piv`` [N, *lanes] and the right-hand side
[N, *lanes] is read as it lies, and the result is allocated in the
right-hand side's layout (``torch.empty_like``). :func:`solve_layout` works
out the kernel's lane index from the tensors' ``stride()``: ``outer`` rows of
``inner`` lanes that sit at consecutive addresses in every operand, each
row at its own stride per operand. That covers the batch-last contiguous
layout (outer 1, inner B), foodweb's ``pdata`` and right-hand side
(lu [npts, 2, 2, B], piv [npts, 2, B], r [npts * 2, B]: outer npts, inner
B), one lane (inner 1) and every view of the factor's own output. A layout
it cannot express raises, naming it; a caller that holds one copies it in
plain sight (``dense_lu._solve_any``, for a cotangent that a sum's backward
expanded along some lane axes only; :func:`reads` tells). Where rows, strides and pointers
allow, a thread moves two consecutive lanes with one access
(``SolveLayout.vector``), in one pass of 256-thread blocks.

Build: at first use, ``nvcc`` compiles the source (and ``csrc/small_lu.cuh``,
the LU device code it shares with the whole-solve kernel) into a shared
library with a plain C interface under ``build/ida_tpu_torch/`` at the
repository root, keyed by a hash of the sources (:mod:`._build`); ``ctypes``
loads it. A failed build or a failed launch raises. The kernels run only on
CUDA tensors; on CPU tensors the wrappers run the plain PyTorch versions of
``ops/dense_lu.py``, and on any other device they raise. Nothing falls back
on a CUDA tensor.

``lu_solve_t`` launches ``small_lu_solve_t``, the transposed solve
``A^T lam = g`` from the same packed factors: the backward of every solve
under autograd (``ops/dense_lu.py``'s Functions). Its plain version is
``dense_lu.lu_solve_unrolled_t``.

Few lanes: the factor and the solve have a second skeleton, one system per
group of G threads (G the power of two >= N; a column a thread in the
factor, a row in the solve), which the source takes where its rule
(``kGroupRule``) says: from a least N over a range of lane counts, by
kernel and dtype, read off a sweep on the card. :func:`uses_groups` asks the
loaded library; the transposed solve keeps one thread a lane.

``FACTOR_LAUNCHES`` / ``SOLVE_LAUNCHES`` / ``SOLVE_T_LAUNCHES`` count kernel
launches (and only those), so a run can show that the solver went through
the kernel; ``LAUNCHES`` counts the same launches by (kernel, dtype tag, N),
e.g. ``LAUNCHES["factor", "f32", 3]`` (the mixed-precision modes' float32
factors), and ``GROUP_LAUNCHES`` those of them that took the group
skeleton, as the library that launched them says.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from ._build import DTYPE_TAGS, build_library
from .dense_lu import (DenseLU, SMALL_N_UNROLL, lu_factor_unrolled, lu_solve_unrolled,
                       lu_solve_unrolled_t)

FACTOR_LAUNCHES = 0
SOLVE_LAUNCHES = 0
SOLVE_T_LAUNCHES = 0
LAUNCHES: collections.Counter = collections.Counter()  # (kernel, "f32"/"f64", N) -> launches
GROUP_LAUNCHES: collections.Counter = collections.Counter()  # the same, group skeleton only


def reset_launch_counts() -> None:
    global FACTOR_LAUNCHES, SOLVE_LAUNCHES, SOLVE_T_LAUNCHES
    FACTOR_LAUNCHES = 0
    SOLVE_LAUNCHES = 0
    SOLVE_T_LAUNCHES = 0
    LAUNCHES.clear()
    GROUP_LAUNCHES.clear()


# the kernel indexes its lanes with 32-bit integers
MAX_LANES = 2**31 - 1
# small_lu_uses_groups's code for each kernel
_RULE_CODES = {"factor": 0, "solve": 1, "solve_t": 2}


def uses_groups(kernel: str, tag: str, n: int, lanes: int) -> bool:
    """Whether the loaded library (``build()``) launches the group skeleton
    for this factor or solve (``kernel``), dtype tag, N and number of
    lanes: its rule, ``small_lu_uses_groups``, asked."""
    return bool(build()["lib"].small_lu_uses_groups(_RULE_CODES[kernel], int(tag == "f32"), n, lanes))


def _count(kernel: str, tag: str, n: int, lanes: int) -> None:
    LAUNCHES[kernel, tag, n] += 1
    if uses_groups(kernel, tag, n, lanes):
        GROUP_LAUNCHES[kernel, tag, n] += 1


# lanes of one element a thread moves by one access (csrc/small_lu.cu kPair)
PAIR = 2

class SolveLayout(ctypes.Structure):
    """The solves' operand addressing, ``LuSolveLayout`` of
    ``csrc/small_lu.cu`` field for field: ``outer`` rows of ``inner`` lanes
    (consecutive addresses in every operand); the element strides of lu
    (``lu_i``, ``lu_j``), piv, the right-hand side ``b`` and the result
    ``x``, and each one's stride from row to row (``*_o``); ``vector`` when
    pairs of lanes tile every row (inner, every stride and every base
    pointer allow them)."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "outer", "inner", "lu_i", "lu_j", "lu_o", "piv_i", "piv_o", "b_i", "b_o", "x_i", "x_o")]
    _fields_ += [("vector", ctypes.c_int)]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


def solve_layout(lu: torch.Tensor, piv: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> SolveLayout | None:
    """The kernel's addressing of lu [N, N, *lanes], piv [N, *lanes],
    b [N, *lanes] and x [N, *lanes] (same lane shape), or None where it
    cannot express their strides. The inner run is the longest tail of the
    lane axes that every operand holds at consecutive addresses; the axes
    before it must fold into one stride per operand. Plain Python over
    shapes, strides and pointers: it reads no data."""
    lanes = tuple(b.shape[1:])
    if tuple(lu.shape[2:]) != lanes or tuple(piv.shape[1:]) != lanes or x.shape != b.shape:
        return None
    total = 1
    for s in lanes:
        total *= s
    if total == 0:
        return SolveLayout(outer=0, inner=0)
    strides = {"lu": lu.stride()[2:], "piv": piv.stride()[1:], "b": b.stride()[1:],
               "x": x.stride()[1:]}
    axes = [d for d, s in enumerate(lanes) if s != 1]
    inner = 1
    while axes and all(st[axes[-1]] == inner for st in strides.values()):
        inner *= lanes[axes.pop()]
    outer, row = 1, {k: 0 for k in strides}
    for d in reversed(axes):
        if outer == 1:
            row = {k: st[d] for k, st in strides.items()}
        elif any(st[d] != row[k] * outer for k, st in strides.items()):
            return None
        outer *= lanes[d]
    elem = {"lu": lu.stride()[:2], "piv": piv.stride()[:1], "b": b.stride()[:1],
            "x": x.stride()[:1]}
    vector = (inner % PAIR == 0
              and all(s % PAIR == 0 for k in strides for s in (*elem[k], row[k]))
              and all(t.data_ptr() % (PAIR * t.element_size()) == 0 for t in (lu, piv, b, x)))
    return SolveLayout(outer=outer, inner=inner, lu_i=elem["lu"][0], lu_j=elem["lu"][1],
                       lu_o=row["lu"], piv_i=elem["piv"][0], piv_o=row["piv"], b_i=elem["b"][0],
                       b_o=row["b"], x_i=elem["x"][0], x_o=row["x"], vector=int(vector))


def reads(f: DenseLU, b: torch.Tensor) -> bool:
    """Whether the solve kernels read ``f`` and ``b`` as they lie (the
    result takes ``torch.empty_like(b)``'s strides, worked out on the meta
    device, which allocates nothing)."""
    return solve_layout(f.lu, f.piv, b, torch.empty_like(b, device="meta")) is not None


def bind(lib) -> None:
    """Declare the C entry points' argument types on a loaded library."""
    ptrs = [ctypes.c_void_p] * 4
    for dt in DTYPE_TAGS.values():
        fn = getattr(lib, f"small_lu_factor_{dt}")
        fn.argtypes = ptrs + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in (f"small_lu_solve_{dt}", f"small_lu_solve_t_{dt}"):
            fn = getattr(lib, name)
            fn.argtypes = ptrs + [ctypes.c_int, ctypes.POINTER(SolveLayout), ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.small_lu_uses_groups.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong]
    lib.small_lu_uses_groups.restype = ctypes.c_int


@functools.cache
def build() -> dict:
    """Compile (once per source hash) and load the kernel library. Returns
    ``{"lib", "path", "seconds", "cached", "log"}``; ``log`` holds nvcc's
    output (registers and spills per kernel, from ``-Xptxas -v``)."""
    info = build_library("small_lu.cu", ("small_lu.cuh", "rounded.cuh"))
    bind(info["lib"])
    return info


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({torch.cuda.get_device_name()})")


def _on_card(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got device {t.device}")


def lu_factor(a: torch.Tensor) -> DenseLU:
    """Factor [N, N, *batch]. Kernel on CUDA; plain version on CPU."""
    if a.device.type == "cpu":
        return lu_factor_unrolled(a)
    _on_card(a, "lu_factor")
    f = _factor_launch(a)
    global FACTOR_LAUNCHES
    FACTOR_LAUNCHES += 1
    _count("factor", DTYPE_TAGS[a.dtype], a.shape[0], f.fail_col.numel())
    return f


def _factor_launch(a: torch.Tensor) -> DenseLU:
    """Launch ``small_lu_factor_<dtype>`` on a contiguous [N, N, *batch]."""
    n = a.shape[0]
    if not 1 <= n <= SMALL_N_UNROLL:
        raise ValueError(f"lu_factor: the kernel takes 1 <= N <= {SMALL_N_UNROLL}, got N={n}")
    if a.dtype not in DTYPE_TAGS:
        raise TypeError(f"lu_factor: the kernel takes float32 or float64, got {a.dtype}")
    bshape = a.shape[2:]
    bsz = 1
    for s in bshape:
        bsz *= s
    _check(a, "lu_factor(a)", (n, n) + tuple(bshape), a.dtype, a.device)
    if not a.is_contiguous():
        raise ValueError("lu_factor(a): expected a contiguous tensor")
    lu = torch.empty_like(a)
    piv = torch.empty((n,) + tuple(bshape), dtype=torch.int32, device=a.device)
    fail = torch.empty(tuple(bshape), dtype=torch.int32, device=a.device)
    fn = getattr(build()["lib"], f"small_lu_factor_{DTYPE_TAGS[a.dtype]}")
    err = fn(a.data_ptr(), lu.data_ptr(), piv.data_ptr(), fail.data_ptr(), n, bsz, _stream(a))
    _raise_on(err, "small_lu_factor")
    return DenseLU(lu, piv, fail)


def _solve_launch(f: DenseLU, b: torch.Tensor, kernel: str) -> torch.Tensor:
    """Launch ``small_lu_<kernel>_<dtype>`` on b [N, *lanes] and the
    factors, in their layouts; the result takes b's (``empty_like``)."""
    n = b.shape[0]
    if not 1 <= n <= SMALL_N_UNROLL:
        raise ValueError(f"lu_{kernel}: the kernel takes 1 <= N <= {SMALL_N_UNROLL}, got N={n}")
    if b.dtype not in DTYPE_TAGS:
        raise TypeError(f"lu_{kernel}: the kernel takes float32 or float64, got {b.dtype}")
    lanes = tuple(b.shape[1:])
    _check(f.lu, f"lu_{kernel}(lu)", (n, n) + lanes, b.dtype, b.device)
    _check(f.piv, f"lu_{kernel}(piv)", (n,) + lanes, torch.int32, b.device)
    x = torch.empty_like(b)
    layout = solve_layout(f.lu, f.piv, b, x)
    if layout is None:
        raise ValueError(
            f"lu_{kernel}: the kernel cannot read lanes {lanes} laid out as lu strides "
            f"{f.lu.stride()}, piv {f.piv.stride()}, b {b.stride()}, x {x.stride()}: the lane "
            "axes must be a run at consecutive addresses in every operand after axes that fold "
            "into one stride each (copy the operands, e.g. with .contiguous())")
    if layout.outer * layout.inner > MAX_LANES:
        raise ValueError(f"lu_{kernel}: the kernel takes at most {MAX_LANES} lanes")
    fn = getattr(build()["lib"], f"small_lu_{kernel}_{DTYPE_TAGS[b.dtype]}")
    err = fn(f.lu.data_ptr(), f.piv.data_ptr(), b.data_ptr(), x.data_ptr(), n,
             ctypes.byref(layout), _stream(b))
    _raise_on(err, f"small_lu_{kernel}")
    return x


def lu_solve(f: DenseLU, b: torch.Tensor) -> torch.Tensor:
    """Solve from a factorization, b [N, *batch], each operand in any layout
    :func:`solve_layout` expresses. Kernel on CUDA; plain version on CPU."""
    if b.device.type == "cpu":
        return lu_solve_unrolled(f, b)
    _on_card(b, "lu_solve")
    x = _solve_launch(f, b, "solve")
    global SOLVE_LAUNCHES
    SOLVE_LAUNCHES += 1
    _count("solve", DTYPE_TAGS[b.dtype], b.shape[0], math.prod(b.shape[1:]))
    return x


def lu_solve_t(f: DenseLU, g: torch.Tensor) -> torch.Tensor:
    """Solve ``A^T lam = g`` from the factorization of A, g [N, *batch].
    Kernel on CUDA; plain version on CPU."""
    if g.device.type == "cpu":
        return lu_solve_unrolled_t(f, g)
    _on_card(g, "lu_solve_t")
    lam = _solve_launch(f, g, "solve_t")
    global SOLVE_T_LAUNCHES
    SOLVE_T_LAUNCHES += 1
    _count("solve_t", DTYPE_TAGS[g.dtype], g.shape[0], math.prod(g.shape[1:]))
    return lam


def lu_factor_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counterpart of ``pallas_lu_solve``: ``a`` [B, N, N], ``b`` [B, N]
    (batch-leading, its signature) -> x [B, N]; the factor kernel on a
    batch-last copy of ``a``, then the solve kernel, which reads ``b`` and
    writes x batch-leading through transposed views."""
    if a.dim() != 3 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"lu_factor_solve: expected a [B,N,N], b [B,N]; got {tuple(a.shape)}, {tuple(b.shape)}")
    f = lu_factor(a.permute(1, 2, 0).contiguous())
    return lu_solve(f, b.t()).t()
