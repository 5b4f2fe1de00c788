"""Arithmetic helpers that keep the port's rounding equal to the reference's.

* :func:`sum0` adds the rows of a tensor one after another. The reference's
  reductions over small data axes (the K1 = 6 rows of phi, the N entries of
  a WRMS norm) run as a sequential loop under XLA:CPU; ``torch.sum`` may
  split the axis over several accumulators (CUDA) or a cascade (CPU), which
  rounds differently. Step-size decisions hinge on the last bit (a 1-ulp
  predictor difference once turned 362 canonical steps into 375), so the
  order is written out. XLA:CPU adds sequentially only up to about 32
  terms; beyond that it vectorizes, in an order no sequential loop
  reproduces. A longer axis (the grid of a PDE model, N = 10,000) is
  added as a pairwise tree instead, zero-padded to a power of two and
  halved log2 times: about log2(N) launches, and elementwise additions only,
  so the card and the CPU round every partial sum alike. ``torch.sum``
  would not: its order differs between the two, and the step sequence of
  a 100 x 100 heat solve hangs on the last bits of its norms (reversing
  the order of the sums moved its steps from 167 to 183).
* :func:`sqrt_` is ``sqrt``. ATen's vectorized CPU ``sqrt`` for float64 is
  not correctly rounded (about 1.3% of inputs differ by an ulp from IEEE
  ``sqrt``, which XLA:CPU, numpy and C use), so CPU tensors go through
  numpy. CUDA's ``sqrt`` is IEEE-correct.
* :func:`pow_` is ``base ** expo``. On CPU tensors it calls the C library's
  ``pow`` per element: ATen's vectorized CPU ``pow`` (SLEEF, 1 ulp) differs
  from the C library's in about 1.7% of the step-size ratios and Newton
  rates this solver computes, while XLA:CPU and C IDA both call the C
  library. On CUDA tensors it is ``torch.pow`` (CUDA's ``pow``, which need
  not round like the C library's).

On CPU tensors both leave torch (numpy, ``ctypes``), so each is a
``torch.autograd.Function`` there: the forward keeps the values above bit for
bit, and the derivatives are plain torch, written with differentiable
operations so that a backward can itself be differentiated (the Hessian-vector
product of ``sensitivity.adjoint_hvp``): ``sqrt``'s is ``0.5 / sqrt(x)``,
``pow``'s ``expo * pow(base, expo - 1)`` for the base and ``log(base) * out``
for a tensor exponent, the forms ``ida_tpu``'s ``jax.grad`` takes. An op that
leaves torch without such a Function drops the graph or raises under autograd.
Where no derivative is being taken (:func:`differentiated`), the plain call
runs without the Function's overhead. Each Function also carries a ``vmap``
rule (they are elementwise), so a residual that calls them can be
differentiated by ``problem.jacobian``'s vmapped jvp.

* :func:`sin_` and :func:`cos_` are ``sin`` and ``cos``. ATen's vectorized CPU
  versions (SLEEF) differ from the C library's in about 0.2% of float64
  inputs, while XLA:CPU's agree with it; so CPU tensors go through numpy
  (which calls the C library for float64) in a Function as above, and CUDA
  tensors through ``torch.sin``/``torch.cos``.

* :func:`tanh_`, :func:`sinh_` and :func:`cosh_` are ``tanh``, ``sinh`` and
  ``cosh``. ATen's vectorised CPU versions are up to 2 ulp from the C
  library's in float64, and numpy's may be SIMD code of its own, so CPU
  tensors go through the C library element by element (``ctypes``, in
  double, rounded to the dtype, as :func:`pow_`), in a Function whose
  derivatives are ``1 - tanh^2``, ``cosh`` and ``sinh``; CUDA tensors go
  through the torch ops. A model written with them (``models.morris_lecar``)
  is bit for bit the whole-solve kernel's host build on the CPU.

Within :func:`cpu_formulas` the helpers take their CPU branch on a tensor of
any device, computing the value with the torch op where the tensor is not on
the CPU: ``ops/fused_model.py`` traces a problem factory so on ``meta``
tensors to write the host build of its model, whose arithmetic, the
derivative formulas of these Functions included, is the eager CPU path's.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import ctypes.util
import functools

import numpy as np
import torch
from torch.autograd import forward_ad


# the longest axis :func:`sum0` adds term by term
SEQUENTIAL_SUM_MAX = 32
# within cpu_formulas(), in this thread (a context variable: another thread's
# solve on the card keeps the card's branch)
_CPU_FORMULAS = contextvars.ContextVar("cpu_formulas", default=False)


@contextlib.contextmanager
def cpu_formulas():
    """The helpers' CPU branch on tensors of every device (module doc)."""
    token = _CPU_FORMULAS.set(True)
    try:
        yield
    finally:
        _CPU_FORMULAS.reset(token)


def _card_branch(x: torch.Tensor) -> bool:
    return x.device.type != "cpu" and not _CPU_FORMULAS.get()


def sum0(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis: strictly left to right up to
    ``SEQUENTIAL_SUM_MAX`` terms, a pairwise tree beyond (see module doc)."""
    n = t.shape[0]
    if n > SEQUENTIAL_SUM_MAX:
        size = 1 << (n - 1).bit_length()
        if size != n:
            t = torch.cat([t, t.new_zeros((size - n,) + tuple(t.shape[1:]))])
        while size > 1:
            size //= 2
            t = t[:size] + t[size:]
        return t[0]
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def differentiated(*tensors: torch.Tensor) -> bool:
    """True when autograd would record an operation on ``tensors``: a
    forward-mode level is open, or grad mode is on and one of them requires
    grad."""
    return forward_ad._current_level >= 0 or (
        torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


class _SqrtCPU(torch.autograd.Function):
    """numpy's correctly rounded ``sqrt`` on a CPU tensor, differentiable."""

    @staticmethod
    def forward(x):
        if x.device.type != "cpu":  # traced within cpu_formulas()
            return torch.sqrt(x)
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (0.5 / y)

    @staticmethod
    def jvp(ctx, t):
        (y,) = ctx.saved_tensors
        return t * (0.5 / y)

    @staticmethod
    def vmap(info, in_dims, x):
        return _SqrtCPU.apply(x), in_dims[0]


class _SinCPU(torch.autograd.Function):
    """The C library's ``sin`` (through numpy) on a CPU tensor, differentiable."""

    @staticmethod
    def forward(x):
        if x.device.type != "cpu":  # traced within cpu_formulas()
            return torch.sin(x)
        return torch.from_numpy(np.asarray(np.sin(x.detach().numpy())))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * cos_(x)

    @staticmethod
    def jvp(ctx, t):
        (x,) = ctx.saved_tensors
        return t * cos_(x)

    @staticmethod
    def vmap(info, in_dims, x):
        return _SinCPU.apply(x), in_dims[0]


class _CosCPU(torch.autograd.Function):
    """The C library's ``cos`` (through numpy) on a CPU tensor, differentiable."""

    @staticmethod
    def forward(x):
        if x.device.type != "cpu":  # traced within cpu_formulas()
            return torch.cos(x)
        return torch.from_numpy(np.asarray(np.cos(x.detach().numpy())))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return -(g * sin_(x))

    @staticmethod
    def jvp(ctx, t):
        (x,) = ctx.saved_tensors
        return -(t * sin_(x))

    @staticmethod
    def vmap(info, in_dims, x):
        return _CosCPU.apply(x), in_dims[0]


def sin_(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``sin`` rounded as the C library's (see module doc)."""
    if _card_branch(x):
        return torch.sin(x)
    if differentiated(x) or _wrapped(x):
        return _SinCPU.apply(x)
    return _SinCPU.forward(x)


def cos_(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``cos`` rounded as the C library's (see module doc)."""
    if _card_branch(x):
        return torch.cos(x)
    if differentiated(x) or _wrapped(x):
        return _CosCPU.apply(x)
    return _CosCPU.forward(x)


def _wrapped(x: torch.Tensor) -> bool:
    """Whether ``x`` is a ``torch.func`` transform's wrapper (a vmapped or
    jvp-tracked tensor), which numpy cannot read."""
    return torch._C._functorch.is_functorch_wrapped_tensor(x)


def sqrt_(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded elementwise square root (see module doc)."""
    if _card_branch(x):
        return torch.sqrt(x)
    if differentiated(x) or _wrapped(x):
        return _SqrtCPU.apply(x)
    return _SqrtCPU.forward(x)


@functools.cache
def _libm_pow():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).pow
    fn.argtypes = [ctypes.c_double, ctypes.c_double]
    fn.restype = ctypes.c_double
    return fn


def _libm_pow_values(b: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    if b.device.type != "cpu":  # traced within cpu_formulas()
        return torch.pow(b, e)
    fn = _libm_pow()
    vals = [fn(x, y) for x, y in zip(b.reshape(-1).tolist(), e.reshape(-1).tolist())]
    return torch.tensor(vals, dtype=b.dtype).reshape(b.shape)


class _PowCPU(torch.autograd.Function):
    """The C library's ``pow`` on CPU tensors of one shape, differentiable."""

    @staticmethod
    def forward(base, expo):
        return _libm_pow_values(base.detach(), expo.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)
        ctx.save_for_forward(*inputs, output)

    @staticmethod
    def backward(ctx, g):
        base, expo, out = ctx.saved_tensors
        g_base = g * (expo * pow_(base, expo - 1.0)) if ctx.needs_input_grad[0] else None
        g_expo = g * (torch.log(base) * out) if ctx.needs_input_grad[1] else None
        return g_base, g_expo

    @staticmethod
    def jvp(ctx, t_base, t_expo):
        base, expo, out = ctx.saved_tensors
        tan = torch.zeros_like(out)
        if t_base is not None:
            tan = tan + t_base * (expo * pow_(base, expo - 1.0))
        if t_expo is not None:
            tan = tan + t_expo * (torch.log(base) * out)
        return tan

    @staticmethod
    def vmap(info, in_dims, base, expo):
        # the two operands share a logical shape: lay both out batch-first
        def lead(x, d):
            return x.expand((info.batch_size,) + tuple(x.shape)) if d is None else x.movedim(d, 0)

        return _PowCPU.apply(lead(base, in_dims[0]), lead(expo, in_dims[1])), 0


def pow_(base: torch.Tensor, expo) -> torch.Tensor:
    """Elementwise ``base ** expo`` in ``base``'s dtype (see module doc);
    ``expo`` is a tensor or a number."""
    if _card_branch(base):
        return torch.pow(base, expo)
    if base.device.type != "cpu" and not isinstance(expo, torch.Tensor):
        expo = torch.full_like(base, expo)  # traced within cpu_formulas()
    expo = torch.as_tensor(expo, dtype=base.dtype)
    b, e = torch.broadcast_tensors(base, expo.to(base.dtype))
    if differentiated(b, e) or _wrapped(b) or _wrapped(e):
        return _PowCPU.apply(b, e)
    return _libm_pow_values(b, e)


@functools.cache
def _libm_unary(name: str):
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.argtypes = [ctypes.c_double]
    fn.restype = ctypes.c_double
    return fn


def _libm_values(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu":  # traced within cpu_formulas()
        return getattr(torch, name)(x)
    fn = _libm_unary(name)
    vals = [fn(v) for v in x.detach().reshape(-1).tolist()]
    return torch.tensor(vals, dtype=x.dtype).reshape(x.shape)


def _libm_function(name: str, derivative) -> type[torch.autograd.Function]:
    """A Function computing the C library's ``name`` on a CPU tensor, with
    the derivative ``derivative(x, y)`` at ``y = name(x)``."""

    class LibmCPU(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return _libm_values(name, x)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(inputs[0], output)
            ctx.save_for_forward(inputs[0], output)

        @staticmethod
        def backward(ctx, g):
            return g * derivative(*ctx.saved_tensors)

        @staticmethod
        def jvp(ctx, t):
            return t * derivative(*ctx.saved_tensors)

        @staticmethod
        def vmap(info, in_dims, x):
            return LibmCPU.apply(x), in_dims[0]

    LibmCPU.__name__ = LibmCPU.__qualname__ = f"_{name.capitalize()}CPU"
    LibmCPU.__doc__ = f"The C library's ``{name}`` on a CPU tensor, differentiable."
    return LibmCPU


_TanhCPU = _libm_function("tanh", lambda x, y: 1.0 - y * y)
_SinhCPU = _libm_function("sinh", lambda x, y: cosh_(x))
_CoshCPU = _libm_function("cosh", lambda x, y: sinh_(x))


def _libm_op(fn: type[torch.autograd.Function], name: str, x: torch.Tensor) -> torch.Tensor:
    if _card_branch(x):
        return getattr(torch, name)(x)
    if differentiated(x) or _wrapped(x):
        return fn.apply(x)
    return fn.forward(x)


def tanh_(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``tanh`` rounded as the C library's (see module doc)."""
    return _libm_op(_TanhCPU, "tanh", x)


def sinh_(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``sinh`` rounded as the C library's (see module doc)."""
    return _libm_op(_SinhCPU, "sinh", x)


def cosh_(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``cosh`` rounded as the C library's (see module doc)."""
    return _libm_op(_CoshCPU, "cosh", x)
