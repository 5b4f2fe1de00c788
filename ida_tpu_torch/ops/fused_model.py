"""A problem factory compiled into the whole-solve kernel's model.

Counterpart of the problem tracing of ``ida_tpu/ops/fused_solve.py``: the
TPU kernel calls ``problem_factory(params)`` inside its body and traces
``core_solve`` on the result, so it takes any batch-native factory with an
analytic Jacobian and no roots, quadratures included. The CUDA kernel
(``csrc/fused_solve.cu`` over ``csrc/ida_lane.cuh``) is a template over a
model type with the interface of its hand-written ``struct Roberts``
(``N``, ``P``, ``NQ``, ``id(i)``, ``res``, ``res_jvp``, ``jac`` and, where
``NQ > 0``, ``quad``; one lane's scalars); :func:`generate` writes that
struct from the factory's own torch code:

* the factory is called inside ``make_fx`` on ``meta`` tensors of two lanes
  (params [P, 2], t and cj [2], the vectors [N, 2]), capturing ``res``,
  ``jac``, the jvp of ``res`` in (yy, yp) with tangents (v, w), the J v
  that ``ls_precision="refined"`` takes (core/nls.py ``_res_jvp``), and
  ``quad`` (the integrand of ``core/quad.py``). On
  ``meta`` the helpers of ``utils/numerics.py`` take the card's branch, so
  ``pow_``/``sqrt_``/``sin_``/``cos_`` appear as the aten ops they call there;
* the aten graph is run on symbols: every element of every value is a
  scalar expression of one lane, views and copies move expressions
  around, each arithmetic op makes one new expression (identical ones are
  shared). Forward AD's zero tangents leave no live op in the graph, so
  what reaches the outputs is exactly what the eager jvp computes. A
  comparison makes a boolean expression, which only ``where``,
  ``masked_fill``, logic (``&``, ``|``, ``~``) and a cast to the dtype
  consume; a boolean that reaches arithmetic or an output is refused;
* the two lanes must come out as the same code, each reading its own lane
  only: an op that reduces over the lane axis, or reads another lane, is
  refused;
* the expressions of lane 0 are written out as C++, one rounded operation
  on ``ida::Real`` each (``csrc/model_ops.cuh``), in the graph's order.
  Where ATen's CUDA kernel and the eager CPU path round differently (a
  tensor divided by a Python number, ``pow`` at 0.5, 2, 3, -0.5, -1, -2)
  the helper does on each device what the eager op does there: the card
  build follows ATen's CUDA kernels, the host build
  (tests/test_torch_fused_host.py) the eager port on the CPU, where
  ``numerics.pow_``/``sqrt_``/``sin_``/``cos_``/``tanh_``/``sinh_``/``cosh_``
  call the C library (ATen's own CPU ``tanh`` ... are 1-3 ulp from it).

``id`` comes from a plain CPU call of the factory and must be the same in
every lane. What the kernel cannot take raises ``NotImplementedError``
naming the reason: no analytic ``jac``, roots, N above ``MAXN``, a per-lane
``id``, an op that reduces over or reads across lanes, a dtype change, a
boolean in arithmetic or an output, a NaN as a ``clamp`` bound, a tensor
constant the trace cannot read, and any aten op not in :data:`KNOWN_OPS`.
"""

from __future__ import annotations

import contextlib
import hashlib
import operator
import re
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..models.roberts import roberts_factory
from ..utils import numerics

MAXN = 16  # csrc/ida_lane.cuh MAXN
LANES = 2  # lanes of the trace: two, so that an op across lanes shows
TRACE_DTYPE = torch.float64
# the typed trace of the jvp: the params in TRACE_DTYPE ("T"), its other
# inputs in NARROW_DTYPE ("S"), as ls_precision "single" calls it
NARROW_DTYPE = torch.float32
_KINDS = {TRACE_DTYPE: "T", NARROW_DTYPE: "S"}


@dataclass(frozen=True)
class FusedModel:
    """The model a kernel library compiles in: ``name`` (the key of the
    launch counters), ``id`` (what the entry points check; 0 is the
    hand-written Roberts), ``n`` components, ``p`` parameters a lane, and
    the generated header (None: the hand-written Roberts of
    ``fused_solve.cu``); ``nq`` quadratures (``Model::NQ``: the state's
    ``yQ`` [B, nq] the kernel accumulates); ``jtimes`` and ``prec``: the
    factory brings its own Jacobian-times-vector or a preconditioner, which
    the Krylov path would call and the kernel does not compile in."""
    name: str
    id: int
    n: int
    p: int
    header: str | None = None
    nq: int = 0
    jtimes: bool = False
    prec: bool = False


ROBERTS = FusedModel("roberts", 0, 3, 3)

# the elementwise ops of the emitter: aten name -> C++ of one lane
_UNARY = {
    "neg": "-{0}", "abs": "ida::absval({0})", "reciprocal": "ida::model::recip({0})",
    "sqrt": "ida::sqrt_of({0})", "rsqrt": "ida::model::rsqrt({0})",
    "exp": "ida::model::exp({0})", "log": "ida::model::log({0})",
    "sin": "ida::model::sin({0})", "cos": "ida::model::cos({0})",
    "sgn": "ida::model::sign({0})", "sign": "ida::model::sign({0})",
    **{f: f"ida::model::{f}({{0}})" for f in ("tanh", "sinh", "cosh", "tan", "atan", "expm1",
                                              "log1p")},
}
_BINARY = {"add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
           "div": "({0} / {1})", "pow": "ida::model::pow_tensor({0}, {1})",
           "maximum": "ida::model::maximum({0}, {1})",
           "minimum": "ida::model::minimum({0}, {1})",
           "tanh_backward": "ida::model::tanh_backward({0}, {1})"}
# the boolean expressions: comparisons of numbers, and logic of booleans;
# only where (and masked_fill), logic and a cast to the dtype consume them
_COMPARE = {"gt": "({0} > {1})", "ge": "({0} >= {1})", "lt": "({0} < {1})",
            "le": "({0} <= {1})", "eq": "({0} == {1})", "ne": "({0} != {1})"}
_LOGIC = {"logical_and": "({0} && {1})", "logical_or": "({0} || {1})",
          "logical_xor": "({0} != {1})", "logical_not": "(!{0})"}
_BOOLEAN = frozenset(_COMPARE) | frozenset(_LOGIC)
_TERNARY = {"where": "({0} ? {1} : {2})", "clamp_s": "ida::model::clamp_scalar({0}, {1}, {2})",
            "clamp_t": "ida::model::clamp_tensor({0}, {1}, {2})"}
# ops that may make a boolean tensor (of booleans, or comparing numbers)
_BOOL_RESULT = _BOOLEAN | {
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and_", "logical_or_",
    "bitwise_and_", "bitwise_or_", "alias", "clone", "detach", "lift_fresh_copy", "expand",
    "select", "slice", "unsqueeze", "squeeze", "view", "reshape", "_unsafe_view", "permute",
    "transpose", "t", "stack", "cat", "split", "split_with_sizes", "unbind", "_to_copy"}
_REDUCTIONS = {"sum", "mean", "prod", "amax", "amin", "max", "min", "linalg_vector_norm",
               "norm", "var", "std", "var_mean", "std_mean", "logsumexp", "cumsum", "cumprod",
               "any", "all", "argmax", "argmin", "nansum", "softmax", "_softmax",
               "log_softmax", "_log_softmax"}
# ops traced for their side checks only; nothing reads their result
_IGNORED = {"is_same_size", "_has_same_storage_numel"}


def _refuse(why: str):
    raise NotImplementedError(f"fused_solve: the whole-solve kernel cannot compile in this "
                              f"factory: {why}")


class _Exprs:
    """Scalar expressions of the trace, each made once: ``("in", name, i,
    lane)`` inputs, ``("c", hex)`` constants, ``(op, args, scalar, kind)``
    ops (``kind``: "T" or "S", the dtype a typed trace computes the op in;
    None in an untyped trace)."""

    def __init__(self):
        self.index: dict = {}
        self.nodes: list = []
        self.lanes: list = []

    def add(self, key: tuple, lanes: frozenset) -> int:
        k = self.index.get(key)
        if k is None:
            k = self.index[key] = len(self.nodes)
            self.nodes.append(key)
            self.lanes.append(lanes)
        return k

    def sym(self, name: str, i, lane: int) -> int:
        return self.add(("in", name, i, lane), frozenset((lane,)))

    def const(self, value: float) -> int:
        return self.add(("c", float(value).hex()), frozenset())

    def op(self, name: str, args: tuple, scalar=None, kind=None) -> int:
        lanes = frozenset().union(*(self.lanes[a] for a in args))
        return self.add((name, args, None if scalar is None else float(scalar).hex(), kind),
                        lanes)

    def kind(self, e: int):
        """"T" or "S", the dtype an expression of a typed trace is in (an
        input's by its name), or None (a constant, an untyped op)."""
        key = self.nodes[e]
        if key[0] == "in":
            return "T" if key[1] == "p" else "S"
        return None if key[0] == "c" else key[3]

    def is_bool(self, e: int) -> bool:
        return self.nodes[e][0] in _BOOLEAN


def _obj(x) -> np.ndarray:
    a = np.empty((), dtype=object)
    a[()] = x
    return a


def _arr(x) -> np.ndarray:
    """``x`` as an array: numpy hands back a lone object element as itself."""
    return x if isinstance(x, np.ndarray) else _obj(x)


class _Interpreter:
    """Runs an aten graph of ``make_fx`` on arrays of expression ids. With
    ``typed`` the graph was traced on inputs of two dtypes (:data:`_KINDS`),
    and each op's expressions carry the dtype the graph computes it in."""

    def __init__(self, ex: _Exprs, gm: torch.fx.GraphModule, what: str, typed: bool = False):
        self.ex, self.gm, self.what, self.typed = ex, gm, what, typed
        self.kind = None  # the kind of the node being run (typed only)

    def run(self, inputs: list) -> np.ndarray:
        graph = self.gm.graph
        graph.eliminate_dead_code()
        env: dict = {}
        it = iter(inputs)
        for node in graph.nodes:
            if node.op == "placeholder":
                env[node] = next(it)
            elif node.op == "get_attr":
                env[node] = self.constant(getattr(self.gm, node.target), node.target)
            elif node.op == "call_function":
                args = torch.fx.node.map_arg(node.args, lambda n: env[n])
                kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
                env[node] = self.call(node, args, kwargs)
            elif node.op == "output":
                (out,) = node.args
                return env[out]
            else:
                _refuse(f"{self.what}: a graph node of kind {node.op!r}")
        raise AssertionError("a traced graph without an output")

    def constant(self, t, name):
        if not isinstance(t, torch.Tensor) or t.device.type == "meta" or t.is_complex():
            # evaluated lazily: a dead constant does no harm
            return _Unreadable(f"{self.what}: the tensor constant {name} (made from data on the "
                               "trace's device, so its values are not known); write constants "
                               "as Python numbers or with torch.full_like")
        vals = t.detach().to("cpu", torch.float64).numpy()
        return np.vectorize(self.ex.const, otypes=[object])(vals) if vals.size else \
            np.empty(vals.shape, dtype=object)

    def call(self, node, args, kwargs):
        target = node.target
        if target is operator.getitem:
            return args[0][args[1]]
        if not isinstance(target, torch._ops.OpOverload):
            _refuse(f"{self.what}: the call {target!r}")
        ns, name = target.namespace, target.overloadpacket.__name__
        if ns not in ("aten", "prims"):
            _refuse(f"{self.what}: the op {ns}.{name}")
        for a in list(args) + list(kwargs.values()):
            for x in (a if isinstance(a, (list, tuple)) else [a]):
                if isinstance(x, _Unreadable):
                    _refuse(x.why)
        val = node.meta.get("val")
        self.kind = None
        for v in (val if isinstance(val, (list, tuple)) else [val]):
            if isinstance(v, torch.Tensor) and self.typed and v.dtype in _KINDS:
                self.kind = _KINDS[v.dtype]
                continue
            if not isinstance(v, torch.Tensor) or v.dtype == TRACE_DTYPE:
                continue
            if v.dtype != torch.bool or name not in _BOOL_RESULT:
                _refuse(f"{self.what}: {ns}.{name} makes a {v.dtype} tensor (the model's "
                        f"arithmetic is in the state's dtype, and only comparisons and "
                        f"logic make booleans)")
        if name in _IGNORED:
            return None
        if name in _REDUCTIONS:
            self.refuse_reduction(name, args, kwargs)
        if name in _UNARY:
            return self.elementwise(name, args[0])
        fn = getattr(self, f"op_{name}", None)
        if fn is None:
            _refuse(f"{self.what}: the op {ns}.{name} is not one the emitter compiles "
                    f"(ops/fused_model.py KNOWN_OPS)")
        out = fn(*args, **kwargs)
        return [_arr(x) for x in out] if isinstance(out, list) else _arr(out)

    def refuse_reduction(self, name, args, kwargs):
        x = args[0]
        dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
        if isinstance(dims, int):
            dims = [dims]
        lane = _lane_axis(self.ex, x) if isinstance(x, np.ndarray) else None
        if lane is not None and (not dims or any(d % x.ndim == lane for d in dims)):
            _refuse(f"{self.what}: aten.{name} reduces over the lane axis (a lane's model "
                    "must read its own lane only)")
        _refuse(f"{self.what}: aten.{name} reduces over the components (ATen's order of its "
                "terms on the card is not fixed; write the sum out)")

    # -- elementwise
    def elementwise(self, name, *xs, scalar=None, bools=()):
        """``name`` on each element of ``xs`` (arrays of expressions, or
        Python numbers); the arguments at the positions ``bools`` must be
        booleans and the others numbers."""
        arrays = [x if isinstance(x, np.ndarray) else _obj(self.ex.const(x)) for x in xs]
        for i, x in enumerate(arrays):
            if i in bools and not all(self.ex.is_bool(e) for e in x.flat):
                _refuse(f"{self.what}: aten.{name} takes a number where it takes a boolean")
            if i not in bools and any(self.ex.is_bool(e) for e in x.flat):
                _refuse(f"{self.what}: a boolean (a comparison's result) reaches the "
                        f"arithmetic of aten.{name}; select with torch.where, or cast it "
                        "with .to(dtype)")
        f = np.frompyfunc(lambda *a: self.ex.op(name, a, scalar, self.kind), len(arrays), 1)
        return _arr(f(*arrays))

    def inplace(self, x, out):
        """An in-place op's result written into its first argument."""
        if not isinstance(x, np.ndarray) or not x.flags.writeable or x.shape != out.shape:
            _refuse(f"{self.what}: an in-place op on a view the interpreter cannot write")
        x[...] = out
        return x

    # -- comparisons, logic, selection
    def op_gt(self, a, b):
        return self.elementwise("gt", a, b)

    def op_ge(self, a, b):
        return self.elementwise("ge", a, b)

    def op_lt(self, a, b):
        return self.elementwise("lt", a, b)

    def op_le(self, a, b):
        return self.elementwise("le", a, b)

    def op_eq(self, a, b):
        return self.elementwise("eq", a, b)

    def op_ne(self, a, b):
        return self.elementwise("ne", a, b)

    def op_logical_and(self, a, b):
        return self.elementwise("logical_and", a, b, bools=(0, 1))

    def op_logical_or(self, a, b):
        return self.elementwise("logical_or", a, b, bools=(0, 1))

    def op_logical_xor(self, a, b):
        return self.elementwise("logical_xor", a, b, bools=(0, 1))

    def op_logical_not(self, a):
        return self.elementwise("logical_not", a, bools=(0,))

    # on booleans (``&``, ``|``, ``^``, ``~`` of masks) the bitwise ops are the logical ones
    op_bitwise_and, op_bitwise_or = op_logical_and, op_logical_or
    op_bitwise_xor, op_bitwise_not = op_logical_xor, op_logical_not

    def op_logical_and_(self, a, b):
        return self.inplace(a, self.op_logical_and(a, b))

    def op_logical_or_(self, a, b):
        return self.inplace(a, self.op_logical_or(a, b))

    op_bitwise_and_, op_bitwise_or_ = op_logical_and_, op_logical_or_

    def op_where(self, cond, a, b):
        return self.elementwise("where", cond, a, b, bools=(0,))

    def op_masked_fill(self, x, mask, value):
        return self.op_where(mask, value, x)

    def op_tanh_backward(self, grad, out):
        return self.elementwise("tanh_backward", grad, out)

    # -- bounds
    def op_maximum(self, a, b):
        return self.elementwise("maximum", a, b)

    def op_minimum(self, a, b):
        return self.elementwise("minimum", a, b)

    def op_clamp(self, x, min=None, max=None):
        if isinstance(min, np.ndarray) or isinstance(max, np.ndarray):
            # bounds that are tensors (aten.clamp.Tensor): one of them is
            # maximum or minimum, as ATen runs it
            if max is None:
                return self.op_maximum(x, min)
            if min is None:
                return self.op_minimum(x, max)
            return self.elementwise("clamp_t", x, min, max)
        if min is None and max is None:
            _refuse(f"{self.what}: aten.clamp without a bound")
        bounds = [float("-inf") if min is None else float(min),
                  float("inf") if max is None else float(max)]
        if any(v != v for v in bounds):
            _refuse(f"{self.what}: aten.clamp with a NaN number as a bound")
        return self.elementwise("clamp_s", x, *bounds)

    def op_clamp_min(self, x, min):
        return self.op_clamp(x, min=min)

    def op_clamp_max(self, x, max):
        return self.op_clamp(x, max=max)

    def _binary(self, name, a, b, alpha=1):
        if alpha != 1:
            _refuse(f"{self.what}: aten.{name} with alpha={alpha} (ATen's CUDA kernel may "
                    "fuse it into a multiply-add)")
        return self.elementwise(name, a, b)

    def op_add(self, a, b, alpha=1):
        return self._binary("add", a, b, alpha)

    def op_sub(self, a, b, alpha=1):
        return self._binary("sub", a, b, alpha)

    def op_rsub(self, a, b, alpha=1):
        return self._binary("sub", b, a, alpha)

    def op_mul(self, a, b):
        return self.elementwise("mul", a, b)

    def op_div(self, a, b, rounding_mode=None):
        if rounding_mode is not None:
            _refuse(f"{self.what}: aten.div with rounding_mode={rounding_mode!r}")
        if not isinstance(b, np.ndarray):
            # by a Python number: on the card ATen multiplies by its reciprocal
            return self.elementwise("div_scalar", a, scalar=float(b))
        return self.elementwise("div", a, b)

    def op_pow(self, a, b):
        if not isinstance(b, np.ndarray):
            return self.elementwise("pow_scalar", a, scalar=float(b))
        return self.elementwise("pow", a, b)

    # -- views and copies
    def op_alias(self, x):
        return x

    op_clone = op_detach = op_lift_fresh_copy = op_alias

    def op__to_copy(self, x, dtype=None, **_):
        bools = [self.ex.is_bool(e) for e in x.flat]
        if dtype is None or dtype == torch.bool or not any(bools):
            if dtype == torch.bool and not all(bools):
                _refuse(f"{self.what}: a number cast to a boolean")
            if self.typed and dtype in _KINDS:
                # a cast between the two dtypes of a typed trace: widened
                # exactly, or rounded to the narrower one
                want = _KINDS[dtype]
                f = np.frompyfunc(lambda e: e if self.ex.kind(e) in (None, want)
                                  else self.ex.op("convert", (e,), None, want), 1, 1)
                return _arr(f(x))
            return x
        # a boolean cast to the dtype: 1 or 0 (the dtype itself is checked
        # on the node's value)
        f = np.frompyfunc(lambda e: self.ex.op("of_bool", (e,), None, self.kind), 1, 1)
        return _arr(f(x))

    def op_copy(self, x, src, non_blocking=False):
        return np.broadcast_to(src, x.shape)

    def op_select(self, x, dim, index):
        return np.take(x, index, axis=dim)

    def op_slice(self, x, dim=0, start=None, end=None, step=1):
        key = [slice(None)] * x.ndim
        key[dim] = slice(start, end, step)
        return x[tuple(key)]

    def op_unsqueeze(self, x, dim):
        return np.expand_dims(x, dim if dim >= 0 else dim + x.ndim + 1)

    def op_squeeze(self, x, dim=None):
        dims = range(x.ndim) if dim is None else [dim] if isinstance(dim, int) else dim
        drop = tuple(d % x.ndim for d in dims if x.shape[d] == 1) if x.ndim else ()
        return np.squeeze(x, axis=drop) if drop else x

    def op_view(self, x, shape):
        return np.reshape(x, shape)

    op_reshape = op__unsafe_view = op_view

    def op_expand(self, x, size, implicit=False):
        lead = len(size) - x.ndim
        shape = [s if s != -1 else x.shape[i - lead] for i, s in enumerate(size)]
        return np.broadcast_to(x, shape)

    def op_permute(self, x, dims):
        return np.transpose(x, dims)

    def op_transpose(self, x, d0, d1):
        return np.swapaxes(x, d0, d1)

    def op_t(self, x):
        return x.T

    def op_stack(self, xs, dim=0):
        return np.stack(xs, axis=dim)

    def op_cat(self, xs, dim=0):
        return np.concatenate([x for x in xs if x.size or x.ndim > 1], axis=dim)

    def op_split(self, x, split_size, dim=0):
        if not isinstance(split_size, int):
            return self.op_split_with_sizes(x, split_size, dim)
        n = x.shape[dim]
        return self.op_split_with_sizes(x, [min(split_size, n - i)
                                            for i in range(0, n, split_size)], dim)

    def op_split_with_sizes(self, x, sizes, dim=0):
        return np.split(x, np.cumsum(sizes)[:-1], axis=dim)

    def op_unbind(self, x, dim=0):
        return [np.take(x, i, axis=dim) for i in range(x.shape[dim])]

    # -- constants
    def fill(self, shape, value):
        return np.broadcast_to(_obj(self.ex.const(value)), tuple(shape))

    def op_ones_like(self, x, **_):
        return self.fill(x.shape, 1.0)

    def op_zeros_like(self, x, **_):
        return self.fill(x.shape, 0.0)

    def op_full_like(self, x, value, **_):
        return self.fill(x.shape, value)

    def op_new_ones(self, x, size, **_):
        return self.fill(size, 1.0)

    def op_new_zeros(self, x, size, **_):
        return self.fill(size, 0.0)

    def op_new_full(self, x, size, value, **_):
        return self.fill(size, value)

    def op_ones(self, size, **_):
        return self.fill(size, 1.0)

    def op_zeros(self, size, **_):
        return self.fill(size, 0.0)

    op__efficientzerotensor = op_zeros

    def op_full(self, size, value, **_):
        return self.fill(size, value)

    def op_scalar_tensor(self, value, **_):
        return self.fill((), value)


# the aten (and prims) ops the emitter compiles, by name: the rest raise
KNOWN_OPS = frozenset(_UNARY) | {m[3:] for m in vars(_Interpreter) if m.startswith("op_")}


class _Unreadable:
    def __init__(self, why: str):
        self.why = why


def _lane_axis(ex: _Exprs, x: np.ndarray):
    """The axis of ``x`` along which its elements belong to lanes 0, 1, ...
    one by one, or None."""
    for a in range(x.ndim):
        if x.shape[a] != LANES:
            continue
        if all(all(ex.lanes[e] <= {lane} for e in np.take(x, [lane], axis=a).flat)
               for lane in range(LANES)) and any(ex.lanes[e] for e in x.flat):
            return a
    return None


def _trace(fn, *shapes, dtypes=None) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx

    dtypes = dtypes or [TRACE_DTYPE] * len(shapes)
    args = [torch.empty(s, dtype=dt, device="meta") for s, dt in zip(shapes, dtypes)]
    return make_fx(fn)(*args)


def _inputs(ex: _Exprs, name: str, n: int | None) -> np.ndarray:
    if n is None:
        return np.array([ex.sym(name, None, lane) for lane in range(LANES)], dtype=object)
    return np.array([[ex.sym(name, i, lane) for lane in range(LANES)] for i in range(n)],
                    dtype=object)


def _lane_code(ex: _Exprs, out: np.ndarray, shape: tuple, what: str) -> np.ndarray:
    """The expressions of lane 0 of ``out`` (shape ``shape`` + [lanes]);
    refuses an output that reads across lanes or whose lanes differ."""
    if out.shape != shape + (LANES,):
        _refuse(f"{what} returns shape {list(out.shape)} for {LANES} lanes, not "
                f"{list(shape + (LANES,))}")
    lane0 = out[..., 0]
    for lane in range(LANES):
        for e in out[..., lane].flat:
            if not ex.lanes[e] <= {lane}:
                _refuse(f"{what} reads across lanes (an op that reduces over or indexes the "
                        "lane axis; a lane's model must read its own lane only)")
    # lane 1's expressions rewritten on lane 0's inputs, in the order they
    # were made (an op's arguments come before it)
    relabeled: dict = {}
    for e in sorted(_reachable(ex, out[..., 1].flat)):
        key = ex.nodes[e]
        if key[0] == "in":
            relabeled[e] = ex.sym(key[1], key[2], 0)
        elif key[0] == "c":
            relabeled[e] = e
        else:
            relabeled[e] = ex.op(key[0], tuple(relabeled[a] for a in key[1]),
                                 None if key[2] is None else float.fromhex(key[2]), key[3])
    for e0, e1 in zip(lane0.flat, out[..., 1].flat):
        if relabeled[e1] != e0:
            _refuse(f"{what} computes lane 1 differently from lane 0")
    return lane0


def _reachable(ex: _Exprs, roots) -> set:
    """The expressions ``roots`` are made of, themselves included."""
    seen: set = set()
    stack = list(roots)
    while stack:
        e = stack.pop()
        if e in seen:
            continue
        seen.add(e)
        if ex.nodes[e][0] not in ("in", "c"):
            stack.extend(ex.nodes[e][1])
    return seen


_ARG = {"p": "p[{}]", "t": "t", "cj": "cj", "yy": "yy[{}]", "yp": "yp[{}]", "rr": "rr[{}]",
        "v": "v[{}]", "w": "w[{}]"}


def _types(ex: _Exprs, need: set) -> dict:
    """The C++ type of each expression of ``need`` of a typed trace: "T" or
    "S" (the dtype the graph computes it in), None for a constant (written
    in the type of what it meets), "bool" for a boolean."""
    return {e: "bool" if ex.is_bool(e) else ex.kind(e) for e in need}


def _cxx(ex: _Exprs, outputs: dict, typed: bool = False) -> list[str]:
    """C++ statements computing ``outputs`` (C++ lvalue -> expression id),
    one rounded operation a statement, in the graph's order. With ``typed``
    (a typed trace) the parameters are of type ``T`` and the other inputs of
    type ``S`` (the outputs ``T``): each operation runs in the type the
    trace ran it in, a narrower operand widened by ``ida::promote<T>`` as
    torch promotes it (a constant written in the operation's type), a cast
    between the two an op of its own; without, everything is ``T``."""
    need = _reachable(ex, outputs.values())
    types = _types(ex, need) if typed else {}

    def ref(e: int, want: str | None = None) -> str:
        """``e`` as an operand of type ``want`` (None: as it is)."""
        key = ex.nodes[e]
        if key[0] == "c":
            return f"{want or 'T'}({_literal(float.fromhex(key[1]))})"
        name = _ARG[key[1]].format(key[2]) if key[0] == "in" else f"e{e}"
        return f"ida::promote<T>({name})" if typed and want == "T" and types[e] == "S" else name

    def of(args) -> str:
        """The type of an operation on ``args`` (numbers)."""
        return "T" if any(types[x] == "T" for x in args) else "S"

    lines = []
    for e in sorted(need):
        key = ex.nodes[e]
        if key[0] in ("in", "c"):
            continue
        op, args, scalar, kind = key
        if not typed or op in _LOGIC or op in ("of_bool", "convert"):
            a = [ref(x) for x in args]
        elif op in _COMPARE:
            # a comparison runs in the type its operands promote to
            want = of(args)
            a = [ref(x, want) for x in args]
        elif op == "where":
            a = [ref(args[0])] + [ref(x, kind) for x in args[1:]]
        else:
            a = [ref(x, kind) for x in args]
        if op in _BOOLEAN:
            code = (_COMPARE.get(op) or _LOGIC[op]).format(*a)
            lines.append(f"const bool e{e} = {code};")
            continue
        if op in _UNARY:
            code = _UNARY[op].format(*a)
        elif op in _BINARY:
            code = _BINARY[op].format(*a)
        elif op in _TERNARY:
            code = _TERNARY[op].format(*a)
        elif op == "of_bool":
            code = f"({a[0]} ? {kind or 'T'}(1.0) : {kind or 'T'}(0.0))"
        elif op == "convert":
            code = f"ida::promote<T>({a[0]})" if kind == "T" else f"ida::narrow<S>({a[0]})"
        elif op == "div_scalar":
            code = f"ida::model::div_scalar({a[0]}, {_literal(float.fromhex(scalar))})"
        elif op == "pow_scalar":
            code = f"ida::model::pow_scalar({a[0]}, {_literal(float.fromhex(scalar))})"
        else:  # pragma: no cover - every op the interpreter makes is above
            raise AssertionError(op)
        lines.append(f"const {types.get(e, 'T')} e{e} = {code};")
    lines += [f"{lhs} = {ref(e, 'T')};" for lhs, e in outputs.items()]
    return lines


def _literal(v: float) -> str:
    if v != v:
        return "NAN"
    if v in (float("inf"), float("-inf")):
        return "INFINITY" if v > 0 else "-INFINITY"
    return repr(v)


_TEMPLATE = """\
// Generated by ida_tpu_torch/ops/fused_model.py: do not edit. res, jac,
// res_jvp and quad (NQ > 0) of one lane in the order of operations of a
// problem factory's torch code (aten graph of make_fx), one rounded
// operation on ida::Real a statement (csrc/model_ops.cuh, which
// fused_solve.cu includes first); where the card's eager path and the CPU's
// differ, the CPU's under #else (the host build of the tests).
#pragma once

struct GeneratedModel {{
  static constexpr int N = {n};
  static constexpr int P = {p};
  static constexpr int NQ = {nq};
  static constexpr int kId = {id};
  __device__ static bool id(int i) {{ return ((0x{id_mask:x}u >> i) & 1u) != 0; }}

  template <typename T>
  __device__ static void res(const T (&p)[P], T t, const T (&yy)[N], const T (&yp)[N],
                             T (&r)[N]) {{
{res}
  }}

  // the arguments but the params of type S (float32 under ls_precision
  // "single"), each operation in the type torch promotes its operands to
  template <typename T, typename S>
  __device__ static void res_jvp(const T (&p)[P], S t, const S (&yy)[N], const S (&yp)[N],
                                 const S (&v)[N], const S (&w)[N], T (&jv)[N]) {{
{jvp}
  }}

  template <typename T>
  __device__ static void jac(const T (&p)[P], T t, T cj, const T (&yy)[N], const T (&yp)[N],
                             const T (&rr)[N], T (&J)[N][N]) {{
{jac}
  }}
{quad}}};
"""
_QUAD = """
  template <typename T>
  __device__ static void quad(const T (&p)[P], T t, const T (&yy)[N], const T (&yp)[N],
                              T (&q)[NQ]) {{
{quad}
  }}
"""


def _indent(lines: list[str]) -> str:
    return "\n".join(f"    {s}" for s in lines)


def _id_mask(problem, n: int) -> int:
    """The differential components as bits; refuses an id that differs
    between lanes."""
    if problem.id is None:
        return (1 << n) - 1
    ids = torch.as_tensor(problem.id).to("cpu", torch.bool)
    if ids.shape[0] != n:
        _refuse(f"id has {ids.shape[0]} components, not N = {n}")
    flat = ids.reshape(n, -1)
    if not bool((flat == flat[:, :1]).all()):
        _refuse("a per-lane id (the kernel compiles one differential/algebraic split into "
                "every lane)")
    return sum(1 << i for i in range(n) if bool(flat[i, 0]))


def _source_name(factory) -> str:
    name = getattr(factory, "__qualname__", None) or type(factory).__name__
    return re.sub(r"\W+", "_", name).strip("_") or "model"


def generate(problem_factory, params: torch.Tensor) -> FusedModel:
    """The model of ``problem_factory`` for params [P, B] (any device): its
    ``id`` from a plain CPU call, ``res``, ``jac`` and the jvp of ``res``
    traced and emitted (module doc). Raises ``NotImplementedError`` on what
    the kernel cannot take."""
    params = torch.as_tensor(params)
    if params.dim() != 2:
        raise ValueError(f"fused_solve: params must be [P, B], got {list(params.shape)}")
    problem = problem_factory(params.detach().to("cpu"))
    n, npar, nq = problem.n, params.shape[0], problem.nquad
    if problem.jac is None:
        _refuse("it has no analytic jac (as ida_tpu's kernel, which cannot carry the "
                "[N, N, B] Jacobian of forward-mode AD)")
    if problem.nroots:
        _refuse("rootfinding (nroots > 0) is not supported in the fused kernel path; use "
                "parallel.make_ensemble_solve for problems with events")
    if n > MAXN:
        _refuse(f"N = {n} components, above the kernel's MAXN = {MAXN}")
    id_mask = _id_mask(problem, n)

    def res(p, t, yy, yp):
        return problem_factory(p).res(t, yy, yp)

    def jac(p, t, cj, yy, yp, rr):
        return problem_factory(p).jac(t, cj, yy, yp, rr)

    def jvp(p, t, yy, yp, v, w):
        prob = problem_factory(p)
        return torch.func.jvp(lambda y, ydot: prob.res(t, y, ydot), (yy, yp), (v, w))[1]

    def quad(p, t, yy, yp):
        return problem_factory(p).quad(t, yy, yp)

    ex = _Exprs()
    ins = {k: _inputs(ex, k, m) for k, m in
           (("p", npar), ("t", None), ("cj", None), ("yy", n), ("yp", n), ("rr", n), ("v", n),
            ("w", n))}
    fns = {"res": (res, ("p", "t", "yy", "yp"), (n,)),
           "jac": (jac, ("p", "t", "cj", "yy", "yp", "rr"), (n, n)),
           "jvp": (jvp, ("p", "t", "yy", "yp", "v", "w"), (n,))}
    outs = {"res": lambda r: {f"r[{i}]": r[i] for i in range(n)},
            "jac": lambda J: {f"J[{i}][{j}]": J[i, j] for i in range(n) for j in range(n)},
            "jvp": lambda jv: {f"jv[{i}]": jv[i] for i in range(n)},
            "quad": lambda q: {f"q[{i}]": q[i] for i in range(nq)}}
    if nq:
        fns["quad"] = (quad, ("p", "t", "yy", "yp"), (nq,))
    # the card's trace, and the CPU's (numerics' CPU Functions and their
    # derivative formulas) for the host build; one body where they agree.
    # The jvp is traced with its arguments but the params in NARROW_DTYPE,
    # as the Krylov operator and the band Jacobian call it under
    # ls_precision "single": each op then carries the dtype torch computes
    # it in (res_jvp<T, S>, S = T in every other call)
    text = {}
    for key, (fn, names, shape) in fns.items():
        what = {"jvp": "the jvp of res"}.get(key, key)
        shapes = [(npar, LANES) if k == "p" else (LANES,) if k in ("t", "cj") else (n, LANES)
                  for k in names]
        typed = key == "jvp"
        dtypes = [TRACE_DTYPE if k == "p" or not typed else NARROW_DTYPE for k in names]
        bodies = []
        for formulas in (contextlib.nullcontext, numerics.cpu_formulas):
            try:
                with formulas():
                    gm = _trace(fn, *shapes, dtypes=dtypes)
            except Exception as err:  # noqa: BLE001 - the factory's own failure, named
                _refuse(f"tracing {what} on meta tensors failed: {type(err).__name__}: {err}")
            out = _Interpreter(ex, gm, what, typed).run([ins[k] for k in names])
            if not isinstance(out, np.ndarray):
                _refuse(f"{what} returns {type(out).__name__}, not a tensor")
            if any(ex.is_bool(e) for e in out.flat):
                _refuse(f"{what} returns a boolean (a comparison's result); select with "
                        "torch.where, or cast it with .to(dtype)")
            bodies.append(_cxx(ex, outs[key](_lane_code(ex, out, shape, what)), typed=typed))
        card, host = (_indent(b) for b in bodies)
        text[key] = card if card == host else (
            f"#ifdef __CUDA_ARCH__\n{card}\n#else\n{host}\n#endif")
    source = _source_name(problem_factory)
    digest = hashlib.sha256(repr((n, npar, nq, id_mask, text)).encode()).hexdigest()
    model_id = int(digest[:7], 16) | 1  # nonzero: 0 is the hand-written Roberts
    text["quad"] = _QUAD.format(quad=text["quad"]) if nq else ""
    header = _TEMPLATE.format(n=n, p=npar, nq=nq, id=model_id, id_mask=id_mask, **text)
    return FusedModel(f"{source}_{digest[:8]}", model_id, n, npar, header, nq,
                      jtimes=problem.jtimes_fn is not None or problem.jtimes_setup is not None,
                      prec=problem.prec_setup is not None or problem.prec_solve is not None)


_MODELS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def model_of(problem_factory, params: torch.Tensor) -> FusedModel:
    """The model of ``problem_factory`` with params [P, B]: the hand-written
    Roberts for ``models.roberts_factory``, else :func:`generate`'s, made
    once per factory object and P."""
    npar = torch.as_tensor(params).shape[0]
    if problem_factory is roberts_factory and npar == ROBERTS.p:
        return ROBERTS
    try:
        per_p = _MODELS.setdefault(problem_factory, {})
    except TypeError:  # not weakly referable: not cached
        return generate(problem_factory, params)
    if npar not in per_p:
        per_p[npar] = generate(problem_factory, params)
    return per_p[npar]
