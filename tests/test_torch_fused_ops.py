"""The kinetics/neuron ops the whole-solve kernel's emitter compiles
(``ida_tpu_torch/ops/fused_model.py``, ``csrc/model_ops.cuh``), on the CPU.

``ida_tpu``'s kernel traces a factory that calls ``jnp.tanh`` or
``jnp.maximum``; the port's emitter now takes ``tanh``, ``sinh``, ``cosh``,
``tan``, ``atan``, ``expm1``, ``log1p``, ``maximum``, ``minimum``, ``clamp``
(numbers or tensors as bounds, ``clamp_min``/``clamp_max``) and ``where``
over the comparisons and the logic of masks, with every op their jvps leave
in the traced graph (``tanh_backward``, ``logical_and``, a mask cast to the
dtype, ...). A boolean is its own kind of expression there: only ``where``,
``masked_fill``, logic and a cast to the dtype take one.

* The host build's table of ops (``ops_zoo_factory``: one row an op, its
  value alone in ``res``, its tangent in J v) on 4,096 lanes in float64 and
  float32, a quarter of them NaN, +-0 or +-inf: bit for bit the eager CPU op
  in every row but the transcendental ones, where ATen's vectorised CPU
  functions are not the C library's that the host build calls (``tanh``,
  ``sinh``, ``cosh``, ``tan``, ``atan``, ``expm1``, ``log1p``): there within
  ``HOST_ULPS`` ulp, special values equal. On the card every row is bit for
  bit (``chip_smoke.py`` ``fused_quad_ops``, the ``cuda`` tests).
* ``utils.numerics.tanh_``/``sinh_``/``cosh_`` are the C library's on the
  CPU, differentiable (a model written with them, Morris-Lecar, is bit for
  bit on the host build).
* Every aten op that the new ops and their jvps leave in a ``make_fx``
  graph is one the emitter compiles.
* A boolean that reaches the residual or arithmetic, a number cast to a
  boolean and a NaN as a bound are refused, naming the reason.
"""

import contextlib
import ctypes
import ctypes.util
import dataclasses

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from chip_smoke import SPECIAL_EVERY, ops_zoo_factory, special_lanes
from ida_tpu_torch.models import roberts_factory
from ida_tpu_torch.ops import fused_model, fused_solve
from ida_tpu_torch.parallel import ensemble_init
from ida_tpu_torch.problem import IdaProblem
from ida_tpu_torch.tol_control import tol_ss
from ida_tpu_torch.utils import numerics
from test_torch_fused_host import host_build

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

LANES = 4096
# the zoo's rows whose op the host build computes with the C library and
# ATen's CPU kernel with vectorised code of its own (its tanh is within 2
# ulp of the C library's in float64): within HOST_ULPS there, values, the
# Jacobian's entries and tangents alike; every other row is bit for bit
TRANSCENDENTAL_ROWS = (0, 1, 2, 3, 4, 5, 6, 15)
HOST_ULPS = 4


def zoo_inputs(dtype, seed=15):
    """params [2, LANES], t, cj [LANES], yy, yp, v [16, LANES] (special lanes)."""
    rng = np.random.default_rng(seed)

    def lanes(x):
        return torch.as_tensor(x, dtype=dtype).contiguous()

    params = np.array([0.3, 1.3])[:, None] * np.exp(rng.uniform(-0.2, 0.2, (2, LANES)))
    yy = special_lanes(rng.normal(size=(16, LANES)) * 0.3, 0)
    yp = special_lanes(rng.normal(size=(16, LANES)), 2)
    v = special_lanes(rng.normal(size=(16, LANES)), 4)
    return (lanes(params), lanes(rng.uniform(0.0, 5.0, LANES)),
            lanes(np.exp(rng.uniform(-3.0, 5.0, LANES))), lanes(yy), lanes(yp), lanes(v))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Units in the last place between ``a`` and ``b`` elementwise (0 where
    both are NaN; +0 and -0 one apart)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}[a.dtype]

    def ordered(x):
        i = x.view(ints).to(torch.int64)
        top = 1 << (63 if ints == torch.int64 else 31)
        return torch.where(i < 0, -(i + top) - 1, i) if ints == torch.int32 else \
            torch.where(i < 0, -(i ^ torch.iinfo(torch.int64).min) - 1, i)

    d = (ordered(a) - ordered(b)).abs().numpy()
    d[(torch.isnan(a) & torch.isnan(b)).numpy()] = 0
    d[(torch.isnan(a) ^ torch.isnan(b)).numpy()] = np.iinfo(np.int64).max
    return d


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_host_build_evaluates_the_new_ops_as_the_eager_problem(tmp_path_factory, dtype):
    # the table of ops of the new zoo through fused_model_eval's host build:
    # res (each op's value), jac (its value times cj, at the diagonal) and
    # J v (its tangent), against the eager problem's on CPU tensors
    args = zoo_inputs(dtype)
    model = fused_solve.model_of(ops_zoo_factory, args[0])
    n = model.n
    out = {"res": torch.empty(n, LANES, dtype=dtype), "jac": torch.empty(n, n, LANES, dtype=dtype),
           "jv": torch.empty(n, LANES, dtype=dtype)}
    a = fused_solve.ModelEvalArgs(*(x.data_ptr() for x in args),
                                  *(x.data_ptr() for x in out.values()), LANES)
    lib = host_build(tmp_path_factory, (), model)
    fn = getattr(lib, f"fused_model_eval_{'f64' if dtype == torch.float64 else 'f32'}")
    assert fn(ctypes.byref(a), model.id, None) == 0
    want = dict(zip(out, fused_solve.eval_model(ops_zoo_factory, *args)))
    specials = np.zeros(LANES, bool)
    specials[::SPECIAL_EVERY] = True
    for key, got in out.items():
        rows = got if key != "jac" else torch.stack([got[i, i] for i in range(n)])
        ref = want[key] if key != "jac" else torch.stack([want[key][i, i] for i in range(n)])
        if key == "jac":  # the entries off the diagonal are zeros on both sides
            off = ~torch.eye(n, dtype=torch.bool)
            assert torch.equal(got[off], want[key][off])
        d = _ulps(rows, ref)
        for i in range(n):
            bound = HOST_ULPS if i in TRANSCENDENTAL_ROWS else 0
            assert d[i].max() <= bound, (key, i, int(d[i].max()), int((d[i] > 0).sum()))
            # the special lanes: NaN where NaN, and every infinity and zero
            # (of its sign) the eager op's
            exact = ~np.isfinite(ref[i].numpy()) | (ref[i].numpy() == 0)
            assert (d[i][specials & exact] == 0).all(), (key, i)
    # the rows that are not transcendental carry special values through
    # every new op, and the host build agrees on all of them
    assert np.isnan(want["res"][7:15].numpy()).any() and np.isinf(want["res"][:7].numpy()).any()


def test_numerics_hyperbolic_functions_are_the_c_librarys():
    # tanh_, sinh_ and cosh_ on CPU tensors: the C library's in double (for
    # float32 rounded to it), special values included; differentiable
    # forward, backward and under vmap with the formulas 1 - tanh^2, cosh
    # and sinh; on a non-CPU tensor the torch op
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    rng = np.random.default_rng(2)
    x64 = torch.from_numpy(np.concatenate([rng.normal(size=2000) * 4,
                                           [0.0, -0.0, np.inf, -np.inf, np.nan, 710.0]]))
    for name, fn in (("tanh", numerics.tanh_), ("sinh", numerics.sinh_),
                     ("cosh", numerics.cosh_)):
        c = getattr(libm, name)
        c.restype, c.argtypes = ctypes.c_double, [ctypes.c_double]
        for x in (x64, x64.float()):
            want = torch.tensor([c(v) for v in x.double().tolist()],
                                dtype=torch.float64).to(x.dtype)
            got = fn(x)
            assert got.dtype == x.dtype
            assert ((got == want) | (torch.isnan(got) & torch.isnan(want))).all(), name
            # bit for bit, signed zeros too
            assert torch.equal(got[-6:-4].view(torch.int64 if x.dtype == torch.float64
                                                 else torch.int32),
                               want[-6:-4].view(torch.int64 if x.dtype == torch.float64
                                                else torch.int32)), name
        assert fn(torch.empty(3, device="meta")).device.type == "meta"
    x = torch.linspace(-2.0, 2.0, 9, dtype=torch.float64)
    t = torch.full_like(x, 0.5)
    y = numerics.tanh_(x)
    assert torch.equal(torch.func.jvp(numerics.tanh_, (x,), (t,))[1], t * (1.0 - y * y))
    assert torch.equal(torch.func.jvp(numerics.sinh_, (x,), (t,))[1], t * numerics.cosh_(x))
    assert torch.equal(torch.func.jvp(numerics.cosh_, (x,), (t,))[1], t * numerics.sinh_(x))
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(numerics.cosh_(xg).sum(), xg)
    assert torch.equal(g, numerics.sinh_(x))
    assert torch.equal(torch.func.vmap(numerics.tanh_)(x.reshape(3, 3)), y.reshape(3, 3))


# each new op as a user writes it, and the aten ops it and its jvp leave
NEW_OPS = {
    "tanh": torch.tanh, "sinh": torch.sinh, "cosh": torch.cosh, "tan": torch.tan,
    "atan": torch.atan, "expm1": torch.expm1, "log1p": torch.log1p,
    "maximum": lambda x: torch.maximum(x, 2.0 * x), "minimum": lambda x: torch.minimum(x, -x),
    "clamp": lambda x: torch.clamp(x, -0.5, 0.5), "clamp_min": lambda x: torch.clamp_min(x, 0.0),
    "clamp_max": lambda x: torch.clamp_max(x, 0.0),
    "clamp_tensors": lambda x: torch.clamp(x, min=x * 0.5, max=x * x),
    "clamp_tensor_min": lambda x: torch.clamp(x, min=x * 0.5),
    "where": lambda x: torch.where((x > 0.1) & ~(x >= 2.0) | (x < -1.0), x, -x),
    "where_scalar": lambda x: torch.where(x <= 0.0, x, 0.0),
    "compare": lambda x: torch.where((x == 1.0) | (x != 2.0), x.ne(0.5).to(x.dtype), x),
    "masked_fill": lambda x: x.masked_fill(x > 0.0, 3.0),
}


def _jvp_of(fn):
    return lambda x, v: torch.func.jvp(fn, (x,), (v,))[1]


@pytest.mark.parametrize("formulas", ["card", "cpu"])
def test_every_aten_op_of_the_new_ops_and_their_jvps_is_known(formulas):
    # make_fx of each new op and of its jvp (on meta tensors, as the
    # generator traces): every aten op left in the graph is in KNOWN_OPS
    context = numerics.cpu_formulas if formulas == "cpu" else contextlib.nullcontext
    seen = set()
    for name, fn in NEW_OPS.items():
        with context():
            for f, k in ((fn, 1), (_jvp_of(fn), 2)):
                gm = make_fx(f)(*(torch.empty(3, 2, dtype=torch.float64, device="meta")
                                  for _ in range(k)))
                gm.graph.eliminate_dead_code()
                ops = {n.target.overloadpacket.__name__ for n in gm.graph.nodes
                       if n.op == "call_function" and hasattr(n.target, "overloadpacket")}
                assert ops <= fused_model.KNOWN_OPS, (name, ops - fused_model.KNOWN_OPS)
                seen |= ops
    assert {"tanh_backward", "where", "logical_and_", "gt", "_to_copy"} <= seen
    # and each as a whole residual: the model is generated, its lanes alike
    for name, fn in NEW_OPS.items():
        def factory(p, fn=fn):
            return dataclasses.replace(roberts_factory(p),
                                       res=lambda t, yy, yp: yp - fn(yy) * p[0])

        model = fused_model.generate(factory, torch.ones(3, 4, dtype=torch.float64))
        assert model.n == 3 and "GeneratedModel" in model.header, name


def _res_variant(res):
    def factory(p):
        return dataclasses.replace(roberts_factory(p), res=res)

    return factory


BOOLEAN_REFUSED = {
    "boolean_residual": (_res_variant(lambda t, yy, yp: yp > yy),
                         "makes a torch.bool tensor|returns a boolean"),
    "boolean_arithmetic": (_res_variant(lambda t, yy, yp: yp + (yy > 0.0) * yy),
                           "a boolean .* reaches the arithmetic"),
    "number_cast_to_boolean": (_res_variant(lambda t, yy, yp: torch.where(yy.to(torch.bool), yp,
                                                                          yy)),
                               "torch.bool tensor|a number cast to a boolean"),
    "nan_bound": (_res_variant(lambda t, yy, yp: yp + torch.clamp(yy, min=float("nan"))),
                  "NaN number as a bound"),
}


def test_booleans_and_nan_bounds_are_refused():
    # through the entry point on CPU tensors: the refusal names its reason
    params = np.outer(np.linspace(0.9, 1.1, 4), [0.04, 1.0e4, 3.0e7])
    st = ensemble_init(roberts_factory, params, np.ones((4, 3)) / 3, np.zeros((4, 3)),
                       device="cpu")
    for case, (factory, why) in BOOLEAN_REFUSED.items():
        fn = fused_solve.make_fused_solve(factory, tol_ss(1e-4, 1e-6, device="cpu"))
        with pytest.raises(NotImplementedError, match=why):
            fn(st, params, 0.1)
