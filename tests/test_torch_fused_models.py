"""Problem factories compiled into the whole-solve kernel
(``ida_tpu_torch/ops/fused_model.py``), on the CPU.

``ida_tpu``'s fused Pallas kernel traces any batch-native factory with an
analytic ``jac`` and no roots; so does the port's ``make_fused_solve``,
whose kernel compiles in a model generated from the factory's torch code.
Here, with the kernel source built for the host (tests/test_torch_fused_host.py
``host_build``, the generated header beside it):

* the model generated from ``roberts_factory``'s code is bit for bit the
  hand-written ``struct Roberts`` in the whole solve;
* Lorenz '63 and Akzo Nobel (CHEMAKZO, N = 6 with one algebraic row,
  written with ``utils.numerics.pow_``/``sqrt_`` so that the CPU eager path
  calls the C library) are bit for bit the eager ``core.solve`` in float64,
  in parity, with a budget of 6 attempts a launch and under
  ``ls_precision="refined"`` (whose J v is the generated ``res_jvp``, and
  whose sqrt derivative takes the CPU Function's formula, ``#else`` in the
  header);
* each model's ``res``, ``jac`` and ``res_jvp`` through its evaluation
  entry point are bit for bit the eager problem's on random lanes;
* the port's ``make_fused_solve`` on CPU tensors (its plain version) takes
  both factories as ``ida_tpu``'s ``make_fused_solve(..., tile=4,
  interpret=True)`` does, f32, B = 8: statuses and ``tret`` equal, yy at
  rtol 2e-2 / atol 1e-6 (the bounds of tests/test_torch_fused_solve.py),
  and bit for bit ``ida_tpu``'s ``core_solve`` run op by op. The jitted
  f32 JAX solve contracts multiply-adds into FMAs, which moves Akzo's step
  counts against its own op-by-op run by up to 3 on a lane: nst is held
  within 1 of the kernel's, or within that distance where it is larger.
  The JAX runs are pinned (tests/make_torch_refs.py, ``fused_models_jax``);
  the Lorenz kernel run is also computed live and must equal its pin
  (tests/test_torch_pins_live.py);
* what the kernel cannot take is refused, naming the reason.

The host build's evaluation of each model against the eager problem is
``test_torch_fused_models_eval.py``'s (a file of few tests, which queues
after the files with the most tests). The card's build of the same models is held against the eager path on the
card by ``chip_smoke.py``'s ``fused_models`` phase.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ida_tpu.core.solve import solve as jsolve
from ida_tpu.core.state import IdaOptions as JOptions
from ida_tpu.ops.fused_solve import make_fused_solve as jmake_fused_solve
from ida_tpu.parallel import ensemble_init as jensemble_init
from ida_tpu.problem import IdaProblem as JProblem
from ida_tpu.tol_control import TolControl as JTol
from ida_tpu.tol_control import tol_ss as jtol_ss
from ida_tpu_torch import constants as C
from ida_tpu_torch.core.state import IdaOptions
from ida_tpu_torch.models import ROBERTS_PARAMS, ROBERTS_YY0, roberts_factory
from ida_tpu_torch.ops import fused_solve
from ida_tpu_torch.parallel import ensemble_init
from ida_tpu_torch.problem import IdaProblem
from ida_tpu_torch.tol_control import tol_ss, tol_sv
from ida_tpu_torch.utils.numerics import cos_, pow_, sin_, sqrt_
from make_torch_refs import load
from test_torch_fused_host import host_build

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

B = 8
RTOL, ATOL = 1e-4, 1e-6
AKZO_K = np.array([18.7, 0.58, 0.09, 0.42])
AKZO = {"K": 34.4, "klA": 3.3, "Ks": 115.83, "pCO2": 0.9, "H": 737.0}
AKZO_Y0 = np.array([0.444, 0.00123, 0.0, 0.007, 0.0, AKZO["Ks"] * 0.444 * 0.007])
LORENZ = np.array([10.0, 28.0, 8.0 / 3.0])
TOUT = {"akzo": 40.0, "lorenz": 1.0}  # the chip runs Akzo to the test set's 180
JAX_TOUT = {"akzo": 1.0, "lorenz": 1.0}  # the interpret-mode runs: a shorter Akzo


def _akzo(k, stack, pow, sqrt, zeros_like, ones_like):
    """CHEMAKZO's residual and analytic Jacobian over the array module of
    ``stack`` (the IVP Test Set, F. Mazzia and C. Magherini, Univ. of Bari):
    F = y' - f(y) on rows 1-5, F6 = Ks y1 y4 - y6; k = [k1, k2, k3, k4]."""
    k1, k2, k3, k4 = k[0], k[1], k[2], k[3]
    K, kla, ks, pco2, h = (AKZO[x] for x in ("K", "klA", "Ks", "pCO2", "H"))

    def res(t, yy, yp):
        s2 = sqrt(yy[1])
        r1 = k1 * pow(yy[0], 4) * s2
        r2 = k2 * yy[2] * yy[3]
        r3 = k2 / K * yy[0] * yy[4]
        r4 = k3 * yy[0] * pow(yy[3], 2)
        r5 = k4 * pow(yy[5], 2) * s2
        fin = kla * (pco2 / h - yy[1])
        f = [-2.0 * r1 + r2 - r3 - r4, -0.5 * r1 - r4 - 0.5 * r5 + fin, r1 - r2 + r3,
             -r2 + r3 - 2.0 * r4, r2 - r3 + r5]
        return stack([yp[i] - f[i] for i in range(5)] + [ks * yy[0] * yy[3] - yy[5]])

    def jac(t, cj, yy, yp, rr):
        y1, y2, y3, y4, y5, y6 = (yy[i] for i in range(6))
        s2 = sqrt(y2)
        d1, d2 = 4.0 * k1 * pow(y1, 3) * s2, k1 * pow(y1, 4) * (0.5 / s2)
        e3, e4 = k2 * y4, k2 * y3
        g1, g5 = k2 / K * y5, k2 / K * y1
        h1, h4 = k3 * pow(y4, 2), 2.0 * k3 * y1 * y4
        m2, m6 = k4 * pow(y6, 2) * (0.5 / s2), 2.0 * k4 * y6 * s2
        z = zeros_like(y1)
        return stack([
            stack([cj + 2.0 * d1 + g1 + h1, 2.0 * d2, -e3, h4 - e4, g5, z]),
            stack([0.5 * d1 + h1, cj + 0.5 * d2 + 0.5 * m2 + kla, z, h4, z, 0.5 * m6]),
            stack([-(d1 + g1), -d2, cj + e3, e4, -g5, z]),
            stack([2.0 * h1 - g1, z, e3, cj + e4 + 2.0 * h4, -g5, z]),
            stack([g1, -m2, -e3, -e4, cj + g5, -m6]),
            stack([ks * y4, z, z, ks * y1, z, -ones_like(y1)]),
        ])

    return res, jac


def akzo_factory(params):
    res, jac = _akzo(params, torch.stack, pow_, sqrt_, torch.zeros_like, torch.ones_like)
    return IdaProblem(n=6, res=res, jac=jac, id=torch.tensor([True] * 5 + [False]))


def jakzo_factory(params):
    # a float exponent: lax.pow, the C library's pow as pow_ calls it (an
    # int one would be lax.integer_pow, repeated products)
    res, jac = _akzo(params, jnp.stack, lambda x, e: x ** float(e), jnp.sqrt, jnp.zeros_like,
                     jnp.ones_like)
    return JProblem(n=6, res=res, jac=jac, id=jnp.array([True] * 5 + [False]))


def _lorenz(k, stack, zeros_like):
    """Lorenz '63, F = y' - f(y), k = [sigma, rho, beta], analytic J."""
    sigma, rho, beta = k[0], k[1], k[2]

    def res(t, yy, yp):
        x, y, z = yy[0], yy[1], yy[2]
        return stack([yp[0] - sigma * (y - x), yp[1] - (x * (rho - z) - y),
                      yp[2] - (x * y - beta * z)])

    def jac(t, cj, yy, yp, rr):
        x, y, z = yy[0], yy[1], yy[2]
        zero = zeros_like(x)
        return stack([stack([cj + sigma, -sigma, zero]), stack([z - rho, cj + 1.0, x]),
                      stack([-y, -x, cj + beta])])

    return res, jac


def lorenz_factory(params):
    return IdaProblem(3, *_lorenz(params, torch.stack, torch.zeros_like))


def jlorenz_factory(params):
    return JProblem(3, *_lorenz(params, jnp.stack, jnp.zeros_like))


def roberts_generated(params):
    """roberts_factory behind a factory of its own: its model is generated."""
    return roberts_factory(params)


def libm_zoo_factory(params):
    """One row per op whose eager CPU form is fixed (the C library's pow,
    sqrt, sin and cos through utils.numerics, IEEE arithmetic): pow_ at the
    exponents the card takes apart and at 1.7, sqrt_, sin_, cos_, abs (sgn
    in its jvp), c / x, x / c."""
    a, b = params[0], params[1]

    def terms(yy):
        y = [yy[i] for i in range(12)]
        pos = [torch.abs(v) + 0.25 for v in y]
        return [pow_(pos[0], 0.5), pow_(pos[1], -0.5), pow_(y[2], 2), pow_(y[3], 3),
                pow_(pos[4], -1), pow_(pos[5], -2), pow_(pos[6], 1.7) * a, sqrt_(pos[7]),
                sin_(b * y[8]), cos_(y[9]), 2.0 / pos[10], y[11] / 34.4]

    def res(t, yy, yp):
        f = terms(yy)
        return torch.stack([yp[i] - f[i] * t for i in range(12)])

    def jac(t, cj, yy, yp, rr):
        f = terms(yy)
        z = torch.zeros_like(cj)
        return torch.stack([torch.stack([cj - f[i] * 0.5 if j == i else z for j in range(12)])
                            for i in range(12)])

    return IdaProblem(n=12, res=res, jac=jac)


def akzo_inputs(b):
    params = np.outer(np.exp(np.linspace(-0.2, 0.2, b)), AKZO_K)
    yy0 = np.tile(AKZO_Y0, (b, 1))
    f = -akzo_factory(torch.from_numpy(params.T)).res(
        0.0, torch.from_numpy(yy0.T), torch.zeros(6, b, dtype=torch.float64))
    yp0 = f.numpy().T.copy()
    yp0[:, 5] = 0.0  # the algebraic row
    return params, yy0, yp0


def lorenz_inputs(b):
    params = np.outer(np.exp(np.linspace(-0.05, 0.05, b)), LORENZ)
    yp0 = np.stack([np.zeros(b), params[:, 1] - 2.0, 1.0 - params[:, 2]], axis=1)
    return params, np.ones((b, 3)), yp0


def roberts_inputs(b):
    params = np.outer(np.linspace(0.9, 1.1, b), ROBERTS_PARAMS)
    yp0 = params[:, :1] * np.array([-1.0, 1.0, 0.0])
    return params, np.tile(ROBERTS_YY0, (b, 1)), yp0


# name -> (factory, inputs, N)
MODELS = {"akzo": (akzo_factory, akzo_inputs, 6), "lorenz": (lorenz_factory, lorenz_inputs, 3)}
JAX_MODELS = {"akzo": jakzo_factory, "lorenz": jlorenz_factory}


@pytest.fixture
def on_host(tmp_path_factory, monkeypatch):
    """Route the wrappers' launches to the host build of each mode and
    model, on CPU tensors."""
    monkeypatch.setattr(
        fused_solve, "build",
        lambda fast_math=False, ls_precision="full", model=fused_solve.ROBERTS,
        linear=fused_solve.DENSE: {
            "lib": host_build(tmp_path_factory,
                              fused_solve.mode_flags(fast_math, ls_precision, linear), model)})
    monkeypatch.setattr(fused_solve, "build_eval", lambda model=fused_solve.ROBERTS: {
        "lib": host_build(tmp_path_factory, (), model)})
    monkeypatch.setattr(fused_solve, "stream_of", lambda t: 0)
    monkeypatch.setattr(
        fused_solve, "state_refs",
        lambda st, batch_axis, opts=IdaOptions(), model=fused_solve.ROBERTS: fused_solve.StateRefs(
            **{f: getattr(st, f).data_ptr() for f in fused_solve.touched_fields(opts, model)}))
    yield
    fused_solve.reset_launch_counts()


def _kernel_solve(factory, st_b, params, tol, tout, opts, budget=None):
    """The kernel's entry as ``make_fused_solve`` drives it on the card, on
    the host build: batch-leading in, out of place, tolerances by value."""
    p_b = torch.as_tensor(params).contiguous()
    model = fused_solve.model_of(factory, p_b.t())
    tol_in = fused_solve.tol_inputs(tol, model.n, p_b.shape[0], torch.float64,
                                    torch.device("cpu"))
    return model, fused_solve._solve_cuda(st_b, p_b, tol_in, tout, opts, model, budget)


def _differ(a, b):
    return [f for f, x in zip(a._fields, a) if isinstance(x, torch.Tensor)
            and not torch.equal(x, getattr(b, f))]


SOLVES = {"parity": (IdaOptions(), None), "budget6": (IdaOptions(), 6),
          "refined": (IdaOptions(ls_precision="refined"), None)}


@pytest.mark.parametrize("solve", SOLVES)
def test_the_generated_roberts_model_is_the_hand_written_one(on_host, solve):
    # the slice's B = 8 lanes to tout 400: the header emitted from
    # roberts_factory's torch code solves bit for bit as struct Roberts
    opts, budget = SOLVES[solve]
    params, yy0, yp0 = roberts_inputs(B)
    st0 = ensemble_init(roberts_factory, params, yy0, yp0, device="cpu", opts=opts)
    tol = tol_sv(1e-4, [1e-8, 1e-6, 1e-6], device="cpu")
    fused_solve.reset_launch_counts()
    gen, (st_g, tret_g, ist_g) = _kernel_solve(roberts_generated, st0, params, tol, 400.0, opts,
                                               budget)
    hand, (st_h, tret_h, ist_h) = _kernel_solve(roberts_factory, st0, params, tol, 400.0, opts,
                                                budget)
    assert hand is fused_solve.ROBERTS and gen.header is not None and gen.id != 0
    assert _differ(st_g, st_h) == []
    assert torch.equal(tret_g, tret_h) and torch.equal(ist_g, ist_h)
    assert bool((ist_g == C.SUCCESS).all()) and int(st_g.nst.min()) > 90
    assert {m for _, _, m in fused_solve.MODE_LAUNCHES} == {gen.name, "roberts"}


EVAL_MODELS = {"roberts": (roberts_factory, ROBERTS_PARAMS),
               "roberts_generated": (roberts_generated, ROBERTS_PARAMS),
               "akzo": (akzo_factory, AKZO_K), "lorenz": (lorenz_factory, LORENZ),
               "libm_zoo": (libm_zoo_factory, np.array([0.3, 1.3]))}


def test_a_model_is_traced_once_per_factory_and_shared_by_equal_code():
    params = torch.from_numpy(np.tile(LORENZ[:, None], (1, 4)))
    a = fused_solve.model_of(lorenz_factory, params)
    assert fused_solve.model_of(lorenz_factory, params) is a
    assert fused_solve.model_of(roberts_factory, torch.ones(3, 4)) is fused_solve.ROBERTS

    def lorenz_again(p):
        return lorenz_factory(p)

    b = fused_solve.model_of(lorenz_again, params)
    # the same code: the same header, so one library (ops/_build.py hashes it)
    assert b is not a and b.header == a.header and b.id == a.id and b.name != a.name
    assert (a.n, a.p) == (3, 3) and "#ifdef" not in a.header
    # Akzo's sqrt_ takes the CPU Function's derivative on the host only
    akzo = fused_solve.model_of(akzo_factory, torch.from_numpy(np.tile(AKZO_K[:, None], (1, 2))))
    jvp = akzo.header.split("static void res_jvp(")[1].split("static void jac(")[0]
    assert "#ifdef __CUDA_ARCH__" in jvp and (akzo.n, akzo.p) == (6, 4)
    assert "((0x1fu >> i) & 1u)" in akzo.header  # y6 algebraic


@pytest.fixture(scope="module", params=["akzo", "lorenz"])
def jax_fused_f32(request):
    """ida_tpu's fused Pallas kernel in interpret mode, f32, tile 4, pinned
    (:func:`jax_fused_models_live`)."""
    return request.param, load("fused_models_jax", REF_INPUTS)[request.param]


def _jax_fused(name, op_by_op=False):
    """ida_tpu's fused kernel (interpret mode, tile 4), or with
    ``op_by_op`` its batch-native core_solve under jax.disable_jit(), f32."""
    dtype = jnp.float32
    params, yy0, yp0 = (jnp.asarray(a, dtype) for a in MODELS[name][1](B))
    states = jensemble_init(JAX_MODELS[name], params, yy0, yp0, dtype=dtype)
    if op_by_op:
        st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, -1), states)
        tol = JTol(jnp.full((B,), RTOL, dtype), jnp.full((MODELS[name][2], B), ATOL, dtype))
        with jax.disable_jit():
            st, tret, ist = jsolve(st, JAX_MODELS[name](params.T), JOptions(), tol,
                                   jnp.full((B,), JAX_TOUT[name], dtype))
        st = jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, -1, 0), st)
    else:
        fused = jmake_fused_solve(JAX_MODELS[name], jtol_ss(RTOL, ATOL, dtype=dtype), tile=4,
                                  interpret=True)
        st, tret, ist = fused(states, params, JAX_TOUT[name])
    return {"nst": np.asarray(st.nst), "yy": np.asarray(st.yy), "tret": np.asarray(tret),
            "istate": np.asarray(ist)}


# what the pinned reference (jax_fused_models_live) is computed from
REF_INPUTS = {"b": B, "rtol": RTOL, "atol": ATOL, "tout": JAX_TOUT, "akzo_k": AKZO_K,
              "akzo": AKZO, "akzo_y0": AKZO_Y0, "lorenz": LORENZ,
              "inputs": {k: MODELS[k][1](B) for k in MODELS}}


def jax_fused_models_live():
    return {name: {"fused": _jax_fused(name), "op_by_op": _jax_fused(name, op_by_op=True)}
            for name in MODELS}


def test_plain_version_takes_the_factories_the_jax_fused_kernel_takes(jax_fused_f32):
    name, ref = jax_fused_f32
    kernel, op_by_op = ref["fused"], ref["op_by_op"]
    factory, inputs, _ = MODELS[name]
    params, yy0, yp0 = inputs(B)
    st0 = ensemble_init(factory, params, yy0, yp0, device="cpu", dtype=torch.float32)
    tol = tol_ss(RTOL, ATOL, device="cpu", dtype=torch.float32)
    st, tret, ist = fused_solve.make_fused_solve(factory, tol)(st0, params, JAX_TOUT[name])
    got = {"nst": st.nst.numpy(), "yy": st.yy.numpy(), "tret": tret.numpy(),
           "istate": ist.numpy()}
    assert bool((ist == C.SUCCESS).all())
    for k, v in got.items():
        np.testing.assert_array_equal(v, op_by_op[k], err_msg=k)
    np.testing.assert_array_equal(got["istate"], kernel["istate"])
    np.testing.assert_array_equal(got["tret"], kernel["tret"])
    jit_spread = np.maximum(1, np.abs(op_by_op["nst"] - kernel["nst"]))
    assert (np.abs(got["nst"] - kernel["nst"]) <= jit_spread).all()
    np.testing.assert_allclose(got["yy"], kernel["yy"], rtol=2e-2, atol=1e-6)


def _with_roots(p):
    return dataclasses.replace(roberts_factory(p), nroots=2, root=lambda t, yy, yp: yy[:2])


def _decay(n):
    def factory(p):
        def res(t, yy, yp):
            return yp + p[0] * yy

        def jac(t, cj, yy, yp, rr):
            eye = torch.eye(n, dtype=yy.dtype).reshape((n, n) + (1,) * (yy.dim() - 1))
            return eye * (cj + p[0])

        return IdaProblem(n=n, res=res, jac=jac)

    return factory


def _res_variant(res):
    def factory(p):
        return dataclasses.replace(roberts_factory(p), res=res)

    return factory


def _per_lane_id(p):
    ids = torch.stack([p[0] > float(p[0].median()), torch.ones_like(p[0], dtype=torch.bool),
                       torch.zeros_like(p[0], dtype=torch.bool)])
    return dataclasses.replace(roberts_factory(p), id=ids)


REFUSED = {
    "no_jac": (lambda p: dataclasses.replace(roberts_factory(p), jac=None), "no analytic jac"),
    "roots": (_with_roots, "nroots"),
    "n17": (_decay(17), "N = 17 components, above the kernel's MAXN = 16"),
    "per_lane_id": (_per_lane_id, "a per-lane id"),
    "unknown_op": (_res_variant(lambda t, yy, yp: yp + torch.erf(yy)),
                   "aten.erf is not one the emitter compiles"),
    "boolean_reaches_the_residual": (_res_variant(lambda t, yy, yp: yp > yy),
                                     "makes a torch.bool tensor|returns a boolean"),
    "reduction_over_lanes": (_res_variant(lambda t, yy, yp: yp + yy - yy.mean(-1, keepdim=True)),
                             "reduces over the lane axis"),
    "reduction_over_components": (_res_variant(lambda t, yy, yp: yp + yy.sum(0)),
                                  "reduces over the components"),
    "reads_another_lane": (_res_variant(lambda t, yy, yp: yp + yy[:, :1].expand_as(yy)),
                           "reads across lanes"),
}


@pytest.mark.parametrize("case", REFUSED)
def test_what_the_kernel_cannot_take_is_refused_on_the_cpu(case):
    # through the entry point on CPU tensors: the refusal names its reason
    factory, why = REFUSED[case]
    n = 17 if case == "n17" else 3
    params = np.outer(np.linspace(0.9, 1.1, 4), [0.04, 1.0e4, 3.0e7])
    st = ensemble_init(roberts_factory if n == 3 else factory, params, np.ones((4, n)) / n,
                       np.zeros((4, n)), device="cpu")
    fn = fused_solve.make_fused_solve(factory, tol_ss(RTOL, ATOL, device="cpu"))
    with pytest.raises(NotImplementedError, match=why):
        fn(st, params, 0.1)
