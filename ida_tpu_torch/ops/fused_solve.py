"""The whole solve in one CUDA kernel: ``csrc/fused_solve.cu``.

Counterpart of ``ida_tpu/ops/fused_solve.py::make_fused_solve``: the Pallas
TPU kernels K2 (``make_fused_solve`` -> ``kern``), K3 and K4 (the budgeted
``fn_init.kern`` / ``fn_cont.kern``) become one hand-written kernel for
Hopper, one thread per lane, with the attempt loop on the device. Unlike the
TPU kernel (float32 only, state packed into two buffers, 1024-lane tiles) it
reads the ``IdaState`` fields in their own dtypes, float64 or float32, and
takes any batch size.

As the TPU kernel traces any batch-native ``problem_factory`` into its
body, the kernel takes any factory with an analytic ``jac``, no roots and
at most ``MAXN`` components, quadratures included (integrated into the
state's ``yQ`` after every accepted step, as the eager solve does):
``models.roberts_factory`` runs the hand-written Roberts model of
``fused_solve.cu``, any other factory a model
that ``ops/fused_model.py`` generates from its torch code at its first
call, compiled into a library of its own (:func:`model_of`); what the
kernel cannot take raises ``NotImplementedError`` on either device.

On CUDA tensors ``fn`` does nothing on the card but allocate the result and
launch: the kernel reads the batch-leading state and ``params_b`` where they
lie and writes a batch-leading result out of place; ``rtol``, ``atol`` and
``tout`` travel by value. With ``attempt_budget`` it launches the budgeted
kernel and then its continuation, in place on that result, until no lane is
CONTINUE. On CPU tensors ``fn`` runs the plain version: the eager
``core.solve`` (with the same budgeted host loop when a budget is given).
On any other device, and on what the kernel does not take, it raises;
nothing falls back on a CUDA tensor. The kernels are forward-only, as the
TPU kernels are: ``fn`` raises on a state, params or tolerances that carry a
derivative (``requires_grad``, or a forward-mode tangent) on either device,
and never detaches them; ``sensitivity.adjoint_gradient`` takes gradients
through the eager solve.

The arithmetic modes and linear solvers of ``IdaOptions`` that the TPU
kernel traces are compiled in: ``fast_math``, ``ls_precision`` "single" and
"refined", and ``linear_solver`` "dense", "band" (any ``band_mu``,
``band_ml``: an in-lane band LU on colored jvps of the residual) and
"spgmr" (any ``krylov_maxl``, ``krylov_max_restarts``, ``krylov_gs``,
``krylov_storage``, ``eplifac``: an in-lane restarted GMRES on jvps of the
residual, with the Krylov counters). Each combination is a library of its
own, built from the same source with :func:`mode_flags` at its first use,
and each is bit for bit the eager solve under the same options. What the
Krylov path would trace but the kernel does not compile in, a factory's own
``jtimes_fn``/``jtimes_setup`` and a preconditioner
(``prec_setup``/``prec_solve``), raises (ROADMAP item 22).

``MODE_LAUNCHES`` counts the kernel launches (and only those) by (kernel,
:func:`mode_name`, model name), e.g. ``("init", "refined", "roberts")``;
:func:`launch_count` sums them over the modes and models. :func:`eval_model`
runs a model's ``res``, ``jac`` and ``res_jvp`` alone (``EVAL_LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd import forward_ad

from .. import constants as C
from ..constants import not_ported
from ..core.solve import TASK_NORMAL, solve
from ..core.state import IdaOptions, IdaState, ls_store_dtype
from ..parallel.batch import from_native
from ..tol_control import TolControl
from ._build import DTYPE_TAGS, build_library
from .fused_model import MAXN, ROBERTS, FusedModel, model_of

# ("solve" | "init" | "cont", mode_name, model name) -> launches
MODE_LAUNCHES: dict = {}
EVAL_LAUNCHES: dict = {}  # model name -> launches of fused_model_eval
HEADERS = ("ida_lane.cuh", "small_lu.cuh", "band_lu.cuh", "rounded.cuh", "model_ops.cuh")
# how fused_solve.cu is built: nvcc's default contraction, as PyTorch's own
# kernels are, so that the inlined pow and sqrt are torch.pow's and
# torch.sqrt's; the solve's own arithmetic rounds once per operation through
# csrc/rounded.cuh
BUILD_FLAGS = ("-fmad=true",)

# csrc/ida_lane.cuh IDA_STATE_FIELDS, in its order
STATE_FIELDS = (
    "phi", "psi", "alpha", "beta", "sigma", "gamma", "ee", "yy", "yp", "yypredict",
    "yppredict", "ewt", "savres", "tn", "hh", "hused", "rr", "h0u", "tretlast", "tolsf",
    "kk", "kused", "knew", "phase", "ns", "cj", "cjlast", "cjold", "cjratio", "ss", "oldnrm",
    "eps_newt", "toldel", "lu", "piv", "hin", "hmax_inv", "epcon", "tstop", "tstop_set",
    "constraints", "constraints_set", "nst", "nre", "ncfn", "netf", "nni", "nsetups", "nje",
    "nli", "nps", "ncfl", "njtimes", "toutc", "taskc", "status", "yQ", "ls_tn", "ls_cj", "ls_yy",
    "ls_yp",
)
# the lsetup point that ls_precision "refined" saves (core/nls.py): the kernel
# touches it in that mode only, and in the others it passes through
LS_FIELDS = ("ls_tn", "ls_cj", "ls_yy", "ls_yp")
# the direct solvers' factor (touched under "dense" and "band") and the
# Krylov counters (touched under "spgmr"); each passes through elsewhere
DIRECT_FIELDS = ("lu", "piv")
KRYLOV_FIELDS = ("nli", "nps", "ncfl", "njtimes")
_INT32 = {"kk", "kused", "knew", "phase", "ns", "piv", "taskc", "status"}
_INT64 = {"nst", "nre", "ncfn", "netf", "nni", "nsetups", "nje", *KRYLOV_FIELDS}
_BOOL = {"tstop_set", "constraints_set"}
# ls_precision -> csrc/ida_lane.cuh LS_FULL / LS_SINGLE / LS_REFINED
LS_CODES = {"full": 0, "single": 1, "refined": 2}

# the attempt loop's carry (core/solve.py _Loop minus the state), in order
CARRY_FIELDS = ("tret", "istate", "nstloc", "saved_t", "ncf", "nef", "fresh", "ikind", "itgt")
_CARRY_REAL = {"tret", "saved_t", "itgt"}
_RUNAWAY = 100_000


class StateRefs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in STATE_FIELDS]


class CarryRefs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in CARRY_FIELDS]


class Opts(ctypes.Structure):
    """csrc/ida_lane.cuh Opts (``constraints`` is ``enable_constraints``)."""
    _fields_ = [(f, ctypes.c_int) for f in
                ("maxord", "mxstep", "maxncf", "maxnef", "maxnlsit", "suppressalg",
                 "constraints", "krylov_max_restarts")] + [("eplifac", ctypes.c_double)]


class LinearSolver(NamedTuple):
    """The linear solver a library compiles in (:func:`linear_of`): "dense",
    "band" with half-bandwidths ``mu``/``ml``, or "spgmr" with ``maxl``
    basis vectors, Gram-Schmidt ``gs`` and a bfloat16 basis (``bf16``)."""
    kind: str = "dense"
    mu: int = 0
    ml: int = 0
    maxl: int = 0
    gs: str = ""
    bf16: bool = False


DENSE = LinearSolver()


def linear_of(opts: IdaOptions) -> LinearSolver:
    """The compile-time part of ``opts``' linear solver (krylov_max_restarts
    and eplifac travel at run time, in :class:`Opts`)."""
    if opts.linear_solver == "band":
        return LinearSolver("band", mu=opts.band_mu, ml=opts.band_ml)
    if opts.linear_solver == "spgmr":
        return LinearSolver("spgmr", maxl=opts.krylov_maxl, gs=opts.krylov_gs,
                            bf16=opts.krylov_storage == "bfloat16")
    return DENSE


class TolArgs(ctypes.Structure):
    """csrc/ida_lane.cuh TolArgs."""
    _fields_ = [("rtol", ctypes.c_double), ("atol", ctypes.c_double * MAXN),
                ("tout", ctypes.c_double), ("rtol_lanes", ctypes.c_void_p),
                ("atol_lanes", ctypes.c_void_p)]


class SolveArgs(ctypes.Structure):
    """csrc/fused_solve.cu IdaSolveArgs."""
    _fields_ = [("src", StateRefs), ("dst", StateRefs), ("params", ctypes.c_void_p),
                ("tol", TolArgs), ("carry", CarryRefs), ("opts", Opts),
                ("B", ctypes.c_longlong), ("budget", ctypes.c_int)]


class ModelEvalArgs(ctypes.Structure):
    """csrc/fused_solve.cu ModelEvalArgs (``quad`` null for a model without
    quadratures)."""
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("params", "t", "cj", "yy", "yp", "v", "res", "jac", "jv")] + [
                    ("B", ctypes.c_longlong), ("quad", ctypes.c_void_p)]


class TolInputs(NamedTuple):
    """The tolerances as a launch takes them: ``rtol`` and ``atol`` ([N]) as
    Python floats when every lane shares them, else None and the per-lane
    tensors ``rtol_lanes`` [B], ``atol_lanes`` [B, N]."""
    rtol: float | None
    atol: tuple | None
    rtol_lanes: torch.Tensor | None = None
    atol_lanes: torch.Tensor | None = None


def reset_launch_counts() -> None:
    MODE_LAUNCHES.clear()
    EVAL_LAUNCHES.clear()


def launch_count(kind: str) -> int:
    """Launches of kernel ``kind`` ("solve" K2, "init" K3, "cont" K4) since
    the last reset, in every mode and model."""
    return sum(n for (k, _, _), n in MODE_LAUNCHES.items() if k == kind)


def mode_name(opts: IdaOptions) -> str:
    """"parity", or the mode's parts: "fast_math", "single", "refined",
    "fast_math_single", "fast_math_refined", then a solver other than the
    dense LU: "band2_2" (mu, ml) or "spgmr5" (maxl) with "_cgs2" under
    classical Gram-Schmidt and "_bf16" for a bfloat16 basis, e.g.
    "single_band1_1" or "spgmr5_bf16"."""
    parts = (["fast_math"] if opts.fast_math else []) + (
        [opts.ls_precision] if opts.ls_precision != "full" else [])
    if opts.linear_solver == "band":
        parts.append(f"band{opts.band_mu}_{opts.band_ml}")
    elif opts.linear_solver == "spgmr":
        parts.append(f"spgmr{opts.krylov_maxl}" + (
            "_cgs2" if opts.krylov_gs == "classical" else "") + (
            "_bf16" if opts.krylov_storage == "bfloat16" else ""))
    return "_".join(parts) or "parity"


def bind(lib: ctypes.CDLL, eval_only: bool = False) -> ctypes.CDLL:
    """Declare the argument types of the solve entry points of ``lib`` (of
    its model evaluation alone with ``eval_only``)."""
    for dt in DTYPE_TAGS.values():
        fn = getattr(lib, f"fused_model_eval_{dt}")
        fn.argtypes = [ctypes.POINTER(ModelEvalArgs), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if eval_only:
            continue
        for kind in ("", "_init", "_cont"):
            fn = getattr(lib, f"fused_solve{kind}_{dt}")
            fn.argtypes = [ctypes.POINTER(SolveArgs), ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        fn = getattr(lib, f"fused_solve_occupancy_{dt}")
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        fn.restype = ctypes.c_int
    return lib


def mode_flags(fast_math: bool = False, ls_precision: str = "full",
               linear: LinearSolver = DENSE) -> tuple[str, ...]:
    """The macros that compile ``fused_solve.cu``'s solve entry points in
    one arithmetic mode with one linear solver; none for the parity mode."""
    flags = ("-DIDA_FAST_MATH=1",) if fast_math else ()
    if ls_precision != "full":
        flags += (f"-DIDA_LS_PRECISION={LS_CODES[ls_precision]}",)
    if linear.kind == "band":
        flags += ("-DIDA_LINEAR_SOLVER=1", f"-DIDA_BAND_MU={linear.mu}",
                  f"-DIDA_BAND_ML={linear.ml}")
    elif linear.kind == "spgmr":
        flags += ("-DIDA_LINEAR_SOLVER=2", f"-DIDA_KRYLOV_MAXL={linear.maxl}")
        flags += ("-DIDA_KRYLOV_GS=1",) if linear.gs == "classical" else ()
        flags += ("-DIDA_KRYLOV_BF16=1",) if linear.bf16 else ()
    return flags


def model_flags(model: FusedModel) -> tuple[str, ...]:
    """The macro that compiles a generated model in; none for Roberts."""
    return () if model.header is None else ("-DIDA_MODEL_HEADER=1",)


@functools.cache
def build(fast_math: bool = False, ls_precision: str = "full",
          model: FusedModel = ROBERTS, linear: LinearSolver = DENSE) -> dict:
    """Compile (once per hash of the sources, the generated model header
    and the flags) and load the kernel library of one arithmetic mode,
    model and linear solver; see :func:`._build.build_library`. The parity
    library of Roberts (the default) also holds the stage kernels."""
    return _bound(_build_model(mode_flags(fast_math, ls_precision, linear), model))


@functools.cache
def build_eval(model: FusedModel = ROBERTS) -> dict:
    """The library of ``model``'s evaluation alone (:func:`eval_model`),
    quick to build at any N."""
    return _bound(_build_model(("-DIDA_EVAL_ONLY=1",), model), eval_only=True)


def _build_model(flags: tuple[str, ...], model: FusedModel) -> dict:
    """``fused_solve.cu`` built with ``flags`` and ``model`` (its generated
    header beside the library)."""
    return build_library(
        "fused_solve.cu", HEADERS, flags=BUILD_FLAGS + flags + model_flags(model),
        generated=None if model.header is None else {"ida_model.cuh": model.header})


def _bound(info: dict, eval_only: bool = False) -> dict:
    bind(info["lib"], eval_only)
    return info


def build_of(opts: IdaOptions, model: FusedModel = ROBERTS) -> dict:
    """The library of ``opts``' arithmetic mode and linear solver and
    ``model`` (:func:`build`)."""
    return build(opts.fast_math, opts.ls_precision, model, linear_of(opts))


def occupancy(dtype: torch.dtype, opts: IdaOptions = IdaOptions(),
              model: FusedModel = ROBERTS) -> dict:
    """The solve kernel's occupancy on the current card in ``opts``' mode:
    threads a block, dynamic shared bytes a block, resident blocks an SM,
    and the SM count."""
    vals = [ctypes.c_int() for _ in range(4)]
    name = f"fused_solve_occupancy_{DTYPE_TAGS[dtype]}"
    raise_on(getattr(build_of(opts, model)["lib"], name)(*(ctypes.byref(v) for v in vals)),
             name)
    blocks, shared, threads, sms = (v.value for v in vals)
    return {"threads": threads, "dynamic_shared_bytes": shared, "blocks_per_sm": blocks, "sms": sms}


def check_dtype(dtype: torch.dtype) -> None:
    if dtype not in DTYPE_TAGS:
        raise TypeError(f"fused_solve: the kernel takes float32 or float64 states, got {dtype}")


def check_device(device: torch.device) -> None:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_solve: runs on CUDA (kernel) or CPU (plain version), got {device}")


def touched_fields(opts: IdaOptions, model: FusedModel) -> tuple[str, ...]:
    """The fields a launch of ``model``'s library in ``opts``' mode reads or
    writes: the lsetup point under "refined" only, ``yQ`` for a model with
    quadratures only, the factor under the direct solvers and the Krylov
    counters under spgmr only."""
    skip = (set() if opts.ls_precision == "refined" else set(LS_FIELDS)) | (
        set() if model.nq else {"yQ"}) | set(
        DIRECT_FIELDS if opts.linear_solver == "spgmr" else KRYLOV_FIELDS)
    return tuple(f for f in STATE_FIELDS if f not in skip)


def _expected_dtype(field: str, dtype: torch.dtype, opts: IdaOptions) -> torch.dtype:
    if field == "lu":
        return ls_store_dtype(opts, dtype)
    if field in _INT32:
        return torch.int32
    if field in _INT64:
        return torch.int64
    if field in _BOOL:
        return torch.bool
    return dtype


def state_refs(state: IdaState, batch_axis: int, opts: IdaOptions,
               model: FusedModel) -> StateRefs:
    """Pointer table of a state on the card, batch-leading (``batch_axis``
    0) or batch-native (-1); checks every field ``model``'s kernel touches
    in ``opts``' mode (device, dtype in that mode, contiguity, the batch
    axis; ``yQ`` is [B, nq], or [nq, B] batch-native). The fields it does
    not touch there are null."""
    dtype, bsz = state.dtype, state.tn.shape[batch_axis]
    ptrs = {}
    for f in touched_fields(opts, model):
        x = getattr(state, f)
        want = _expected_dtype(f, dtype, opts)
        if not x.is_cuda:
            raise ValueError(f"fused_solve: state.{f} is on {x.device}, not on the card")
        if x.dtype != want:
            raise TypeError(f"fused_solve: state.{f} is {x.dtype}, the kernel takes {want}")
        if f == "yQ":
            want_shape = (bsz, model.nq) if batch_axis == 0 else (model.nq, bsz)
            if not x.is_contiguous() or tuple(x.shape) != want_shape:
                raise ValueError(f"fused_solve: state.yQ must be contiguous {list(want_shape)} "
                                 f"for model {model.name}, got {list(x.shape)}")
        elif not x.is_contiguous() or x.dim() < 1 or x.shape[batch_axis] != bsz:
            shape = f"[{bsz}, ...]" if batch_axis == 0 else f"[..., {bsz}]"
            raise ValueError(f"fused_solve: state.{f} must be contiguous {shape}")
        ptrs[f] = x.data_ptr()
    return StateRefs(**ptrs)


def opts_struct(opts: IdaOptions) -> Opts:
    return Opts(opts.maxord, opts.mxstep, opts.maxncf, opts.maxnef, opts.maxnlsit,
                int(opts.suppressalg), int(opts.enable_constraints),
                opts.krylov_max_restarts, float(opts.eplifac))


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({torch.cuda.get_device_name()})")


def tol_inputs(tol: TolControl, n: int, bsz: int, dtype, dev) -> TolInputs:
    """``tol`` as the solve kernel takes it: by value when every lane shares
    it (rtol a scalar, atol a scalar or [N]), as contiguous per-lane tensors
    when either is per lane (rtol [B], atol [B, N]); raises on any other
    shape. Reading shared values off a CUDA tensor synchronizes, so a caller
    does it once per ``tol``."""
    rtol, atol = torch.as_tensor(tol.rtol), torch.as_tensor(tol.atol)
    if n > MAXN:
        raise ValueError(f"fused_solve: at most {MAXN} components, got {n}")
    if rtol.dim() == 0 and (atol.dim() == 0 or tuple(atol.shape) == (n,)):
        return TolInputs(float(rtol), tuple(atol.expand(n).tolist()))
    if tuple(rtol.shape) in ((), (bsz,)) and tuple(atol.shape) in ((), (n,), (bsz, n)):
        return TolInputs(
            None, None,
            rtol.to(device=dev, dtype=dtype).expand(bsz).contiguous(),
            atol.to(device=dev, dtype=dtype).expand(bsz, n).contiguous())
    raise ValueError(
        f"fused_solve: tol must be shared (rtol [], atol [] or [{n}]) or per lane (rtol "
        f"[{bsz}], atol [{bsz}, {n}]), got rtol {tuple(rtol.shape)}, atol {tuple(atol.shape)}")


def lane_inputs(native: IdaState, params, tol: TolControl, tout, n: int):
    """Batch-native per-lane inputs on the state's device and dtype (the
    stage kernels' and the plain version's): params [P, B] (from batch-last
    params), rtol [B], atol [N, B], tout [B]."""
    dtype, dev, bsz = native.dtype, native.phi.device, native.tn.shape[-1]

    def lanes(x, shape):
        return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=dev), shape).contiguous()

    atol = torch.as_tensor(tol.atol, dtype=dtype, device=dev)
    if atol.dim() == 1:
        atol = atol.reshape(n, 1)
    return (
        torch.as_tensor(params, dtype=dtype, device=dev).contiguous(),
        lanes(tol.rtol, (bsz,)), lanes(atol, (n, bsz)), lanes(tout, (bsz,)),
    )


def new_carry(bsz: int, dtype, dev, full: bool) -> dict:
    """The kernel's [B] outputs: tret and istate, and with ``full`` (the
    budgeted kernels) the rest of the 9-field resume carry."""
    names = CARRY_FIELDS if full else ("tret", "istate")
    return {
        f: torch.empty(bsz, device=dev, dtype=dtype if f in _CARRY_REAL
                       else torch.bool if f == "fresh" else torch.int32)
        for f in names
    }


def native_clone(states_b: IdaState) -> IdaState:
    """Batch-leading -> batch-native copies (the plain version's input)."""
    return IdaState(*(
        x.movedim(0, -1).clone(memory_format=torch.contiguous_format)
        if isinstance(x, torch.Tensor) else x
        for x in states_b
    ))


def empty_result(states_b: IdaState, opts: IdaOptions, model: FusedModel) -> IdaState:
    """The state a launch of ``model``'s library in ``opts``' mode writes: a
    new tensor for every field the kernel touches there, the input's own
    tensor for every other."""
    touched = set(touched_fields(opts, model))
    return IdaState(*(x.new_empty(x.shape) if f in touched else x
                      for f, x in zip(states_b._fields, states_b)))


def prepare_launch(kind: str, src: IdaState, dst: IdaState, params_b: torch.Tensor,
                   tol: TolInputs, tout: float, carry: dict, opts: IdaOptions,
                   model: FusedModel, budget: int | None):
    """Check the arguments of one launch of the whole-solve kernel and return
    ``go``: each ``go()`` launches it once and returns the istate it writes.
    ``kind`` is "" (K2), "init" (K3) or "cont" (K4, resuming ``carry``); the
    kernel of ``model``'s library reads the batch-leading ``src`` and
    ``params_b`` [B, P] and writes ``dst`` (``src`` itself for a launch in
    place) and ``carry``."""
    lib = build_of(opts, model)["lib"]
    dt = DTYPE_TAGS[src.dtype]
    name = f"fused_solve_{dt}" if kind == "" else f"fused_solve_{kind}_{dt}"
    bsz = src.tn.shape[0]
    if (params_b.dtype != src.dtype or params_b.device != src.phi.device
            or not params_b.is_contiguous() or params_b.dim() != 2 or params_b.shape[0] != bsz):
        raise ValueError(f"{name}: params must be contiguous [{bsz}, P] {src.dtype} on the card")
    if params_b.shape[1] != model.p or src.yy.shape[1:] != (model.n,):
        raise ValueError(f"{name}: model {model.name} takes params [B, {model.p}] and N = "
                         f"{model.n}, got params {list(params_b.shape)}, yy "
                         f"{list(src.yy.shape)}")
    src_refs = state_refs(src, 0, opts, model)
    if tol.rtol_lanes is None:
        tol_args = TolArgs(tol.rtol, (ctypes.c_double * MAXN)(*tol.atol), float(tout), None, None)
    else:
        tol_args = TolArgs(0.0, (ctypes.c_double * MAXN)(), float(tout),
                           tol.rtol_lanes.data_ptr(), tol.atol_lanes.data_ptr())
    args = SolveArgs(src_refs, src_refs if dst is src else state_refs(dst, 0, opts, model),
                     params_b.data_ptr(), tol_args,
                     CarryRefs(**{f: t.data_ptr() for f, t in carry.items()}), opts_struct(opts),
                     bsz, 0 if budget is None else budget)
    fn, stream = getattr(lib, name), stream_of(src.tn)
    counted = (kind or "solve", mode_name(opts), model.name)

    def go() -> torch.Tensor:
        raise_on(fn(ctypes.byref(args), model.id, stream), name)
        MODE_LAUNCHES[counted] = MODE_LAUNCHES.get(counted, 0) + 1
        return carry["istate"]

    # ``args`` holds addresses only: keep every tensor the kernel reads or
    # writes alive as long as ``go`` is
    go.tensors = (src, dst, params_b, tol, carry)
    return go


def launch(kind: str, src: IdaState, dst: IdaState, params_b: torch.Tensor, tol: TolInputs,
           tout: float, carry: dict, opts: IdaOptions, model: FusedModel,
           budget: int | None) -> torch.Tensor:
    """One launch of the whole-solve kernel (:func:`prepare_launch`, then the
    launch). Returns the istate it writes."""
    return prepare_launch(kind, src, dst, params_b, tol, tout, carry, opts, model, budget)()


def run_until_done(step) -> int:
    """The budgeted host loop: ``step(resume)`` runs one budgeted launch (or
    one budgeted eager call) and returns its istate; it runs first with
    ``resume`` False, then with True while any lane is CONTINUE. Returns the
    number of steps run; raises on a runaway loop."""
    istate = step(False)
    runs = 1
    while bool((istate == C.CONTINUE).any()):
        if runs >= _RUNAWAY:
            raise RuntimeError("fused_solve: runaway continuation loop")
        istate = step(True)
        runs += 1
    return runs


def _solve_cuda(states_b: IdaState, params_b, tol: TolInputs, tout, opts, model, budget):
    dst = empty_result(states_b, opts, model)
    carry = new_carry(states_b.tn.shape[0], states_b.dtype, states_b.phi.device,
                      budget is not None)
    if budget is None:
        launch("", states_b, dst, params_b, tol, tout, carry, opts, model, None)
    else:
        run_until_done(lambda resume: launch(
            "cont" if resume else "init", dst if resume else states_b, dst, params_b, tol, tout,
            carry, opts, model, budget))
    return dst, carry["tret"], carry["istate"]


def _solve_plain(native: IdaState, problem, opts, tol, tout, budget):
    if budget is None:
        return solve(native, problem, opts, tol, tout, TASK_NORMAL)
    out = (native, None, None, None)

    def step(resume: bool) -> torch.Tensor:
        nonlocal out
        out = solve(out[0], problem, opts, tol, tout, TASK_NORMAL, max_attempts=budget,
                    resume_carry=out[3] if resume else None)
        return out[2]

    run_until_done(step)
    return out[:3]


def make_fused_solve(problem_factory, tol: TolControl, opts: IdaOptions = IdaOptions(), *,
                     attempt_budget: int | None = None):
    """Build ``fn(states_b, params_b, tout) -> (states_b, tret[B], istate[B])``
    running the whole TASK_NORMAL solve of every lane in one kernel launch
    (``ida_tpu.ops.fused_solve.make_fused_solve`` without its TPU-only
    ``tile`` and ``interpret``).

    ``states_b`` is a batch-leading IdaState (``ensemble_init``, float64 or
    float32), ``params_b`` [B, P], ``tout`` a number; the result is a new
    state, the input is not changed. ``tol`` is shared by every lane (rtol a
    scalar, atol a scalar or [N]) or per lane (rtol [B], atol [B, N]).
    ``attempt_budget`` bounds each launch to that many step attempts; the
    host relaunches the continuation until every lane is done, bit for bit
    the unbudgeted result. A lane whose ``constraints_set`` is on runs the
    inequality-constraints block as the eager solve does (unless
    ``opts.enable_constraints`` is False). The kernel compiles in
    ``opts``' linear solver ("dense", "band" or "spgmr") and arithmetic mode
    (``fast_math`` and ``ls_precision`` "full", "single" or, dense only,
    "refined"), as ``ida_tpu``'s kernel traces them; the state is laid out
    for them as ``ensemble_init(..., opts=opts)`` makes it (the factor
    float32 under the direct solvers' mixed modes, [B, 2*ml+mu+1, N] under
    "band", empty under "spgmr"). Under "spgmr" a factory with its own
    ``jtimes_fn``/``jtimes_setup`` or a preconditioner raises.

    ``problem_factory`` is ``models.roberts_factory`` (the hand-written
    model) or any batch-native factory with an analytic ``jac``, no roots
    and N <= ``MAXN``, whose model :func:`model_of` generates at the first
    call (on either device, so that what the kernel cannot take raises on
    the CPU too) and compiles at the first call on the card."""
    if attempt_budget is not None and attempt_budget < 1:
        raise ValueError(f"attempt_budget must be at least 1, got {attempt_budget}")
    if opts.debug_trace:
        raise ValueError("fused_solve: the kernel cannot dump per-attempt states "
                         "(debug_trace=True); trace the eager solve")
    tol_on_card: dict = {}  # (B, dtype, device, N) -> TolInputs, made at the first such call

    def fn(states_b: IdaState, params_b, tout):
        _refuse_derivatives(states_b, params_b, tol)
        dtype, dev = states_b.dtype, states_b.phi.device
        check_dtype(dtype)
        check_device(dev)
        _check_mode_state(states_b, opts)
        for f, x in zip(states_b._fields, states_b):
            if isinstance(x, torch.Tensor) and not x.is_contiguous():
                raise ValueError(f"fused_solve: state.{f} is not contiguous")
        p_b = torch.as_tensor(params_b, dtype=dtype, device=dev).contiguous()
        model = model_of(problem_factory, p_b.t())
        _refuse_krylov_hooks(model, opts)
        n = model.n
        if tuple(states_b.yy.shape[1:]) != (n,):
            raise ValueError(f"fused_solve: the state has yy {list(states_b.yy.shape)}, the "
                             f"factory's problem N = {n}")
        if dev.type == "cpu":
            p = p_b.t().contiguous()
            problem = problem_factory(p)
            native = native_clone(states_b)
            inputs = lane_inputs(native, p, _native_tol(tol, n), tout, n)
            st, tret, istate = _solve_plain(native, problem, opts,
                                            TolControl(inputs[1], inputs[2]), inputs[3],
                                            attempt_budget)
            return from_native(st), tret, istate
        key = (states_b.tn.shape[0], dtype, dev, n)
        if key not in tol_on_card:
            # once, not at every call: reading the tolerances off their
            # tensors synchronizes
            tol_on_card[key] = tol_inputs(tol, n, key[0], dtype, dev)
        return _solve_cuda(states_b, p_b, tol_on_card[key], tout, opts, model, attempt_budget)

    return fn


def _refuse_derivatives(states_b: IdaState, params_b, tol: TolControl) -> None:
    """Raise on an input that carries a derivative (module doc)."""
    named = [(f"state.{f}", x) for f, x in zip(states_b._fields, states_b)]
    named += [("params", params_b), ("tol.rtol", tol.rtol), ("tol.atol", tol.atol)]
    for name, x in named:
        if not isinstance(x, torch.Tensor):
            continue
        if x.requires_grad or forward_ad.unpack_dual(x).tangent is not None:
            raise ValueError(
                f"fused_solve: {name} carries a derivative, and the whole-solve kernel is "
                "forward-only; take gradients through the eager solve "
                "(ida_tpu_torch.sensitivity.adjoint_gradient)")


def _refuse_krylov_hooks(model: FusedModel, opts: IdaOptions) -> None:
    """Raise on what the Krylov path would call but the kernel does not
    compile in: a factory's own Jacobian-times-vector, a preconditioner."""
    if opts.linear_solver != "spgmr":
        return  # the direct solvers never call them, eager or in the kernel
    if model.jtimes:
        raise not_ported("a factory's own jtimes_fn/jtimes_setup in the whole-solve kernel", 22,
                         "ida_tpu/ops/fused_solve.py")
    if model.prec:
        raise not_ported("a preconditioner (prec_setup/prec_solve) in the whole-solve kernel", 22,
                         "ida_tpu/ops/fused_solve.py")


def _check_mode_state(states_b: IdaState, opts: IdaOptions) -> None:
    """Raise on a state laid out for another arithmetic mode or linear
    solver than ``opts``': its ``lu`` in the mode's dtype and the solver's
    shape (dense [B, N, N], band [B, 2*ml+mu+1, N], with piv [B, N]), and
    under "refined" an lsetup point of N components a lane (the kernel
    writes it there)."""
    want = _expected_dtype("lu", states_b.dtype, opts)
    n = states_b.yy.shape[1:]
    rows = {"dense": n[0], "band": 2 * opts.band_ml + opts.band_mu + 1}.get(opts.linear_solver)
    bad = (rows is not None and (
        states_b.lu.dtype != want or states_b.lu.shape[1:] != (rows, n[0])
        or states_b.piv.shape[1:] != n)) or (opts.ls_precision == "refined" and (
            states_b.ls_yy.shape[1:] != n or states_b.ls_yp.shape[1:] != n))
    if bad:
        raise ValueError(
            f"fused_solve: the state is not laid out for linear_solver="
            f"{opts.linear_solver!r}, ls_precision={opts.ls_precision!r} (lu "
            f"{states_b.lu.dtype} {tuple(states_b.lu.shape)}, ls_yy "
            f"{tuple(states_b.ls_yy.shape)}); make it with ensemble_init(..., opts=opts)")


def _native_tol(tol: TolControl, n: int) -> TolControl:
    """``tol`` for the batch-native plain version: a per-lane atol [B, N]
    becomes [N, B]; shared tolerances pass as they are."""
    atol = torch.as_tensor(tol.atol)
    return TolControl(tol.rtol, atol.t() if atol.dim() == 2 else atol)


def eval_model(problem_factory, params: torch.Tensor, t: torch.Tensor, cj: torch.Tensor,
               yy: torch.Tensor, yp: torch.Tensor, v: torch.Tensor):
    """The problem's residual, its system Jacobian at that residual, J v
    (the jvp with tangents (v, cj v)) and its quadratures on batch-native
    lanes: params [P, B], t and cj [B], yy, yp and v [N, B] -> (res [N, B],
    jac [N, N, B], jv [N, B], quad [nq, B] or None without quadratures).
    On CUDA tensors the compiled model alone (``fused_model_eval`` of
    :func:`build_eval`'s library, one thread a lane, counted in
    ``EVAL_LAUNCHES``); on CPU tensors its plain version, the eager
    problem's (:func:`eval_model_plain`)."""
    if yy.device.type == "cpu":
        return eval_model_plain(problem_factory, params, t, cj, yy, yp, v)
    check_dtype(yy.dtype)
    check_device(yy.device)
    model = model_of(problem_factory, params)
    n, bsz = model.n, yy.shape[-1]
    shapes = {"params": (params, (model.p, bsz)), "t": (t, (bsz,)), "cj": (cj, (bsz,)),
              "yy": (yy, (n, bsz)), "yp": (yp, (n, bsz)), "v": (v, (n, bsz))}
    for name, (x, shape) in shapes.items():
        if (tuple(x.shape) != shape or x.dtype != yy.dtype or x.device != yy.device
                or not x.is_contiguous()):
            raise ValueError(f"eval_model: {name} must be contiguous {list(shape)} "
                             f"{yy.dtype} on {yy.device}")
    out = {"res": yy.new_empty((n, bsz)), "jac": yy.new_empty((n, n, bsz)),
           "jv": yy.new_empty((n, bsz))}
    quad = yy.new_empty((model.nq, bsz)) if model.nq else None
    args = ModelEvalArgs(*(x.data_ptr() for x, _ in shapes.values()),
                         *(x.data_ptr() for x in out.values()), bsz,
                         None if quad is None else quad.data_ptr())
    name = f"fused_model_eval_{DTYPE_TAGS[yy.dtype]}"
    fn = getattr(build_eval(model)["lib"], name)
    raise_on(fn(ctypes.byref(args), model.id, stream_of(yy)), name)
    EVAL_LAUNCHES[model.name] = EVAL_LAUNCHES.get(model.name, 0) + 1
    return out["res"], out["jac"], out["jv"], quad


def eval_model_plain(problem_factory, params, t, cj, yy, yp, v):
    """:func:`eval_model`'s plain version on the tensors' own device: the
    eager problem's ``res``, ``sys_jacobian`` at that residual, ``jtimes``
    and ``quad`` (None without quadratures)."""
    problem = problem_factory(params)
    r = problem.res(t, yy, yp)
    quad = problem.quad(t, yy, yp) if problem.nquad else None
    return r, problem.sys_jacobian(t, cj, yy, yp, r), problem.jtimes(t, cj, yy, yp, v), quad
