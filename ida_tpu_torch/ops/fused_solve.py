"""The whole solve in one CUDA kernel: ``csrc/fused_solve.cu``.

Counterpart of ``ida_tpu/ops/fused_solve.py::make_fused_solve``: the Pallas
TPU kernels K2 (``make_fused_solve`` -> ``kern``), K3 and K4 (the budgeted
``fn_init.kern`` / ``fn_cont.kern``) become one hand-written kernel for
Hopper, one thread per lane, with the attempt loop on the device. Unlike the
TPU kernel (float32 only, state packed into two buffers, 1024-lane tiles) it
reads the batch-native ``IdaState`` fields in their own dtypes, float64 or
float32, and takes any batch size.

On CUDA tensors ``fn`` clones the batch-native state and launches the kernel
on the clones (in place): once, or with ``attempt_budget`` the budgeted
kernel and then its continuation until no lane is CONTINUE. On CPU tensors
it runs the plain version: the eager ``core.solve`` (with the same budgeted
host loop when a budget is given). On any other device, and on what the
kernel does not take, it raises; nothing falls back on a CUDA tensor.

``FUSED_LAUNCHES``, ``FUSED_INIT_LAUNCHES`` and ``FUSED_CONT_LAUNCHES`` count
the kernel launches (and only those).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import constants as C
from ..core.solve import TASK_NORMAL, solve
from ..core.state import IdaOptions, IdaState
from ..models.roberts import roberts_factory
from ..parallel.batch import from_native
from ..tol_control import TolControl
from ._build import DTYPE_TAGS, build_library

FUSED_LAUNCHES = 0
FUSED_INIT_LAUNCHES = 0
FUSED_CONT_LAUNCHES = 0

# the compiled-in models: factory -> (model id of the kernel, N, P)
MODELS = {roberts_factory: (0, 3, 3)}

# csrc/ida_lane.cuh IDA_STATE_FIELDS, in its order
STATE_FIELDS = (
    "phi", "psi", "alpha", "beta", "sigma", "gamma", "ee", "yy", "yp", "yypredict",
    "yppredict", "ewt", "savres", "tn", "hh", "hused", "rr", "h0u", "tretlast", "tolsf",
    "kk", "kused", "knew", "phase", "ns", "cj", "cjlast", "cjold", "cjratio", "ss", "oldnrm",
    "eps_newt", "toldel", "lu", "piv", "hin", "hmax_inv", "epcon", "tstop", "tstop_set",
    "nst", "nre", "ncfn", "netf", "nni", "nsetups", "nje", "toutc", "taskc", "status",
)
_INT32 = {"kk", "kused", "knew", "phase", "ns", "piv", "taskc", "status"}
_INT64 = {"nst", "nre", "ncfn", "netf", "nni", "nsetups", "nje"}
_BOOL = {"tstop_set"}

# the attempt loop's carry (core/solve.py _Loop minus the state), in order
CARRY_FIELDS = ("tret", "istate", "nstloc", "saved_t", "ncf", "nef", "fresh", "ikind", "itgt")
_CARRY_REAL = {"tret", "saved_t", "itgt"}
_RUNAWAY = 100_000


class StateRefs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in STATE_FIELDS]


class CarryRefs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in CARRY_FIELDS]


class Opts(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in
                ("maxord", "mxstep", "maxncf", "maxnef", "maxnlsit", "suppressalg")]


def reset_launch_counts() -> None:
    global FUSED_LAUNCHES, FUSED_INIT_LAUNCHES, FUSED_CONT_LAUNCHES
    FUSED_LAUNCHES = FUSED_INIT_LAUNCHES = FUSED_CONT_LAUNCHES = 0


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of the solve entry points of ``lib``."""
    solve_args = [ctypes.POINTER(StateRefs)] + [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(CarryRefs), ctypes.POINTER(Opts), ctypes.c_int, ctypes.c_longlong]
    for dt in DTYPE_TAGS.values():
        for kind in ("", "_init", "_cont"):
            fn = getattr(lib, f"fused_solve{kind}_{dt}")
            fn.argtypes = solve_args + ([ctypes.c_int] if kind else []) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def build() -> dict:
    """Compile (once per hash of the sources) and load the kernel library;
    see :func:`._build.build_library`."""
    info = build_library("fused_solve.cu", ("ida_lane.cuh", "small_lu.cuh"),
                         fmad_sources=("torch_pow.cu",))
    bind(info["lib"])
    return info


def model_of(problem_factory) -> tuple[int, int, int]:
    """(model id, N, P) of a factory the kernel has compiled in; raises for
    any other."""
    try:
        return MODELS[problem_factory]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"fused_solve: no compiled-in model for {problem_factory!r}; the kernel has "
            f"{[f.__name__ for f in MODELS]}"
        ) from None


def check_dtype(dtype: torch.dtype) -> None:
    if dtype not in DTYPE_TAGS:
        raise TypeError(f"fused_solve: the kernel takes float32 or float64 states, got {dtype}")


def check_device(device: torch.device) -> None:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_solve: runs on CUDA (kernel) or CPU (plain version), got {device}")


def _expected_dtype(field: str, dtype: torch.dtype) -> torch.dtype:
    if field in _INT32:
        return torch.int32
    if field in _INT64:
        return torch.int64
    if field in _BOOL:
        return torch.bool
    return dtype


def state_refs(native: IdaState) -> StateRefs:
    """Pointer table of a batch-native state on the card; checks every field
    the kernel touches (device, dtype, contiguity, trailing batch axis)."""
    dtype, bsz = native.dtype, native.tn.shape[-1]
    ptrs = {}
    for f in STATE_FIELDS:
        x = getattr(native, f)
        want = _expected_dtype(f, dtype)
        if not x.is_cuda:
            raise ValueError(f"fused_solve: state.{f} is on {x.device}, not on the card")
        if x.dtype != want:
            raise TypeError(f"fused_solve: state.{f} is {x.dtype}, the kernel takes {want}")
        if not x.is_contiguous() or x.dim() < 1 or x.shape[-1] != bsz:
            raise ValueError(f"fused_solve: state.{f} must be contiguous [..., {bsz}]")
        ptrs[f] = x.data_ptr()
    return StateRefs(**ptrs)


def opts_struct(opts: IdaOptions) -> Opts:
    return Opts(opts.maxord, opts.mxstep, opts.maxncf, opts.maxnef, opts.maxnlsit,
                int(opts.suppressalg))


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({torch.cuda.get_device_name()})")


def lane_inputs(native: IdaState, params, tol: TolControl, tout, n: int):
    """Per-lane kernel inputs on the state's device and dtype: params [P, B]
    (from batch-last params), rtol [B], atol [N, B], tout [B]."""
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
    """Batch-leading -> batch-native copies the kernel may update in place."""
    return IdaState(*(
        x.movedim(0, -1).clone(memory_format=torch.contiguous_format)
        if isinstance(x, torch.Tensor) else x
        for x in states_b
    ))


def launch(kind: str, native: IdaState, inputs, carry: dict, opts: IdaOptions, model: int,
           budget: int | None) -> torch.Tensor:
    """One launch of the whole-solve kernel on the batch-native ``native``
    (in place) and ``carry``: ``kind`` "" (K2), "init" (K3) or "cont" (K4,
    resuming ``carry``). Returns the istate it writes."""
    global FUSED_LAUNCHES, FUSED_INIT_LAUNCHES, FUSED_CONT_LAUNCHES
    lib = build()["lib"]
    dt = DTYPE_TAGS[native.dtype]
    name = f"fused_solve_{dt}" if kind == "" else f"fused_solve_{kind}_{dt}"
    refs = CarryRefs(**{f: t.data_ptr() for f, t in carry.items()})
    args = [ctypes.byref(state_refs(native)), *(t.data_ptr() for t in inputs), ctypes.byref(refs),
            ctypes.byref(opts_struct(opts)), model, native.tn.shape[-1]]
    if budget is not None:
        args.append(budget)
    raise_on(getattr(lib, name)(*args, stream_of(native.tn)), name)
    if kind == "":
        FUSED_LAUNCHES += 1
    elif kind == "init":
        FUSED_INIT_LAUNCHES += 1
    else:
        FUSED_CONT_LAUNCHES += 1
    return carry["istate"]


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


def _solve_cuda(native: IdaState, inputs, opts, model, budget):
    carry = new_carry(native.tn.shape[-1], native.dtype, native.phi.device, budget is not None)
    if budget is None:
        launch("", native, inputs, carry, opts, model, None)
    else:
        run_until_done(lambda resume: launch("cont" if resume else "init", native, inputs, carry,
                                             opts, model, budget))
    return carry["tret"], carry["istate"]


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
    float32), ``params_b`` [B, P], ``tout`` a number; ``tol`` is shared by
    every lane. ``attempt_budget`` bounds each launch to that many step
    attempts; the host relaunches the continuation until every lane is done,
    bit for bit the unbudgeted result."""
    model, n, _ = model_of(problem_factory)
    if attempt_budget is not None and attempt_budget < 1:
        raise ValueError(f"attempt_budget must be at least 1, got {attempt_budget}")

    def fn(states_b: IdaState, params_b, tout):
        dtype, dev = states_b.dtype, states_b.phi.device
        check_dtype(dtype)
        check_device(dev)
        for f, x in zip(states_b._fields, states_b):
            if isinstance(x, torch.Tensor) and not x.is_contiguous():
                raise ValueError(f"fused_solve: state.{f} is not contiguous")
        p = torch.as_tensor(params_b, dtype=dtype, device=dev).t().contiguous()
        problem = problem_factory(p)
        if problem.nroots:
            raise NotImplementedError(
                "fused_solve: rootfinding (nroots > 0) is not supported in the fused kernel "
                "path; use parallel.make_ensemble_solve for problems with events"
            )
        native = native_clone(states_b)
        inputs = lane_inputs(native, p, tol, tout, n)
        if dev.type == "cpu":
            st, tret, istate = _solve_plain(native, problem, opts,
                                            TolControl(inputs[1], inputs[2]), inputs[3],
                                            attempt_budget)
        else:
            tret, istate = _solve_cuda(native, inputs, opts, model, attempt_budget)
            st = native
        return from_native(st), tret, istate

    return fn
