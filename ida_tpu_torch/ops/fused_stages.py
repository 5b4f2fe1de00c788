"""One solver stage at a time: the K5 stage kernels of ``csrc/fused_solve.cu``.

Counterpart of ``scripts/bisect_fused.py::build_stage`` (which compiled one
stage inside a Pallas TPU kernel to find where Mosaic failed): each
``fused_stage_<name>`` kernel runs one of the device functions the
whole-solve kernel is built from, alone, on a batch of real states. Held
against the eager stage on the same tensors, it finds the first stage where
the kernel and the eager port part ways.

:func:`run_stage` runs the stage kernel on CUDA tensors and the eager stage
(the plain version) on CPU tensors. A stage's extra inputs and outputs (the
error coefficient ``ck``, the error norms, ``saved_t``, the failure
counters, status codes) are [B] tensors named in :data:`STAGES`; inputs not
given take the defaults of :data:`DEFAULTS` (those of bisect_fused.py).
Every stage runs the hand-written Roberts model at the default
``IdaOptions()``: the stage kernels are compiled into the parity library of
Roberts only (a generated model's library has none). ``STAGE_LAUNCHES[name]`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.coeffs import predict, set_coeffs
from ..core.complete_step import complete_step
from ..core.error_test import error_test
from ..core.interp import get_solution
from ..core.nls import nonlinear_solve
from ..core.solve import TASK_NORMAL, _first_call_init, _stop_test1, _stop_test2
from ..core.state import IdaOptions, IdaState
from ..core.step import attempt_once
from ..models.roberts import roberts_factory
from ..tol_control import TolControl
from . import fused_solve as fs
from ._build import DTYPE_TAGS


class Stage(NamedTuple):
    floats: tuple  # names of the real slots (aux_f rows), in order
    ints: tuple  # names of the int32 slots (aux_i rows), in order
    inputs: tuple  # the slots read by the stage (the others are written)


# the stages of scripts/bisect_fused.py minus loop_only/solve/solve_budget,
# which are the whole-solve kernels themselves
STAGES = {
    "set_coeffs": Stage(("ck",), (), ()),  # set_coeffs, then predict
    "nls": Stage((), ("nl_status",), ()),
    "error_test": Stage(("ck", "err_k", "err_km1"), ("converged",), ("ck",)),
    "complete_step": Stage(("err_k", "err_km1", "ck"), (), ("err_k", "err_km1", "ck")),
    "attempt": Stage(("saved_t", "ck", "err_k", "err_km1"), ("ncf", "nef", "success", "fatal"),
                     ("saved_t", "ncf", "nef")),
    "prologue": Stage((), ("istate",), ()),  # _first_call_init
    "stoptest": Stage(("tret", "itgt"), ("istate1", "istate2", "ikind"), ()),
    "getsol": Stage((), ("ok",), ()),  # get_solution at tout
}
DEFAULTS = {"ck": 0.5, "err_k": 1e-3, "err_km1": 2e-3, "ncf": 0, "nef": 0}  # saved_t: tn

STAGE_LAUNCHES = {name: 0 for name in STAGES}


def reset_launch_counts() -> None:
    for name in STAGE_LAUNCHES:
        STAGE_LAUNCHES[name] = 0


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = fs.build()["lib"]
    args = [ctypes.POINTER(fs.StateRefs)] + [ctypes.c_void_p] * 6 + [
        ctypes.POINTER(fs.Opts), ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    for name in STAGES:
        for dt in DTYPE_TAGS.values():
            fn = getattr(lib, f"fused_stage_{name}_{dt}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _aux_inputs(stage: Stage, state: IdaState, aux: dict | None) -> dict:
    bsz, dtype, dev = state.tn.shape[-1], state.dtype, state.phi.device
    aux = dict(aux or {})
    out = {}
    for name in stage.inputs:
        default = state.tn if name == "saved_t" else DEFAULTS[name]
        dt = dtype if name in stage.floats else torch.int32
        out[name] = torch.broadcast_to(
            torch.as_tensor(aux.pop(name, default), dtype=dt, device=dev), (bsz,)).contiguous()
    if aux:
        raise ValueError(f"run_stage: {sorted(aux)} are not inputs of this stage")
    return out


def _eager(name: str, st: IdaState, problem, opts: IdaOptions, tol: TolControl, tout, a: dict):
    i32 = torch.int32
    if name == "set_coeffs":
        st, ck = set_coeffs(st)
        return predict(st), {"ck": ck}
    if name == "nls":
        st, nl = nonlinear_solve(st, problem, opts)
        return st, {"nl_status": nl}
    if name == "error_test":
        st, r = error_test(st, problem, opts, a["ck"])
        return st, {"err_k": r.err_k, "err_km1": r.err_km1, "converged": r.converged.to(i32)}
    if name == "complete_step":
        return complete_step(st, problem, opts, a["err_k"], a["err_km1"], ck=a["ck"]), {}
    if name == "attempt":
        st, success, fatal, ck, err_k, err_km1, ncf, nef = attempt_once(
            st, problem, opts, a["saved_t"], a["ncf"], a["nef"])
        return st, {"ck": ck, "err_k": err_k, "err_km1": err_km1, "ncf": ncf.to(i32),
                    "nef": nef.to(i32), "success": success.to(i32), "fatal": fatal.to(i32)}
    if name == "prologue":
        st, istate = _first_call_init(st, problem, opts, tol, tout)
        return st, {"istate": istate}
    if name == "stoptest":
        st, tret, ist1 = _stop_test1(st, tout, st.tn, TASK_NORMAL)
        st, tret, ist2, ikind, itgt = _stop_test2(st, tout, tret, TASK_NORMAL)
        return st, {"tret": tret, "itgt": itgt, "istate1": ist1, "istate2": ist2, "ikind": ikind}
    st, ok = get_solution(st, tout)
    return st, {"ok": ok.to(i32)}


def _prepare(stage: str, state: IdaState, params, tol: TolControl, tout, aux):
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: {list(STAGES)}")
    model, n = fs.ROBERTS.id, fs.ROBERTS.n
    fs.check_dtype(state.dtype)
    fs.check_device(state.phi.device)
    a = _aux_inputs(STAGES[stage], state, aux)
    native = IdaState(*(x.clone(memory_format=torch.contiguous_format)
                        if isinstance(x, torch.Tensor) else x for x in state))
    return model, native, fs.lane_inputs(native, params, tol, tout, n), a


def plain_stage(stage: str, state: IdaState, params, tol: TolControl, tout,
                aux: dict | None = None):
    """The plain version of a stage: the eager stage function, on the
    tensors' own device. Same arguments and returns as :func:`run_stage`."""
    _, native, (params, rtol, atol, tout_l), a = _prepare(stage, state, params, tol, tout, aux)
    st, out = _eager(stage, native, roberts_factory(params), IdaOptions(),
                     TolControl(rtol, atol), tout_l, a)
    return st, {**a, **out}


def prepare_launch(stage: str, state: IdaState, params, tol: TolControl, tout,
                   aux: dict | None = None):
    """The stage kernel's inputs on the card, ready to launch. Returns
    ``(launch, state, outputs)``: each ``launch()`` runs the kernel once,
    in place on ``state`` (a copy of the input) and on the [B] tensors of
    ``outputs``."""
    model, native, (params, rtol, atol, tout_l), a = _prepare(stage, state, params, tol, tout, aux)
    spec = STAGES[stage]
    bsz, dtype, dev = native.tn.shape[-1], native.dtype, native.phi.device
    aux_f = torch.zeros((max(len(spec.floats), 1), bsz), dtype=dtype, device=dev)
    aux_i = torch.zeros((max(len(spec.ints), 1), bsz), dtype=torch.int32, device=dev)
    for name, t in a.items():
        if name in spec.floats:
            aux_f[spec.floats.index(name)] = t
        else:
            aux_i[spec.ints.index(name)] = t
    name = f"fused_stage_{stage}_{DTYPE_TAGS[dtype]}"
    fn = getattr(_bind(), name)
    refs, opts_c = fs.state_refs(native, -1, IdaOptions(), fs.ROBERTS), fs.opts_struct(IdaOptions())

    def launch() -> None:
        # the closure holds every tensor the kernel reads, so none is freed
        # while a launch may still read it
        err = fn(ctypes.byref(refs), params.data_ptr(), rtol.data_ptr(), atol.data_ptr(),
                 tout_l.data_ptr(), aux_f.data_ptr(), aux_i.data_ptr(), ctypes.byref(opts_c),
                 model, bsz, fs.stream_of(native.tn))
        fs.raise_on(err, name)
        STAGE_LAUNCHES[stage] += 1

    out = {name: aux_f[k] for k, name in enumerate(spec.floats)}
    out.update({name: aux_i[k] for k, name in enumerate(spec.ints)})
    return launch, native, out


def run_stage(stage: str, state: IdaState, params, tol: TolControl, tout, aux: dict | None = None):
    """Run one stage on a batch-native ``state`` ([..., B]) with params
    [P, B], shared or per-lane ``tol`` and a number or [B] ``tout``: the
    stage kernel on CUDA tensors, :func:`plain_stage` on CPU tensors.
    Returns ``(state, outputs)``: the stage's state (a new one; the input is
    not changed) and a dict of [B] tensors, one per slot of ``STAGES[stage]``."""
    if state.phi.device.type == "cpu":
        return plain_stage(stage, state, params, tol, tout, aux)
    launch, native, out = prepare_launch(stage, state, params, tol, tout, aux)
    launch()
    return native, out
