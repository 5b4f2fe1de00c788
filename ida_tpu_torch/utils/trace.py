"""Numerical data-trace: per-step-attempt state dumps for divergence hunting.

Port of ``ida_tpu/utils/trace.py`` (the reference's ``data_trace`` feature
serializes the whole ``Ida`` struct to JSON every step attempt, reference
src/lib.rs:635-639). With ``IdaOptions.debug_trace`` on, the step-attempt
loop hands the state to :func:`trace_sink` before every attempt: a plain
call, since the port's loops run on the host. A record carries whatever
batch shape the lanes have, plus ``schema``, the version of the record
layout (bump it when a field is added, renamed or changes meaning, so a
program that compares traces can refuse a fixture it does not understand).
"""

from __future__ import annotations

import json
import threading
from typing import Any, Optional

import torch

TRACE_SCHEMA = 1

_lock = threading.Lock()
_collector: Optional["DataTrace"] = None

TRACE_FIELDS = (
    # the WHOLE integrator struct, mirroring the reference's derive(Serialize)
    # on Ida and its nested nonlinear/linear problem state: everything except
    # the preconditioner workspace (pdata) and the quadrature accumulator (yQ)
    # --- BDF history and coefficients ---
    "phi", "psi", "alpha", "beta", "sigma", "gamma",
    # --- work vectors ---
    "ee", "yy", "yp", "yypredict", "yppredict", "ewt", "savres",
    # --- step data ---
    "tn", "hh", "hused", "rr", "h0u", "tretlast", "tolsf",
    "kk", "kused", "knew", "phase", "ns",
    # --- nonlinear-solver state ---
    "cj", "cjlast", "cjold", "cjratio", "ss", "oldnrm", "eps_newt", "toldel",
    # --- linear-solver state (dense factors) ---
    "lu", "piv",
    # --- per-lane options ---
    "hin", "hmax_inv", "epcon", "tstop", "tstop_set",
    "constraints", "constraints_set",
    # --- counters ---
    "nst", "nre", "ncfn", "netf", "nni", "nsetups", "nje", "nge",
    "nli", "nps", "ncfl", "njtsetup", "njtimes",
    # --- rootfinding lanes ---
    "tlo", "thi", "trout", "ttol", "toutc",
    "glo", "ghi", "grout", "iroots", "rootdir", "gactive", "irfnd", "taskc",
    # --- outcome lane ---
    "status",
)


class DataTrace:
    """Host-side collector; use as a context manager around solve calls."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: list[dict] = []
        self._fh = None

    def __enter__(self):
        global _collector
        with _lock:
            _collector = self
        if self.path:
            self._fh = open(self.path, "w")
        return self

    def __exit__(self, *exc):
        global _collector
        with _lock:
            _collector = None
        if self._fh:
            self._fh.close()
            self._fh = None
        return False

    def emit(self, record: dict):
        rec: dict = {"schema": TRACE_SCHEMA}
        for k, v in record.items():
            v = torch.as_tensor(v).detach().cpu()
            # scalars as floats (bools and ints too), like the JAX emitter
            rec[k] = v.tolist() if v.dim() else float(v)
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")


def trace_sink(**record: Any) -> None:
    """Called by ``core.step.attempt_once`` under ``debug_trace``; drops the
    record when no collector is active (nothing is read from the device
    then, so debug_trace=True costs little outside a DataTrace block)."""
    c = _collector
    if c is not None:
        c.emit(record)
