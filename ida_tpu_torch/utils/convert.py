"""Carry states, parameters and tolerances over from numpy.

The tests hand both packages identical inputs: a JAX-package state becomes
per-field numpy arrays (:func:`state_fields`; the preconditioner state
``pdata`` a tuple of them) and goes through :func:`state_from_numpy`. Each
field keeps its dtype. ``batch`` names where the given arrays carry their
batch axis: "leading" (a vmapped ensemble, moved to the back here) or
"trailing" (already batch-native, or a single unbatched lane). The results
are batch-native, the layout the core routines and ``core.solve.solve``
take. The root fields ([R] per lane: glo, ghi, grout, iroots, rootdir,
gactive) travel like any other.

:func:`ida_from_numpy` and :func:`ensemble_from_numpy` build the port's
``IDA`` and ``EnsembleIDA`` from the numpy ``y0, yp0, params, tol`` the JAX
objects take (and the same ``IdaOptions`` fields, the Krylov ones
included), so one seed feeds both packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.state import IdaOptions, IdaState
from ..tol_control import TolControl


def _tensor(arr, device, batch: str) -> torch.Tensor:
    if batch not in ("leading", "trailing"):
        raise ValueError(f"batch must be 'leading' or 'trailing', got {batch!r}")
    t = torch.from_numpy(np.array(arr, copy=True)).to(device)
    if batch == "leading":
        t = t.movedim(0, -1).contiguous()
    return t


def state_from_numpy(
    fields: Mapping[str, np.ndarray], *, device, batch: str = "leading"
) -> IdaState:
    """Port ``IdaState`` from per-field numpy arrays. ``pdata`` is a tuple
    of arrays (the preconditioner state, leaf by leaf in ``ida_tpu``'s
    layout) or empty."""
    return IdaState(
        **{
            f: tuple(_tensor(x, device, batch) for x in fields[f]) if f == "pdata"
            else _tensor(fields[f], device, batch)
            for f in IdaState._fields
        }
    )


def state_fields(st) -> dict:
    """An ``ida_tpu`` state as the per-field numpy arrays
    :func:`state_from_numpy` takes (``pdata`` as a tuple of arrays)."""
    return {f: tuple(np.asarray(x) for x in st.pdata) if f == "pdata" else np.asarray(getattr(st, f))
            for f in st._fields}


def params_from_numpy(params: np.ndarray, *, device, batch: str = "leading") -> torch.Tensor:
    """Per-lane parameters [B, P] (leading) or [P, B] (trailing) -> [P, B]."""
    return _tensor(params, device, batch)


def tol_from_numpy(fields: Mapping[str, np.ndarray], *, device, batch: str = "leading") -> TolControl:
    """``{"rtol", "atol"}`` -> TolControl; per-lane tolerances come out
    batch-native (rtol [B], atol [N, B]). Shared tolerances (no batch axis)
    take ``batch="trailing"``."""
    return TolControl(
        rtol=_tensor(fields["rtol"], device, batch), atol=_tensor(fields["atol"], device, batch)
    )


def _dtype_of(arr) -> torch.dtype:
    """float32 stays float32; everything else is float64 (the JAX package
    runs with x64 on)."""
    return torch.float32 if np.asarray(arr).dtype == np.float32 else torch.float64


def _shared_tol(tol: Mapping[str, np.ndarray], dtype: torch.dtype) -> TolControl:
    return TolControl(torch.as_tensor(np.asarray(tol["rtol"]), dtype=dtype),
                      torch.as_tensor(np.asarray(tol["atol"]), dtype=dtype))


def ida_from_numpy(problem, y0, yp0, tol: Mapping[str, np.ndarray], *, device,
                   options: IdaOptions = IdaOptions(), t0: float = 0.0):
    """The port's ``IDA`` for one lane from numpy ``y0``/``yp0`` [N] and
    ``{"rtol", "atol"}``, in the dtype of ``y0``."""
    from ..solver import IDA

    dtype = _dtype_of(y0)
    return IDA(problem, np.asarray(y0), np.asarray(yp0), _shared_tol(tol, dtype), options, t0=t0,
               dtype=dtype, device=device)


def ensemble_from_numpy(problem_factory, params, y0, yp0, tol: Mapping[str, np.ndarray], *,
                        device, options: IdaOptions = IdaOptions()):
    """The port's ``EnsembleIDA`` from numpy ``params`` [B, P], ``y0``/``yp0``
    [B, N] and shared ``{"rtol", "atol"}``, in the dtype of ``y0``."""
    from ..parallel import EnsembleIDA

    dtype = _dtype_of(y0)
    return EnsembleIDA(problem_factory, np.asarray(params), np.asarray(y0), np.asarray(yp0),
                       _shared_tol(tol, dtype), options, dtype=dtype, device=device)
