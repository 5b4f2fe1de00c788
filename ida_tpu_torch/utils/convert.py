"""Carry states, parameters and tolerances over from numpy.

The tests hand both packages identical inputs: a JAX-package state becomes
``{f: np.asarray(getattr(st, f)) for f in st._fields}`` and goes through
:func:`state_from_numpy`. Each field keeps its dtype. ``batch`` names where
the given arrays carry their batch axis: "leading" (a vmapped ensemble,
moved to the back here) or "trailing" (already batch-native, or a single
unbatched lane). The results are batch-native, the layout the core routines
and ``core.solve.solve`` take.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.state import IdaState
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
    """Port ``IdaState`` from per-field numpy arrays (``pdata`` becomes ())."""
    return IdaState(
        **{
            f: () if f == "pdata" else _tensor(fields[f], device, batch)
            for f in IdaState._fields
        }
    )


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
