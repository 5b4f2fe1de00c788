"""Profiling hooks.

Port of ``ida_tpu/utils/profiling.py``. The reference profiles with
``thread_profiler`` scopes around each hot routine and writes a Chrome trace
(SURVEY.md §5); ``ida_tpu`` puts a ``jax.named_scope("ida.<name>")`` on each
and traces with the XLA profiler. Here:

* :func:`scope` is a decorator that runs the function inside
  ``torch.profiler.record_function("ida.<name>")`` while a profiler is
  recording (so a ``torch.profiler`` trace attributes host time, and the
  device work launched inside, to the routine), and inside an NVTX range of
  the same name on a CUDA build with a card (for Nsight Systems). It changes
  no value. With no profiler recording, the cost is one flag read and the
  NVTX push and pop; ``ENABLED = False`` turns both off.
* :func:`profile` records a ``torch.profiler`` trace of the CPU and, where
  there is one, the card around a block and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import warnings

import torch

# False: every scope calls its function bare (no record_function, no NVTX)
ENABLED = True


@functools.cache
def _nvtx() -> bool:
    """An NVTX range is opened where torch is a CUDA build and sees a card."""
    return torch.version.cuda is not None and torch.cuda.is_available()


def scope(name: str):
    """Decorator: run the function under the profiler label ``ida.<name>``
    (module doc)."""
    label = f"ida.{name}"

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ENABLED:
                return fn(*args, **kwargs)
            nvtx = _nvtx()
            if nvtx:
                torch.cuda.nvtx.range_push(label)
            try:
                if torch.autograd.profiler._is_profiler_enabled:
                    with torch.profiler.record_function(label):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()

        return wrapper

    return deco


@contextlib.contextmanager
def profile(trace_dir: str):
    """Record a ``torch.profiler`` trace around a block and write it to
    ``trace_dir/trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``)::

        with ida_tpu_torch.utils.profiling.profile("traces/run1") as prof:
            ens.solve(400.0)
        prof.key_averages()  # the ``ida.<name>`` scopes among the rows

    The card's activity is recorded where one is available. Yields the
    ``torch.profiler.profile`` object, or None where the profiler cannot
    start: then, as in ``ida_tpu``, the block runs unprofiled with a warning.
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # backend dependent
        warnings.warn(f"ida_tpu_torch: profiler unavailable ({e}); running unprofiled")
        yield None
        return
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
