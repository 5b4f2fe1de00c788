"""ida_tpu_torch: the PyTorch/CUDA port of ``ida_tpu`` (SUNDIALS IDA) for
NVIDIA Hopper.

The layout mirrors ``ida_tpu``: ``solver`` (the ``IDA`` object API), ``api``
(``solve_dae``), ``core`` (state, BDF routines, Newton, step, roots, solve),
``ops`` (dense LU and the CUDA kernels), ``parallel`` (ensembles),
``models``, ``utils``. This package imports ``torch`` only; it never
imports ``jax`` or ``ida_tpu``. Entry points run on the current CUDA device
unless ``device="cpu"`` is asked for, and build float64 tensors unless a
dtype is given.
"""

from . import constants
from .api import DAESolution, solve_dae
from .core.solve import TASK_NORMAL, TASK_ONE_STEP, DenseEvents, solve, solve_dense
from .core.state import IdaOptions, IdaState, init_state
from .norms import wrms_norm, wrms_norm_masked
from .problem import IdaProblem
from .solver import IDA, IdaError, IdaSolveStatus, IdaTask
from .tol_control import TolControl, tol_ss, tol_sv

__all__ = [
    "DAESolution", "DenseEvents", "IDA", "IdaError", "IdaOptions", "IdaProblem", "IdaSolveStatus",
    "IdaState", "IdaTask", "TASK_NORMAL", "TASK_ONE_STEP", "TolControl", "constants",
    "init_state", "solve", "solve_dae", "solve_dense", "tol_ss", "tol_sv", "wrms_norm",
    "wrms_norm_masked",
]
