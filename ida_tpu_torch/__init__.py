"""ida_tpu_torch: the PyTorch/CUDA port of ``ida_tpu`` (SUNDIALS IDA) for
NVIDIA Hopper.

The layout mirrors ``ida_tpu``: ``core`` (state, BDF routines, Newton,
step, solve), ``ops`` (dense LU and its CUDA kernel), ``parallel``
(ensembles), ``models``, ``utils``. This package imports ``torch`` only;
it never imports ``jax`` or ``ida_tpu``.
"""

from . import constants
from .core.solve import TASK_NORMAL, TASK_ONE_STEP, solve
from .core.state import IdaOptions, IdaState, init_state
from .problem import IdaProblem
from .tol_control import TolControl, tol_ss, tol_sv

__all__ = [
    "IdaOptions", "IdaProblem", "IdaState", "TASK_NORMAL", "TASK_ONE_STEP", "TolControl",
    "constants", "init_state", "solve", "tol_ss", "tol_sv",
]
