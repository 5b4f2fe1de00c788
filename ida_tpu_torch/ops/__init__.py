from .dense_lu import (
    DenseLU, lu_factor, lu_factor_auto, lu_factor_unrolled, lu_solve, lu_solve_auto,
    lu_solve_unrolled,
)
from .small_lu import lu_factor_solve

__all__ = [
    "DenseLU", "lu_factor", "lu_factor_auto", "lu_factor_solve", "lu_factor_unrolled",
    "lu_solve", "lu_solve_auto", "lu_solve_unrolled",
]
