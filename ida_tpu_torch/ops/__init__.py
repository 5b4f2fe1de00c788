from .banded import (
    BandLU, band_factor, band_from_dense, band_jacobian, band_rows, band_solve, band_sys_jacobian,
    band_to_dense,
)
from .bbd import BBDPrec, make_bbd_prec
from .dense_lu import (
    DenseLU, lu_factor, lu_factor_auto, lu_factor_unrolled, lu_solve, lu_solve_auto, lu_solve_t,
    lu_solve_t_auto, lu_solve_unrolled, lu_solve_unrolled_t,
)
from .small_lu import lu_factor_solve

__all__ = [
    "BBDPrec", "BandLU", "band_factor", "band_from_dense", "band_jacobian", "band_rows",
    "band_solve", "band_sys_jacobian", "band_to_dense", "make_bbd_prec",
    "DenseLU", "lu_factor", "lu_factor_auto", "lu_factor_solve", "lu_factor_unrolled",
    "lu_solve", "lu_solve_auto", "lu_solve_t", "lu_solve_t_auto", "lu_solve_unrolled",
    "lu_solve_unrolled_t", "make_fused_solve",
]


def __getattr__(name):
    # fused_solve imports core.solve, whose Newton layer imports this
    # package's dense_lu: load it on first use to keep the import acyclic
    if name == "make_fused_solve":
        from .fused_solve import make_fused_solve

        return make_fused_solve
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
