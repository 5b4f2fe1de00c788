from .foodweb import foodweb_ic, foodweb_problem
from .heat2d import heat2d_ic, heat2d_problem
from .lorenz63 import lorenz63_problem
from .roberts import (
    ROBERTS_PARAMS,
    ROBERTS_YP0,
    ROBERTS_YY0,
    roberts_factory,
    roberts_problem,
)
from .slider_crank import slider_crank_ic, slider_crank_problem

__all__ = [
    "ROBERTS_PARAMS", "ROBERTS_YP0", "ROBERTS_YY0", "foodweb_ic", "foodweb_problem",
    "heat2d_ic", "heat2d_problem", "lorenz63_problem", "roberts_factory", "roberts_problem",
    "slider_crank_ic", "slider_crank_problem",
]
