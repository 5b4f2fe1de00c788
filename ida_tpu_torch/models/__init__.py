from .roberts import (
    ROBERTS_PARAMS,
    ROBERTS_YP0,
    ROBERTS_YY0,
    roberts_factory,
    roberts_problem,
)

__all__ = ["ROBERTS_PARAMS", "ROBERTS_YP0", "ROBERTS_YY0", "roberts_factory", "roberts_problem"]
