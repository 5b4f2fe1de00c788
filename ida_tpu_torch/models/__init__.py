from .roberts import ROBERTS_PARAMS, ROBERTS_YP0, ROBERTS_YY0, roberts_factory

__all__ = ["ROBERTS_PARAMS", "ROBERTS_YP0", "ROBERTS_YY0", "roberts_factory"]
