from .batch import ensemble_init, from_native, make_ensemble_solve, to_native

__all__ = ["ensemble_init", "from_native", "make_ensemble_solve", "to_native"]
