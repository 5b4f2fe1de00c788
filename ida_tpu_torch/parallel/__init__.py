from .batch import EnsembleIDA, ensemble_init, from_native, make_ensemble_solve, to_native

__all__ = ["EnsembleIDA", "ensemble_init", "from_native", "make_ensemble_solve", "to_native"]
