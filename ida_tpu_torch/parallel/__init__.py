from .batch import (EnsembleIDA, ensemble_init, from_native, make_ensemble_solve,
                    make_stratified_solve, pilot_cost, to_native)

__all__ = ["EnsembleIDA", "ensemble_init", "from_native", "make_ensemble_solve",
           "make_stratified_solve", "pilot_cost", "to_native"]
