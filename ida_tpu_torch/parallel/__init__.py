from .batch import (EnsembleIDA, ensemble_init, from_native, make_ensemble_solve,
                    make_stratified_solve, pilot_cost, to_native)
from .mesh import (make_mesh, make_mesh_2d, shard_ensemble, shard_ensemble_2d, shard_state_vector,
                   sharded_calc_ic, sharded_solve)

__all__ = ["EnsembleIDA", "ensemble_init", "from_native", "make_ensemble_solve", "make_mesh",
           "make_mesh_2d", "make_stratified_solve", "pilot_cost", "shard_ensemble",
           "shard_ensemble_2d", "shard_state_vector", "sharded_calc_ic", "sharded_solve",
           "to_native"]
