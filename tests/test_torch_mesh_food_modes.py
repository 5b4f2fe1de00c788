"""The food web's features and modes on a state vector over four gloo
ranks on the CPU (``tests/test_torch_mesh_food.py`` has its IC and base
legs; four gloo ranks spawned once for this module): constraints, a root
function, a quadrature, ``ls_precision="single"``,
``krylov_storage="bfloat16"`` and ``fast_math`` from the same IC, one case
each, bit for bit the port's unsharded run and with ``ida_tpu``'s counters
and root returns.
"""

import pytest
import torch

import torch_mesh_ranks as R
from ida_tpu_torch import constants as C
from test_torch_mesh import _jax_calls, _same_calls, food_unsharded_of, jax_food  # noqa: F401

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)

MODES = tuple(c for c in R.FOOD_CASES if c != "base")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the food web's other cases (one spawn)."""
    return R.spawn(str(tmp_path_factory.mktemp("mesh_food_modes")), ("food_modes",))


@pytest.fixture(scope="module")
def food_unsharded():
    return food_unsharded_of(MODES, two_d=False)


@pytest.mark.parametrize("case", MODES)
def test_sharded_foodweb_features_and_modes(ranks, food_unsharded, jax_food, case):
    # constraints, roots, a quadrature and the non-parity modes on the
    # sharded state: bit for bit the unsharded run on every call, and
    # ida_tpu's sharded program's counters and root returns
    for rank in ranks:
        _same_calls(rank["food_modes"][case]["calls"], food_unsharded[case])
    calls = ranks[0]["food_modes"][case]["calls"]
    _jax_calls(calls, jax_food[case])
    if case == "roots":
        assert [int(c["istate"]) for c in calls] == [C.ROOT_RETURN, C.SUCCESS, C.SUCCESS]
        assert calls[-1]["counters"]["nge"] > 0
    if case == "quad":
        assert float(calls[-1]["yQ"][0]) > 0.0
