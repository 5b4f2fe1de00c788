"""``ida_tpu`` references of the port's tests, pinned as fixtures.

Some tests of ``ida_tpu_torch`` hold it to results of the frozen JAX
package that take tens of seconds to compute on every run: jitted adjoints
(a compile of about a minute) and solves run op by op (about half a second
a step attempt). Each such reference is computed by a function of its own
test module (``REFS``: name -> (module, function, inputs)) and stored here,
under ``tests/fixtures/torch_refs/<name>.npz``, with every array's bits and
the module's inputs of that reference (a dict of its constants: parameters,
tolerances, tout, ...); the test reads it back with :func:`load`, which
checks that those inputs are still the module's, rebuilds the same
structure (dicts, tuples, lists, ``ida_tpu`` states, numpy arrays and Python
numbers), and asserts what it asserted on the live result.

Regenerate after a change to ``ida_tpu`` or to a reference function (from
the repository root; all, or the names given):

    python tests/make_torch_refs.py [name ...]
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_refs"

# name -> (test module, the function of it that computes the reference, the
# module's dict of the inputs it computes it from)
REFS = {
    "adjoint": ("test_torch_adjoint", "jax_ref_live", "REF_INPUTS"),
    "adjoint_batched": ("test_torch_adjoint_batched", "jax_batched_live", "REF_INPUTS"),
    "continuous_adjoint": ("test_torch_continuous_adjoint", "jax_continuous_live", "REF_INPUTS"),
    "budgeted_one_lane": ("test_torch_budgeted_solve", "one_lane_op_by_op_live", "REF_INPUTS"),
    "roots_first_root": ("test_torch_roots", "first_root_op_by_op_live", "REF_INPUTS"),
    "slice_op_by_op": ("test_torch_slice", "jax_op_by_op_live", "REF_INPUTS"),
    "mixed_roberts12_jax": ("test_torch_mixed_precision", "jax_roberts12_live", "REF_INPUTS"),
    "mixed_modes_op_by_op": ("test_torch_mixed_precision", "jax_modes_op_by_op_live",
                             "OBO_REF_INPUTS"),
    "mixed_heat2d_jax": ("test_torch_mixed_precision", "jax_heat_live", "HEAT_REF_INPUTS"),
    "mixed_forward_refined_jax": ("test_torch_mixed_precision", "jax_forward_refined_live",
                                  "FWD_REF_INPUTS"),
    "fused_modes_op_by_op": ("test_torch_fused_modes", "jax_modes_op_by_op_live", "REF_INPUTS"),
    "mesh_dp_op_by_op": ("test_torch_mesh", "jax_dp_op_by_op_live", "REF_INPUTS"),
    "mesh_sharded_programs": ("test_torch_mesh", "jax_sharded_live", "REF_INPUTS"),
    "mesh_foodweb_programs": ("test_torch_mesh", "jax_food_live", "FOOD_REF_INPUTS"),
    "fused_models_jax": ("test_torch_fused_models", "jax_fused_models_live", "REF_INPUTS"),
    "fused_quad_jax": ("test_torch_fused_quad", "fused_quad_jax_live", "REF_INPUTS"),
    "krylov_path_jax": ("test_torch_krylov_path", "jax_krylov_live", "REF_INPUTS"),
    "banded_jax": ("test_torch_banded", "jax_banded_live", "REF_INPUTS"),
    "dense_output_jax": ("test_torch_dense_output", "jax_dense_live", "REF_INPUTS"),
    "sensitivity_jax": ("test_torch_sensitivity", "jax_sensitivity_live", "REF_INPUTS"),
    "fused_solve_jax": ("test_torch_fused_solve", "jax_fused_solve_live", "REF_INPUTS"),
    "fused_linear_jax": ("test_torch_fused_linear", "fused_linear_jax_live", "REF_INPUTS"),
}


def _canon(x):
    """``x`` as plain JSON values: arrays and sequences as nested lists of
    Python numbers (exact: JSON keeps a float's shortest repr), dataclasses
    (options) as dicts."""
    if dataclasses.is_dataclass(x):
        return _canon(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, (str, bool, int, float)) or x is None:
        return x
    return np.asarray(x).tolist()


def _inputs_json(inputs: dict) -> str:
    return json.dumps(_canon(inputs), sort_keys=True)


def _encode(obj, path: str, arrays: dict):
    """The JSON skeleton of ``obj``; its arrays go into ``arrays``."""
    if isinstance(obj, dict):
        return {"dict": [[k, _encode(v, f"{path}/{i}", arrays)]
                         for i, (k, v) in enumerate(obj.items())]}
    if hasattr(obj, "_fields"):  # a NamedTuple (an ida_tpu state)
        cls = type(obj)
        return {"named": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f: _encode(getattr(obj, f), f"{path}/{f}", arrays)
                           for f in obj._fields}}
    if isinstance(obj, (tuple, list)):
        return {"tuple" if isinstance(obj, tuple) else "list":
                [_encode(v, f"{path}/{i}", arrays) for i, v in enumerate(obj)]}
    if obj is None:
        return {"none": True}
    if isinstance(obj, (bool, int, float)):
        return {"py": type(obj).__name__, "value": obj}
    arrays[path] = np.asarray(obj)
    return {"array": path}


def _decode(node: dict, arrays):
    if "dict" in node:
        return {k: _decode(v, arrays) for k, v in node["dict"]}
    if "named" in node:
        module, name = node["named"].split(":")
        cls = getattr(importlib.import_module(module), name)
        return cls(**{f: _decode(v, arrays) for f, v in node["fields"].items()})
    if "tuple" in node:
        return tuple(_decode(v, arrays) for v in node["tuple"])
    if "list" in node:
        return [_decode(v, arrays) for v in node["list"]]
    if "none" in node:
        return None
    if "py" in node:
        return {"bool": bool, "int": int, "float": float}[node["py"]](node["value"])
    return arrays[node["array"]]


def save(name: str, obj, inputs: dict) -> Path:
    arrays: dict = {}
    tree = _encode(obj, "", arrays)
    FIXTURES.mkdir(parents=True, exist_ok=True)
    path = FIXTURES / f"{name}.npz"
    np.savez_compressed(path, __tree__=np.array(json.dumps(tree)),
                        __inputs__=np.array(_inputs_json(inputs)), **arrays)
    return path


def load(name: str, inputs: dict):
    """The pinned reference ``name`` (see ``REFS``), as its function
    returned it; raises unless it was made from ``inputs``, the module's
    inputs of it now."""
    with np.load(FIXTURES / f"{name}.npz") as data:
        arrays = {k: data[k] for k in data.files}
    pinned = json.loads(str(arrays.pop("__inputs__")))
    if pinned != json.loads(_inputs_json(inputs)):
        raise AssertionError(
            f"the pinned reference {name!r} was made from other inputs than the test's: "
            f"pinned {pinned}, now {_canon(inputs)}; regenerate it with "
            f"python tests/make_torch_refs.py {name}")
    return _decode(json.loads(str(arrays.pop("__tree__"))), arrays)


def generate(name: str) -> Path:
    module, fn, inputs = REFS[name]
    mod = importlib.import_module(module)
    return save(name, getattr(mod, fn)(), getattr(mod, inputs))


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent)]
    import conftest  # noqa: F401  (JAX on the CPU, x64, as the tests run it)

    for name in sys.argv[1:] or REFS:
        print(name, generate(name), flush=True)
