"""The PyTorch port stands alone: it imports with JAX unavailable and never
imports ``jax`` or ``ida_tpu`` (the machine with the GPU has no JAX)."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "ida_tpu_torch"

MODULES = [
    "ida_tpu_torch",
    "ida_tpu_torch.parallel",
    "ida_tpu_torch.ops",
    "ida_tpu_torch.ops.small_lu",
    "ida_tpu_torch.ops.fused_solve",
    "ida_tpu_torch.ops.fused_stages",
    "ida_tpu_torch.core.solve",
    "ida_tpu_torch.core.root",
    "ida_tpu_torch.solver",
    "ida_tpu_torch.api",
    "ida_tpu_torch.utils.trace",
    "ida_tpu_torch.models",
    "ida_tpu_torch.utils.convert",
    "ida_tpu_torch.ops.banded",
    "ida_tpu_torch.ops.bbd",
    "ida_tpu_torch.core.quad",
    "ida_tpu_torch.utils.checkpoint",
    "ida_tpu_torch.utils.ad_mode",
    "ida_tpu_torch.sensitivity",
    "ida_tpu_torch.utils.profiling",
    "ida_tpu_torch.models.lorenz63",
    "ida_tpu_torch.models.slider_crank",
]


@pytest.fixture(scope="module")
def imports_without_jax():
    """One interpreter where ``jax`` and ``ida_tpu`` cannot be imported (an
    import of either raises) imports every module in turn: per module, the
    error it raised or None, and which jax modules were loaded at the end."""
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None; sys.modules['ida_tpu'] = None\n"
        "out = {}\n"
        f"for m in {MODULES!r}:\n"
        "    try:\n"
        "        importlib.import_module(m); out[m] = None\n"
        "    except Exception as e:\n"
        "        out[m] = repr(e)\n"
        "out['jax loaded'] = [m for m, v in sys.modules.items() if v is not None\n"
        "                     and m.split('.')[0] in ('jax', 'ida_tpu')]\n"
        "out['loaded'] = sorted(m for m in sys.modules if m.startswith('ida_tpu_torch'))\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax(imports_without_jax, module):
    assert imports_without_jax[module] is None, imports_without_jax[module]
    assert imports_without_jax["jax loaded"] == []
    if module == "ida_tpu_torch.models":
        assert {"ida_tpu_torch.models.heat2d", "ida_tpu_torch.models.foodweb"} <= set(
            imports_without_jax["loaded"])


def test_importing_the_package_brings_the_user_surface():
    # importing the package pulls in the user surface and what it stands on,
    # the Krylov solver and consistent initial conditions included (and the
    # "ida_tpu_torch.models" case above imports heat2d and foodweb)
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ida_tpu'] = None\n"
        "import ida_tpu_torch\n"
        "need = ['solver', 'api', 'core.root', 'core.interp', 'utils.trace', 'core.calc_ic',\n"
        "        'ops.spgmr']\n"
        "missing = [m for m in need if 'ida_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_the_example_and_the_smoke_script_import_no_jax():
    for name in ("chip_smoke.py", "examples/roberts_torch.py", "examples/heat2d_torch.py",
                 "examples/foodweb_torch.py", "examples/bounce_torch.py",
                 "examples/slider_crank_torch.py", "examples/sensitivities_torch.py",
                 "examples/fit_kinetics_torch.py"):
        bad = [line for line in (ROOT / name).read_text().splitlines() if _FORBIDDEN.match(line)]
        assert not bad, (name, bad)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|ida_tpu)(\.|\s|$)")


def test_source_never_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py"))
    assert files
    bad = [
        f"{path.relative_to(ROOT)}:{i}: {line.strip()}"
        for path in files
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if _FORBIDDEN.match(line)
    ]
    assert not bad, bad


@pytest.mark.parametrize("package,home", [("core", "state"), ("utils", "tree")])
def test_subpackages_export_what_ida_tpus_export(package, home):
    # ida_tpu/<package>/__init__.py's __all__ (read from its source) is the
    # port's, each name the object its home module defines
    import ast
    import importlib

    tree = ast.parse((ROOT / "ida_tpu" / package / "__init__.py").read_text())
    want = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign) and node.targets[0].id == "__all__")
    mod = importlib.import_module(f"ida_tpu_torch.{package}")
    src = importlib.import_module(f"ida_tpu_torch.{package}.{home}")
    assert list(mod.__all__) == list(want)
    assert all(getattr(mod, name) is getattr(src, name) for name in want)


_NOT_PORTED = re.compile(r"not_ported\((?:[^()]|\([^()]*\))*?,\s*(\d+)\s*,", re.S)


def test_every_not_ported_raise_names_a_current_roadmap_item():
    # each raise of a feature still to port names the ROADMAP.md item that
    # lifts it: with the sharded-N solve finished, what is left is the direct
    # solvers on a state sharded over N (item 12) and, in the whole-solve
    # kernel under spgmr, a factory's own jtimes and a preconditioner (item 22)
    calls = {
        f"{path.relative_to(ROOT)}": [int(n) for n in _NOT_PORTED.findall(path.read_text())]
        for path in sorted(PKG.rglob("*.py"))
    }
    items = [n for found in calls.values() for n in found]
    assert sorted(set(items)) == [12, 22], calls
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for n in set(items):
        assert re.search(rf"^{n}\. \*\*", roadmap, re.M), f"ROADMAP.md has no item {n}"
