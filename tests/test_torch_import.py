"""The PyTorch port stands alone: it imports with JAX unavailable and never
imports ``jax`` or ``ida_tpu`` (the machine with the GPU has no JAX)."""

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
]


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax(module):
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ida_tpu'] = None\n"
        f"import importlib; importlib.import_module({module!r})\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m] is not None]\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_importing_the_package_brings_the_user_surface():
    # importing the package pulls in the user surface and what it stands on
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ida_tpu'] = None\n"
        "import ida_tpu_torch\n"
        "need = ['solver', 'api', 'core.root', 'core.interp', 'utils.trace']\n"
        "missing = [m for m in need if 'ida_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_the_example_and_the_smoke_script_import_no_jax():
    for name in ("chip_smoke.py", "examples/roberts_torch.py"):
        bad = [line for line in (ROOT / name).read_text().splitlines() if _FORBIDDEN.match(line)]
        assert not bad, (name, bad)


def test_the_example_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "examples/roberts_torch.py", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=300, env={**__import__("os").environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert out.count("<- root") == 2 and "roots found: [0, 1]" in out and "roots found: [-1, 0]" in out
    assert "Number of steps                        362" in out
    assert "Number of root fn. evaluations         404" in out and "(PASS)" in out


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
