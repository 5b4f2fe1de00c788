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
