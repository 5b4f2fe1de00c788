"""The examples of the port run on the CPU: idaRoberts_dns's table here, the
Krylov example in ``test_torch_examples_krylov.py`` (split from
tests/test_torch_import.py; files of one test queue last).
"""

import subprocess
import sys

from test_torch_import import ROOT


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
