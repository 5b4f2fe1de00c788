"""The Krylov example runs on the CPU (``tests/test_torch_examples.py``
has the setting; a file of its own, so that the slow test runs at the end
of the suite's queue).
"""

import subprocess
import sys

import torch

from test_torch_examples import ROOT

# one intra-op thread: the tests' tensors are small, and the suite runs in
# parallel workers, each of which would otherwise start a pool per core
torch.set_num_threads(1)


def test_the_krylov_example_runs_on_the_cpu():
    # foodweb at a 4 x 4 grid: calc_ic, then SPGMR with the block-diagonal
    # preconditioner over eight output times
    proc = subprocess.run(
        [sys.executable, "examples/foodweb_torch.py", "--device", "cpu", "--grid", "4"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr
    rows = [line.split() for line in proc.stdout.splitlines() if line[:10].strip().startswith("0.")]
    assert len(rows) == 8 and rows[-1][0] == "0.1280"
    assert "Jacobian evaluations = 0" in proc.stdout
