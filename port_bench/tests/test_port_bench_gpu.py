"""The benchmark on the card, at the cells' own sizes: a short run of each
cell is correct, and the control (the reference one precision below,
reference/models.py::CONTROL_TF32) is not, on three seeds. They skip
without a CUDA device; on a machine with one:

    python3 -m pytest -m gpu port_bench/tests -q
"""

import json
import subprocess
import sys

import pytest

from port_bench import control
from port_bench.run import Cell
from port_bench.tests.conftest import ROOT, spec

pytestmark = pytest.mark.gpu
WORKLOADS = [w["name"] for w in spec()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_is_correct(workload, cuda):
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench", "--workload", workload,
         "--seed", str(2**31 + 101), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct_at_the_cells_size(workload, cuda):
    cell = Cell(spec(), workload, ROOT)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = control.control_gap(cell, seed, cuda)
        assert out["score_gap"] > out["limit"], (seed, out)
