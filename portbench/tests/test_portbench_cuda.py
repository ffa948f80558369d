"""On the card (``pytest -m cuda portbench``): one short run of every
cell through the command, and the control at each cell's own size.
Without a card these skip."""
import json
import subprocess
import sys

import pytest

from portbench import control, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_the_cell_is_correct(cell, cuda_device):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "3000000021", "--seconds", "1",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_the_cell_s_size_is_not_correct(cell, cuda_device):
    ok, bad, checks = control.control_reading(cell, 4000000021, cuda_device)
    assert not ok and bad > 0
