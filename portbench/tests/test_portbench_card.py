"""On the card: one short run of the first cell, correct."""

import json
import subprocess
import sys

import pytest

from portbench import cell


@pytest.mark.card
def test_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this run needs one")
    workload = cell.load_benchmark()["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", "77", "--seconds", "2",
                        "--trace", "0"], cwd=cell.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
