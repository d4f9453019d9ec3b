"""The benchmark's command: refused without a card, and (marked ``cuda``)
a short run of each cell on one."""
import json
import subprocess
import sys

import pytest
from conftest import ROOT

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _command(cell, seed, seconds):
    return [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", cell, "--seed",
            str(seed), "--seconds", str(seconds), "--trace", "0"]


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(_command(CELLS[0], 1, 1), capture_output=True, text=True, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(_command(cell, 2**31 + 3, 2), capture_output=True, text=True,
                         cwd=ROOT, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
