"""On the card only: one short run of each cell through the command, its
last line to the contract (`python -m pytest -m cuda h100_bench/tests`)."""

import json
import os
import subprocess
import sys

import pytest

from h100_bench import run


def _cells():
    return [w["name"] for w in run.load_json(
        os.path.join(run.ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_a_short_run_of_each_cell(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "h100_bench", "--workload", cell, "--seed",
         str(2**31 + 12345), "--seconds", "5"], cwd=run.ROOT, text=True,
        capture_output=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "check"
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"]
