"""One short run of every cell on the card (`python -m pytest
port_bench/tests -m cuda`); skips where there is no card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench.harness import registry


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         "3141592653", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=registry.ROOT,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line
    assert line["device"]["platform"] == "gpu"
