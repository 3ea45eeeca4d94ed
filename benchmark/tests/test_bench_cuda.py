"""On the card: each cell's command, as the check runs it, with a short
window; its last line is a correct result. Skips without a card.

    python -m pytest -o addopts="" -m cuda benchmark/tests/test_bench_cuda.py
"""

import json
import subprocess
import sys

import pytest

from benchmark.harness import common

from .conftest import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      common.load_spec()["workloads"]])
def test_a_short_run_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
