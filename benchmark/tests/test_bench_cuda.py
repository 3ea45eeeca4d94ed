"""On the card: each cell's command, as the check runs it, with a short
window; its last line is a correct result. And jw_120km over min(4, cards)
ranks, one a card, through the harness's rank path: correct; its gathered
float32 state the one-card run's from the same initial carry bit for bit,
and the port's loopback run's; and no rank waits, copies to the host or
calls a collective in the window but for its steps and the wait for the
last. Skips without a card (the ranks: without two).

    python -m pytest -o addopts="" -m cuda benchmark/tests/test_bench_cuda.py
"""

import json
import subprocess
import sys
import time

import pytest

from benchmark.harness import common, ranks

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


@pytest.mark.cuda
def test_jw_over_the_ranks_is_the_one_card_run(card, tmp_path):
    import torch
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two cards: NCCL takes one rank a card")
    cell = f"jw_120km.ranks{n}"
    spec = common.load_spec()
    spec["workloads"] = spec["workloads"] + [
        {"name": cell, "config": "jw_120km", "traffic": "l26", "chips": n,
         "why": "the rank path's test"}]
    traffic = common.traffic_params("jw_120km", "l26")
    # the shards start from a carry made on the host: the one-card run
    # from that carry and the loopback run are equal bit for bit; the
    # one-card run with its init on the card departs by float32 rounding,
    # which w, small beside it, reads as 1.3e-3 / 5.0e-3 of its largest
    # value at the third / sampled step (4 x H100; on the CPU a carry made
    # in float64 moves w as far and the other fields under 3e-6); a carry
    # cut or gathered wrongly reads O(1)
    traffic = dict(traffic, loopback_ranks=n, card_init=True,
                   watch=str(tmp_path), limits=dict(
                       traffic["limits"], one_rank_start=0.0,
                       one_rank_post=0.0, loopback_start=0.0,
                       loopback_post=0.0, card_init_start=0.05,
                       card_init_post=0.05))
    result, numbers = ranks.run_ranks(
        spec, cell, 2147483661, 3.0, 0, time.perf_counter(),
        traffic=traffic, config_file=ROOT / "benchmark" / "tests"
        / "rank_jw.py")
    print(json.dumps(result))
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == n == len(numbers)
    for r in range(n):
        log = (tmp_path / f"rank{r}.log").read_text().split()
        opened = log.index("barrier")
        closed = log.index("barrier", opened + 1)
        # the one wait of the window: for the card's last step
        assert log[opened + 1:closed] == ["synchronize"], log
