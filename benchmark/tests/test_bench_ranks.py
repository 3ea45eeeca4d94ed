"""The harness's path for a cell on P > 1 cards (benchmark/harness/ranks.py)
on the CPU: jw_120km over 2 gloo ranks on the 642-cell mesh in float64,
through the configuration's sharded branch, with rank_jw.py's check (the
configuration's numbers, and the gathered state against the one-rank run
and the port's loopback run of the same shards). The cell is the test's
own; BENCHMARK.json has none on more than one card yet."""

import json
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

import torch
import torch.distributed as dist

from benchmark.harness import common, ranks, stats, window

from .conftest import ROOT, small_params, small_traffic

CELL = "jw_120km.ranks"
CASE = str(ROOT / "benchmark" / "tests" / "rank_jw.py")
SPEC = common.load_spec()
SPEC["workloads"] = SPEC["workloads"] + [
    {"name": CELL, "config": "jw_120km", "traffic": "l26", "chips": 2,
     "why": "the rank path's test"}]
PARAMS = dict(small_params("jw_120km"), dtype="float64")
# float64 on the CPU: the ranks equal the loopback run of their shards
# bit for bit, and the one-rank run to one rounding that grows. At the
# end of the second step the exner of recover_large_step_variables,
# (...) ** RCV, differs by one ulp in the one-rank run's last element:
# PyTorch's CPU pow takes the tail of an array that fills no whole vector
# through std::pow and the rest through SLEEF's vector pow, and in the
# shards' layout that element lies in the vector body. w, small beside
# its rounding, then reads 1.2e-12 to 2.2e-12 of its largest value over
# the next steps (on the cards every element takes one pow: equal bit for
# bit, test_bench_cuda.py)
LIMITS = {"one_rank_start": 1e-11, "one_rank_post": 1e-11,
          "loopback_start": 0.0, "loopback_post": 0.0}


def traffic(**kw):
    t = small_traffic("jw_120km.l26")
    return dict(t, trace_steps=4, loopback_ranks=2,
                limits=dict(t["limits"], **LIMITS), **kw)


def run(trace, seed=5, **kw):
    return ranks.run_ranks(SPEC, CELL, seed, 0.5, trace, time.perf_counter(),
                           backend="gloo", params=PARAMS,
                           traffic=traffic(**kw), config_file=CASE,
                           group_timeout_s=60.0)


@pytest.fixture(scope="module")
def watched(tmp_path_factory):
    return tmp_path_factory.mktemp("watch")


@pytest.fixture(scope="module")
def timed(watched):
    return run(0, watch=str(watched))


@pytest.fixture(scope="module")
def traced():
    return run(1, seed=6, fault={"rank": 1, "at": "finite"})


def test_the_ranks_agree_on_the_steps_and_the_sampled_step(timed):
    result, numbers = timed
    assert len(numbers) == 2
    assert [n["steps"] for n in numbers] == [result["attempted"]] * 2
    assert all(len(n["step_ms"]) == result["attempted"] for n in numbers)
    assert numbers[0]["sample_at"] == numbers[1]["sample_at"] \
        >= numbers[0]["start_at"]


def test_a_step_takes_its_slowest_rank(timed):
    result, numbers = timed
    worst = [max(a, b) for a, b in zip(numbers[0]["step_ms"],
                                        numbers[1]["step_ms"])]
    assert result["metrics"]["step_p90_ms"]["value"] \
        == stats.percentile(worst, 90.0)
    assert set(result["metrics"]) == {"sim_days_per_day", "step_p90_ms",
                                      "setup_s"}


def test_memory_is_the_fullest_rank(timed):
    result, numbers = timed
    dev = result["device"]
    assert dev["memory_peak_bytes_by_rank"] == [n["memory"] for n in numbers]
    assert dev["memory_peak_bytes"] == max(n["memory"] for n in numbers) > 0
    assert dev["count"] == 2 and list(result)[-1] == "checks"


def test_the_gathered_state_is_the_one_rank_run(timed):
    result, _ = timed
    checks = result["checks"]
    assert checks["loopback_start"]["value"] == 0.0
    assert checks["loopback_post"]["value"] == 0.0
    assert checks["one_rank_start"]["value"] <= 1e-11
    assert checks["one_rank_post"]["value"] <= 1e-11
    assert result["correct"], checks


def test_the_window_holds_no_collective_and_no_copy_to_the_host(timed,
                                                                watched):
    """Between the two barriers that open and close the timed window, no
    rank calls a collective, waits for its card or copies a tensor to the
    host outside its steps; the snapshots reach rank 0 after the close."""
    for r in range(2):
        log = (watched / f"rank{r}.log").read_text().split()
        opened = log.index("barrier")
        closed = log.index("barrier", opened + 1)
        assert log[opened + 1:closed] == [], log
        assert log[closed + 1:].count("gather_object") == 3, log


def test_finite_holds_where_every_rank_holds_it(traced):
    result, numbers = traced
    assert [n["finite"] for n in numbers] == [True, False]
    assert result["failed"] == result["attempted"] == 4
    assert checks_value(result, "final_state_finite") == 0
    assert not result["correct"]


def checks_value(result, name):
    return result["checks"][name]["value"]


def test_each_rank_traces_the_same_steps(traced):
    result, numbers = traced
    for r in range(2):
        assert ranks.trace_path(r).exists()
    dev = result["device"]
    assert dev["trace_rank"] == 0 and dev["window_s"] > 0
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert numbers[0]["sample_at"] == numbers[1]["sample_at"]
    assert checks_value(result, "loopback_post") == 0.0


def test_combine():
    base = {"steps": 3, "start_at": 4, "sample_at": 5, "memory": 10,
            "finite": True}
    a = dict(base, step_ms=[1.0, 5.0, 2.0])
    b = dict(base, step_ms=[3.0, 4.0, 2.5], memory=30, finite=False)
    run = ranks.combine([a, b])
    assert run["step_ms"] == [3.0, 5.0, 2.5]
    assert run["memory_peak_bytes"] == 30
    assert run["memory_peak_bytes_by_rank"] == [10, 30]
    assert not run["finite"] and ranks.combine([a, a])["finite"]
    for key in ("steps", "start_at", "sample_at"):
        with pytest.raises(ranks.RankFailure):
            ranks.combine([a, dict(b, **{key: 7})])
    assert ranks.pacing_rank([0.1, 0.3, 0.3, 0.2]) == 1


@pytest.mark.parametrize("fault", [{"rank": 1, "at": "build"},
                                   {"rank": 1, "at": "step", "step": 3}],
                         ids=["build", "third_step"])
def test_a_failing_rank_ends_the_run(fault, capsys):
    args = SimpleNamespace(workload=CELL, seed=9, seconds=2.0, trace=0)
    t0 = time.perf_counter()
    rc = ranks.main(SPEC, args, t0, backend="gloo", params=PARAMS,
                    traffic=traffic(fault=fault), config_file=CASE,
                    group_timeout_s=60.0)
    assert rc != 0
    assert time.perf_counter() - t0 < 60.0
    assert "{" not in capsys.readouterr().out


ONE_CARD = """
import json, sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.harness import common
from benchmark.tests.conftest import small_params, small_traffic
spec = common.load_spec()
for trace in (0, 1):
    r = run.run_cell(spec, "jw_120km.l26", 3, 0.5, trace, torch.device("cpu"),
                     small_params("jw_120km"),
                     dict(small_traffic("jw_120km.l26"), trace_steps=4))
    print(json.dumps([list(r), list(r["device"])]))
print(json.dumps("benchmark.harness.ranks" in sys.modules))
"""


def test_one_card_keeps_the_result_s_keys():
    """A cell on one card runs none of the rank path, and its result has
    the keys it had before the rank path came."""
    out = subprocess.run([sys.executable, "-c", ONE_CARD.format(
        root=str(ROOT))], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    timed, traced, loaded = map(json.loads, out.stdout.splitlines()[-3:])
    assert timed == [["correct", "attempted", "failed", "metrics", "device",
                      "checks"],
                     ["platform", "kind", "count", "memory_peak_bytes"]]
    assert traced == [["correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "checks"],
                      ["platform", "kind", "count", "memory_peak_bytes",
                       "busy_s", "window_s"]]
    assert loaded is False


class _Clock:
    """A host clock that moves only when a step is taken."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Steps:
    """A case whose step takes `dt` seconds of the clock; a snapshot is
    the number of steps taken."""

    device = torch.device("cpu")
    k2_sites = ()

    def __init__(self, clock, dt):
        self.clock, self.dt, self.steps_done = clock, dt, 0

    def step(self):
        self.clock.t += self.dt
        self.steps_done += 1

    def checkable(self):
        return True

    def snapshot(self):
        return self.steps_done


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dt", [0.013, 0.25, 0.6],
                         ids=["many_steps", "few_steps", "sample_after"])
def test_the_rank_windows_sample_as_the_one_card_windows(dt, one_rank_group,
                                                         monkeypatch,
                                                         tmp_path):
    """ranks.timed_window and traced_window are the one-card windows in
    lockstep: on the same seed and the same step times they take the same
    steps and the same third and sampled steps, inside the window or
    after it."""
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    lead = ranks._Lead([])
    for seed in random.Random(dt).sample(range(2 ** 40), 4):
        clock.t = 0.0
        n, _, ms, rec = window.timed_window(_Steps(clock, dt), 1.0, seed)
        clock.t = 0.0
        got = ranks.timed_window(_Steps(clock, dt), 1.0, seed, lead,
                                 one_rank_group, 0.0)
        assert (got[0], got[2]) == (n, ms)
        assert (got[3].start_at, got[3].sample_at, got[3].pre,
                got[3].post) == (rec.start_at, rec.sample_at, rec.pre,
                                 rec.post)
        steps = 4 + int(2.0 / dt) % 7
        rec = window.traced_window(_Steps(clock, dt), steps, seed, [],
                                   tmp_path / "one.json")
        got = ranks.traced_window(_Steps(clock, dt), steps, seed, [],
                                  tmp_path / "ranks.json", lead,
                                  one_rank_group)
        assert (got.start_at, got.sample_at) == (rec.start_at,
                                                 rec.sample_at)
