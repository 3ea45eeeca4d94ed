"""Discovery by name, BENCHMARK.json against the contract's shape, and the
arithmetic of the end-to-end metrics."""

import json
import re

import pytest

from benchmark.harness import common, stats

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_resolves_to_its_files(spec):
    for c in spec["configs"]:
        params = common.config_params(c)
        assert params["name"] == c["name"]
        mod = common.config_module(c["name"])
        for fn in ("build", "check", "bytes_per_step", "host_init",
                   "program_impl", "reference_impl"):
            assert callable(getattr(mod, fn)), (c["name"], fn)
    for w in spec["workloads"]:
        t = common.traffic_params(w["config"], w["traffic"])
        assert "limits" in t and "warm_steps" in t and "trace_steps" in t
    for m in spec["per_layer"]:
        mod = common.metric_module(m["name"])
        assert callable(mod.read)
        assert all(len(s) == 3 for s in mod.SPANS)


def test_benchmark_json_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in spec["configs"]}
    cells = {w["name"] for w in spec["workloads"]}
    assert configs == {w["config"] for w in spec["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) \
        == len(spec["workloads"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert UNIT.match(m["unit"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        reported = [m for m in spec["per_layer"]
                    if w["name"] in m["workloads"]]
        assert reported and any(m["name"] == "step_mfu" for m in reported)
    assert len(json.dumps(spec)) < 64 * 1024


def test_percentile_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 90.0) == 90
    assert stats.percentile([5.0], 90.0) == 5.0
    assert stats.percentile([3.0, 1.0, 2.0], 50.0) == 2.0
    with pytest.raises(ValueError):
        stats.percentile([], 90.0)


def test_sim_days_per_day():
    # 120 steps of 720 s in 10 s of wall time: 8,640 s a second
    assert stats.sim_days_per_day(120, 720.0, 10.0) == pytest.approx(8640.0)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (10.0, 11.0)]
    assert stats.union_seconds(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert stats.union_seconds(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.union_seconds([], 0.0, 1.0) == 0.0


def test_verdict():
    from benchmark.run import verdict
    ok, checks = verdict({"a": 1e-6, "b": 2.0}, {"a": 1e-5}, True)
    assert ok and list(checks) == ["a", "final_state_finite"]
    assert not verdict({"a": 2e-5}, {"a": 1e-5}, True)[0]
    assert not verdict({"a": 1e-6}, {"a": 1e-5}, False)[0]
    ok, checks = verdict({"a": float("nan")}, {"a": 1e-5, "c": 1.0}, True)
    assert not ok and checks["a"]["value"] is None
    assert checks["c"]["value"] is None
