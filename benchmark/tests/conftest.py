"""Shared pieces of the benchmark's CPU tests: the repository root on
sys.path, the caches inside the checkout, and each configuration at a
size a test can hold (the 642-cell mesh)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import common  # noqa: E402

common.set_cache_env()

SMALL_COUNTS = {"cells": 642, "edges": 1920, "vertices": 1280,
                "max_edges": 6}


def small_params(config):
    """The configuration's numbers at the test size."""
    spec = common.load_spec()
    p = common.config_params(common.find(spec["configs"], config, "c"))
    p = dict(p, mesh={"n": 8, "lloyd_iters": 1}, counts=SMALL_COUNTS)
    if config == "jw_120km":
        return dict(p, dt_s=1200.0, len_disp_m=960000.0)
    return dict(p, layers=10, dataset={"nlat": 60, "nlon": 120, "ndep": 30})


def small_traffic(workload):
    spec = common.load_spec()
    cell = common.find(spec["workloads"], workload, "workload")
    t = common.traffic_params(cell["config"], cell["traffic"])
    if cell["config"] == "jw_120km":
        t = dict(t, levels=10)
    return dict(t, trace_steps=5)


@pytest.fixture(scope="session")
def spec():
    return common.load_spec()
