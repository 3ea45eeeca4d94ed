"""The control of each cell, at the test size on the CPU: the plain
reference put in the program's place in float32 with its K2
contractions in TF32 (the nearest precision below the configurations'
float32 for a contraction) fails at least one compared number under the
cell's limits. The limits were set from the same readings at full size
on the card (PERF.md)."""

import pytest
import torch

from benchmark.harness import common, window
from benchmark.run import verdict

from .conftest import small_params, small_traffic

CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      common.load_spec()["workloads"]])
def test_the_control_is_not_correct(workload):
    spec = common.load_spec()
    cell = common.find(spec["workloads"], workload, "w")
    mod = common.config_module(cell["config"])
    params = small_params(cell["config"])
    traffic = small_traffic(workload)
    case = mod.build(params, traffic, 23, CPU, control=True)
    _, _, _, rec = window.timed_window(case, 0.5, 23)
    finite, inputs = case.finite(), case.inputs
    case.release()
    values = mod.check(params, traffic, inputs, rec, CPU)
    correct, checks = verdict(values, traffic["limits"], finite)
    assert finite and not correct, checks
