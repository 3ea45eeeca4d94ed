"""The trace reduction and every per-layer metric's reader on a synthetic
trace whose answers are known, and step_mfu's count as a lower bound."""

from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.harness import common
from benchmark.harness.peaks import HBM_BYTES_PER_S, k1_bytes, k2_bytes
from benchmark.harness.trace import Trace

from .conftest import small_params, small_traffic

US = 1e-6
K1 = "k1:40962x26:4"
K2_BIG = "k2:40962x6x6x52:4"        # 108 MB: in the share
K2_L2 = "k2:40962x3x6x26:4"         # 41 MB: fits the L2, left out


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def synthetic(k1_share=0.5, k2_share=0.8):
    """A window of 1,000 us: two steps, a dyn_tend span holding a K1
    launch, a K2 launch of each kind, a plain kernel and a copy."""
    b1 = 1e6 * k1_bytes(40962, 26, 4) / HBM_BYTES_PER_S        # us
    b2 = 1e6 * k2_bytes(40962, 6, 6, 52, 4) / HBM_BYTES_PER_S
    b3 = 1e6 * k2_bytes(40962, 3, 6, 26, 4) / HBM_BYTES_PER_S
    ev = [_x("user_annotation", "bench_window", 0.0, 1000.0),
          _x("user_annotation", "step", 0.0, 500.0),
          _x("user_annotation", "step", 500.0, 500.0),
          _x("user_annotation", "compute_dyn_tend", 100.0, 100.0),
          _x("user_annotation", K1, 150.0, 10.0),
          _x("user_annotation", K2_BIG, 300.0, 10.0),
          _x("user_annotation", K2_L2, 320.0, 10.0)]
    launches = {1: 155.0, 2: 305.0, 3: 325.0, 4: 120.0, 5: 600.0}
    ev += [_x("cuda_runtime", "cudaLaunchKernel", t, 2.0, correlation=c)
           for c, t in launches.items()]
    ev += [_x("kernel", "k1", 170.0, b1 / k1_share, correlation=1),
           _x("kernel", "k2", 400.0, b2 / k2_share, correlation=2),
           _x("kernel", "k2", 500.0, b3 / 10.0, correlation=3),
           _x("kernel", "other", 130.0, 20.0, correlation=4),
           _x("kernel", "late", 700.0, 50.0, correlation=5),
           _x("gpu_memcpy", "Memcpy DtoD", 900.0, 10.0, correlation=6),
           _x("kernel", "outside", 2000.0, 5.0, correlation=7)]
    return Trace(ev), (b1, b2, b3)


def ctx(trace, steps=2, bytes_per_step=0.0):
    return SimpleNamespace(trace=trace, steps=steps, params={}, traffic={},
                           bytes_per_step=bytes_per_step)


def read(name, c):
    return common.metric_module(name).read(c)


def test_trace_reduction():
    tr, (b1, b2, b3) = synthetic()
    assert tr.window_s == pytest.approx(1000 * US)
    assert tr.kernel_count() == 5            # the copy and the late one out
    busy = (b1 / 0.5 + b2 / 0.8 + b3 / 10 + 20 + 50 + 10) * US
    assert tr.busy_s() == pytest.approx(busy)
    # kernels launched inside the span: "other" (20 us) and K1
    assert tr.device_s_in("compute_dyn_tend") == pytest.approx(
        (20 + b1 / 0.5) * US)
    by = tr.device_s_by_span("k2:")
    assert by[K2_BIG][0] == 1 and by[K2_L2][0] == 1
    bd = tr.breakdown()
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(
        tr.window_s - tr.busy_s())
    with pytest.raises(ValueError):     # a trace without its window
        Trace([_x("kernel", "k", 0.0, 1.0, correlation=1)])


def test_readers_on_the_synthetic_trace():
    tr, _ = synthetic()
    c = ctx(tr)
    assert read("launches_per_step", c) == pytest.approx(2.5)
    assert read("device_idle_pct", c) == pytest.approx(
        100 * (1 - tr.busy_s() / tr.window_s))
    assert read("dyn_tend_ms_per_step", c) == pytest.approx(
        1e3 * tr.device_s_in("compute_dyn_tend") / 2)
    assert read("k1_roofline_pct", c) == pytest.approx(50.0)
    # the L2-resident K2 launch, at 1,000% of its bound, is left out
    assert read("k2_roofline_pct", c) == pytest.approx(80.0)
    # a span the trace lacks gives nothing, not 0
    assert read("ocean_dyn_ms_per_step", c) is None
    assert read("analysis_ms_per_step", c) is None


def test_roofline_of_nothing_is_nothing():
    tr = Trace([_x("user_annotation", "bench_window", 0.0, 10.0)])
    assert read("k1_roofline_pct", ctx(tr)) is None
    assert read("k2_roofline_pct", ctx(tr)) is None


def test_step_mfu_reading():
    tr, _ = synthetic()
    # a step of 500 us that the bound says could take 250 us: 50%
    nbytes = 250 * US * HBM_BYTES_PER_S
    assert read("step_mfu", ctx(tr, 2, nbytes)) == pytest.approx(50.0)


class _Bytes(TorchDispatchMode):
    """Bytes every aten op of the eager program reads and writes."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = list(args) + list((kwargs or {}).values()) + (
            list(out) if isinstance(out, (tuple, list)) else [out])
        for t in flat:
            if isinstance(t, torch.Tensor):
                self.total += t.numel() * t.element_size()
        return out


@pytest.mark.parametrize("workload", ["jw_120km.l26",
                                      "ocean_global_120km.analysis"])
def test_step_mfu_count_is_a_lower_bound(workload):
    """bytes_per_step, counted from shapes and stage counts, stays under
    the bytes the port's ops read and write in one step on the CPU at
    the test size."""
    spec = common.load_spec()
    cell = common.find(spec["workloads"], workload, "w")
    mod = common.config_module(cell["config"])
    params, traffic = small_params(cell["config"]), small_traffic(workload)
    if cell["config"] == "ocean_global_120km":
        params = dict(params, particles=dict(params["particles"],
                                             ocean_cells=600))
    case = mod.build(params, traffic, 5, torch.device("cpu"))
    with _Bytes() as counted:
        case.step()
    assert 0 < mod.bytes_per_step(params, traffic) < counted.total


def test_full_size_counts():
    """The full-size count of jw_120km.l26, worked out by hand: 9
    dynamics passes of (2 x 6,430,878 state + 1,065,012 zz) f32 values
    and 491,532 4-byte indices, 3 transport passes of 2 x 1,065,012."""
    spec = common.load_spec()
    mod = common.config_module("jw_120km")
    params = common.config_params(common.find(spec["configs"], "jw_120km",
                                              "c"))
    traffic = common.traffic_params("jw_120km", "l26")
    dyn = 4 * (2 * 6430878 + 1065012) + 4 * 491532
    assert mod.bytes_per_step(params, traffic) == 9 * dyn + 3 * 8 * 1065012
