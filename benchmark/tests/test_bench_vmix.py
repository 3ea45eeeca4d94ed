"""The readers of the ocean's vertical-mix solve (K3) on a synthetic trace
whose answers are known: its launches per step inside the program's
ocn.vmix_solve spans, and K3's share of its byte bound; and that the
program opens that span and no span the benchmark's k3: labels take."""

import pytest

from benchmark.harness import common
from benchmark.harness.peaks import HBM_BYTES_PER_S
from benchmark.harness.trace import WINDOW_SPAN, Trace

from .test_bench_metrics import _x, ctx, read
from .test_bench_program_spans import program_span_names

TRACERS = "k3:40962x60x12:4"        # 265 MB: in the share
VELOCITY = "k3:122880x60x1:4"       # 147 MB: in the share
SMALL = "k3:6336x20x2:4"            # 3.5 MB: fits the L2, left out


def k3_bytes(*shape):
    return common.metric_module("k3_roofline_pct").k3_bytes(*shape)


def bound_us(label):
    shape, itemsize = label[3:].split(":")
    n, nz, ntr = (int(v) for v in shape.split("x"))
    return 1e6 * k3_bytes(n, nz, ntr, int(itemsize)) / HBM_BYTES_PER_S


def synthetic(program_spans=True):
    """Two steps in a window of 2,000 us; each step's ocn.vmix_solve span
    holds a K3 launch of each solve (the tracers at 60% of their bound,
    the velocity at 40%) and the first step's a small one at 1,000%; one
    kernel outside the span."""
    t, v, s = bound_us(TRACERS), bound_us(VELOCITY), bound_us(SMALL)
    ev = [_x("user_annotation", WINDOW_SPAN, 0.0, 2000.0),
          _x("user_annotation", "step", 0.0, 1000.0),
          _x("user_annotation", "step", 1000.0, 1000.0)]
    launches = {}
    for i, t0 in enumerate((0.0, 1000.0)):
        if program_spans:
            ev.append(_x("user_annotation", "ocn.vmix_solve", t0 + 100.0,
                         50.0))
        ev += [_x("user_annotation", TRACERS, t0 + 110.0, 10.0),
               _x("user_annotation", VELOCITY, t0 + 130.0, 10.0)]
        launches[10 * i + 1] = t0 + 112.0
        launches[10 * i + 2] = t0 + 132.0
        ev += [_x("kernel", "vmix_kernel", t0 + 200.0, t / 0.6,
                  correlation=10 * i + 1),
               _x("kernel", "vmix_kernel", t0 + 500.0, v / 0.4,
                  correlation=10 * i + 2)]
    ev += [_x("user_annotation", SMALL, 141.0, 5.0),
           _x("kernel", "vmix_kernel", 800.0, s / 10.0, correlation=99)]
    launches[99] = 142.0
    launches[98] = 1500.0
    ev.append(_x("kernel", "outside", 1600.0, 20.0, correlation=98))
    ev += [_x("cuda_runtime", "cudaLaunchKernel", at, 2.0, correlation=c)
           for c, at in launches.items()]
    return Trace(ev)


def test_vmix_readers_on_a_synthetic_trace():
    c = ctx(synthetic(), steps=2)
    # the small launch sits inside the first span too: 5 kernels, 2 steps
    assert read("vmix_solve_launches_per_step", c) == 2.5
    t, v = bound_us(TRACERS), bound_us(VELOCITY)
    share = 100.0 * (t + v) / (t / 0.6 + v / 0.4)
    assert read("k3_roofline_pct", c) == pytest.approx(share)
    assert 40.0 < share < 60.0


def test_vmix_readers_without_the_programs_spans():
    # an older program: no ocn.vmix_solve span, no k3: label
    c = ctx(synthetic(program_spans=False), steps=2)
    assert read("vmix_solve_launches_per_step", c) is None
    bare = Trace([_x("user_annotation", WINDOW_SPAN, 0.0, 10.0)])
    assert read("k3_roofline_pct", ctx(bare)) is None


def test_k3_bytes_fit_the_l2_rule():
    assert k3_bytes(40962, 60, 12, 4) == 4 * 40962 * 1619
    assert k3_bytes(122880, 60, 1, 4) == 4 * 122880 * 299
    assert k3_bytes(6336, 20, 2, 4) < 50e6


def test_vmix_solve_span_is_no_benchmark_label():
    names, prefixes = program_span_names()
    assert "ocn.vmix_solve" in names
    for n in names | prefixes:
        assert not n.startswith(("k1:", "k2:", "k3:")), n
