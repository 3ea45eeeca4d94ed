"""The halo-exchange metrics (halo_ms_per_step, halo_exchanges_per_step)
on a synthetic trace whose answers are known: two steps, three par.halo
spans (the program's, parallel/runner.py:ShardExchange) holding a gather,
an NCCL kernel and a copy, and a kernel outside them; a trace without the
span gives nothing."""

import pytest

from benchmark.harness.trace import WINDOW_SPAN, Trace

from .test_bench_metrics import _x, ctx, read

US = 1e-6


def synthetic(halo=True):
    ev = [_x("user_annotation", WINDOW_SPAN, 0.0, 1000.0),
          _x("user_annotation", "step", 0.0, 500.0),
          _x("user_annotation", "step", 500.0, 500.0)]
    if halo:
        ev += [_x("user_annotation", "par.halo", t, 40.0)
               for t in (100.0, 300.0, 600.0)]
    launches = {1: 110.0, 2: 120.0, 3: 310.0, 4: 620.0, 5: 700.0}
    ev += [_x("cuda_runtime", "cudaLaunchKernel", t, 2.0, correlation=c)
           for c, t in launches.items()]
    ev += [_x("kernel", "index_kernel", 150.0, 10.0, correlation=1),
           _x("kernel", "ncclDevKernel_SendRecv", 160.0, 30.0,
              correlation=2),
           _x("gpu_memcpy", "Memcpy DtoD", 320.0, 5.0, correlation=3),
           _x("kernel", "CatArrayBatchedCopy", 650.0, 15.0, correlation=4),
           _x("kernel", "outside", 720.0, 100.0, correlation=5)]
    return Trace(ev)


def test_halo_readers():
    c = ctx(synthetic())
    assert read("halo_exchanges_per_step", c) == pytest.approx(1.5)
    # everything launched inside a par.halo span, the copy too
    assert read("halo_ms_per_step", c) == pytest.approx(
        1e3 * (10 + 30 + 5 + 15) * US / 2)


def test_a_program_without_the_span_gives_nothing():
    c = ctx(synthetic(halo=False))
    assert read("halo_exchanges_per_step", c) is None
    assert read("halo_ms_per_step", c) is None
