"""The per-layer metrics that read the program's own spans
(mpas_tpu_torch/framework/timers.py:span), on a synthetic trace whose
answers are known, and a guard that no span the program opens takes a
name the benchmark gives its own spans."""

import ast

import pytest

from benchmark.harness import common
from benchmark.harness.trace import WINDOW_SPAN, Trace

from .test_bench_metrics import _x, ctx, read

US = 1e-6
PROGRAM = common.ROOT / "mpas_tpu_torch"
# metric: (the program span it reads, the cells that report it)
JW = ["jw_120km.l26", "jw_120km.l55"]
OCEAN = ["ocean_global_120km.analysis", "ocean_global_120km.no_analysis"]
READERS = {"acoustic_ms_per_step": ("atm.acoustic", JW),
           "transport_ms_per_step": ("atm.transport", JW),
           "barotropic_ms_per_step": ("ocn.barotropic", OCEAN),
           "barotropic_launches_per_step": ("ocn.barotropic", OCEAN),
           "bgc_ms_per_step": ("ocn.bgc", OCEAN)}
# the benchmark's own labels beside the metrics' SPANS: the window's
# span and the one around each step (benchmark/harness/window.py)
BENCH_LABELS = {WINDOW_SPAN, "step"}
BENCH_PREFIXES = ("k1:", "k2:")


def synthetic(program_spans=True):
    """Two steps in a window of 1,000 us. atm.acoustic holds a kernel (30
    us) and a copy (10 us) with a K1 label nested in it; atm.transport a
    kernel (20 us); ocn.barotropic three kernels (5 us each) and a memset
    (2 us); ocn.bgc a kernel (7 us); one kernel (50 us) is launched
    outside every program span."""
    ev = [_x("user_annotation", WINDOW_SPAN, 0.0, 1000.0),
          _x("user_annotation", "step", 0.0, 500.0),
          _x("user_annotation", "step", 500.0, 500.0),
          _x("user_annotation", "k1:40962x26:4", 140.0, 20.0)]
    if program_spans:
        ev += [_x("user_annotation", "atm.acoustic", 100.0, 100.0),
               _x("user_annotation", "atm.transport", 300.0, 50.0),
               _x("user_annotation", "ocn.barotropic", 400.0, 100.0),
               _x("user_annotation", "ocn.bgc", 600.0, 50.0)]
    launches = {1: 150.0, 2: 180.0, 3: 310.0, 4: 410.0, 5: 420.0, 6: 430.0,
                7: 440.0, 8: 610.0, 9: 700.0}
    ev += [_x("cuda_runtime", "cudaLaunchKernel", t, 2.0, correlation=c)
           for c, t in launches.items()]
    ev += [_x("kernel", "k1", 160.0, 30.0, correlation=1),
           _x("gpu_memcpy", "Memcpy DtoD", 200.0, 10.0, correlation=2),
           _x("kernel", "advect", 320.0, 20.0, correlation=3),
           _x("kernel", "btr", 420.0, 5.0, correlation=4),
           _x("kernel", "btr", 430.0, 5.0, correlation=5),
           _x("kernel", "btr", 440.0, 5.0, correlation=6),
           _x("gpu_memset", "Memset", 450.0, 2.0, correlation=7),
           _x("kernel", "ecosys", 620.0, 7.0, correlation=8),
           _x("kernel", "outside", 710.0, 50.0, correlation=9)]
    return Trace(ev)


def test_program_span_readers_on_a_synthetic_trace():
    c = ctx(synthetic(), steps=2)
    assert read("acoustic_ms_per_step", c) == pytest.approx(1e3 * 40 * US
                                                            / 2)
    assert read("transport_ms_per_step", c) == pytest.approx(1e3 * 20 * US
                                                             / 2)
    assert read("barotropic_ms_per_step", c) == pytest.approx(1e3 * 17 * US
                                                              / 2)
    assert read("barotropic_launches_per_step", c) == 1.5
    assert read("bgc_ms_per_step", c) == pytest.approx(1e3 * 7 * US / 2)
    # a trace of a program that opens no spans (an older tree): nothing
    bare = ctx(synthetic(program_spans=False), steps=2)
    for name in READERS:
        assert read(name, bare) is None, name
    # the program's spans label the idle gaps their launches end
    labels = {n for n, _ in synthetic().breakdown()["idle_gaps"]}
    assert {"atm.acoustic", "ocn.barotropic"} <= labels


def test_program_span_metrics_are_declared_for_their_cells(spec):
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name, (span, cells) in READERS.items():
        m = entries[name]
        assert m["workloads"] == cells, name
        assert m["moves"] == "sim_days_per_day"
        mod = common.metric_module(name)
        assert mod.SPANS == () and mod.SPAN == span


def program_span_names():
    """(names, f-string prefixes) of every span the program opens:
    span(...), spanned(...) and the run driver's timers, which open one
    each."""
    names, prefixes = set(), set()
    for path in PROGRAM.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and node.args
                    and getattr(node.func, "id", getattr(
                        node.func, "attr", None)) in ("span", "spanned",
                                                      "timer")):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                head = arg.values[0]
                assert isinstance(head, ast.Constant) and head.value, (
                    f"{path}: a span name must start with its core")
                prefixes.add(head.value)
    return names, prefixes


def test_program_spans_never_take_a_benchmark_label(spec):
    labels = set(BENCH_LABELS)
    for m in spec["per_layer"]:
        for _module, _attr, label in common.metric_module(m["name"]).SPANS:
            if isinstance(label, str):
                labels.add(label)
    assert {"compute_dyn_tend", "ocn_timestep", "analysis"} <= labels
    names, prefixes = program_span_names()
    assert {span for span, _ in READERS.values()} <= names
    assert {"ocn.analysis.", "time integration"} <= prefixes | names
    for n in names | prefixes:
        assert n not in labels and not n.startswith(BENCH_PREFIXES), n
    for p in prefixes:
        assert not any(label.startswith(p) for label in labels), p
