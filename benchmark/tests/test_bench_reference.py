"""Each configuration's frozen reference against the port on the CPU at
the test size, in float64: the same init from the same mesh file and
inputs, then steps (and, for the ocean, members and particles)."""

import torch

from benchmark.harness import common

from .conftest import small_params, small_traffic

F64 = torch.float64
CPU = torch.device("cpu")


def rel(a, b):
    a, b = a.double(), b.double()
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def test_jw_reference_follows_the_port():
    mod = common.config_module("jw_120km")
    params, traffic = small_params("jw_120km"), small_traffic(
        "jw_120km.l26")
    inputs = mod.make_inputs(params, 2 ** 40 + 3, CPU)
    sides = [mod.JwCase(impl, params, traffic, inputs, CPU, F64)
             for impl in (mod.program_impl(), mod.reference_impl())]
    for _ in range(3):
        for s in sides:
            s.step()
    prog, ref = (s.carry for s in sides)
    for k in mod.FIELDS:
        assert rel(getattr(prog.state, k), getattr(ref.state, k)) < 1e-12, k
    for k in ("ru", "rw", "exner", "pressure_p"):
        assert rel(getattr(prog.diag, k), getattr(ref.diag, k)) < 1e-12, k


def test_ocean_reference_follows_the_port():
    mod = common.config_module("ocean_global_120km")
    params = small_params("ocean_global_120km")
    traffic = small_traffic("ocean_global_120km.analysis")
    inputs = mod.make_inputs(params, 2 ** 40 + 3)
    sides = [mod.OceanCase(impl, params, traffic, inputs, CPU, F64)
             for impl in (mod.program_impl(), mod.reference_impl())]
    for _ in range(3):
        for s in sides:
            s.step()
    prog, ref = sides
    for k in ("u", "layerThickness", "tracers", "ubtr"):
        assert rel(getattr(prog.state, k), getattr(ref.state, k)) < 1e-12, k
    for name, hist in ref.driver.history.items():
        got = prog.driver.history[name]
        assert [t for t, _ in got] == [t for t, _ in hist], name
        for (_, g), (_, r) in zip(got, hist):
            assert mod.member_gaps(g, r, r)[0] < 1e-10, name
    assert mod.particle_gap([t.state for t in prog.trackers],
                            [t.state for t in ref.trackers], 1.0) < 1e-6
