"""The program's spans (mpas_tpu_torch/framework/timers.py:span and
spanned) on the CPU at test size: off, one shared null context; under
torch.profiler, the regions each step opens, with their counts; and a
step's outputs the same bit for bit with the profiler on and off."""

import collections
import dataclasses
import inspect

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpas_tpu_torch.cores.atmosphere import distributed as adist
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
from mpas_tpu_torch.cores.atmosphere.time_integration import (init_carry,
                                                              srk3_step)
from mpas_tpu_torch.cores.ocean import core as ocean_core
from mpas_tpu_torch.cores.ocean.analysis import available_members
from mpas_tpu_torch.cores.ocean.init_global_ocean import (
    synthetic_woa_dataset)
from mpas_tpu_torch.cores.seaice import analysis as seaice_analysis
from mpas_tpu_torch.framework.timers import span, spanned
from mpas_tpu_torch.mesh.planar import box_hex_mesh
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
from mpas_tpu_torch.parallel.partition import sfc_partition
from mpas_tpu_torch.parallel.runner import (HALO_SPAN, ShardExchange,
                                            ShardGroup, place)
from mpas_tpu_torch.tools import landice_dome as ld
from mpas_tpu_torch.tools import ocean_global as og
from mpas_tpu_torch.tools import seaice_box as sb

torch.set_num_threads(1)

PREFIXES = ("atm.", "ocn.", "li.", "si.", "par.")


def opened(fn):
    """(fn(), Counter of the program's spans fn opened under a CPU
    profiler session)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, collections.Counter(e.name for e in prof.events()
                                    if e.name.startswith(PREFIXES))


def leaves(x):
    """The tensors of a state, carry or nested tuple, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    return []


def assert_identical(a, b):
    la, lb = leaves(a), leaves(b)
    assert la and len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = span("atm.srk3_step"), span("ocn.barotropic")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = span("atm.srk3_step")
        assert on is not a
        with on:
            pass
    assert span("atm.srk3_step") is a


def test_spanned_makes_each_call_its_region():
    def step(x, dt=2.0):
        """One step."""
        return x * dt

    marked = spanned("ocn.test")(step)
    assert marked.__name__ == "step" and marked.__doc__ == "One step."
    assert inspect.signature(marked) == inspect.signature(step)
    assert marked(3.0) == 6.0
    out, spans = opened(lambda: marked(torch.ones(2), dt=3.0))
    assert torch.equal(out, torch.full((2,), 3.0))
    assert spans == {"ocn.test": 1}


@pytest.mark.parametrize("split", [1, 3])
def test_srk3_step_spans_and_bitwise_outputs(split):
    mesh = icosahedral_mesh(4, lloyd_iters=1)
    cfg = AtmConfig(config_nvertlevels=6, config_len_disp=1920000.0,
                    config_dt=1200.0, config_dynamics_split_steps=split)
    grid, state, diag = init_jw(mesh, cfg, case=2)
    assert state.scalars.shape[-1] == 1          # the passive scalar
    carry = init_carry(grid, cfg, state, diag, cfg.config_dt)
    plain = srk3_step(grid, cfg, carry, cfg.config_dt)
    traced, spans = opened(lambda: srk3_step(grid, cfg, carry,
                                             cfg.config_dt))
    stage = 3 * split                # RK stages of every dynamics substep
    assert spans == {
        "atm.srk3_step": 1, "atm.dyn_tend": stage, "atm.dyn_tend.u": stage,
        "atm.dyn_tend.mixing": split, "atm.dyn_tend.w": stage,
        "atm.dyn_tend.theta": stage,
        # two vert_imp_coefs and acoustic_hoist a substep
        "atm.vert_imp_coefs": 3 * split, "atm.acoustic": stage,
        "atm.recover": stage, "atm.diagnostics": stage,
        "atm.transport": 1, "atm.reconstruct_winds": 1}
    assert_identical(plain, traced)


class _Counted:
    """An exchange's hooks, each call counted, then passed on."""

    def __init__(self, xch):
        self.xch, self.calls = xch, 0

    def __getattr__(self, kind):
        def call(x, depth=None):
            self.calls += 1
            return getattr(self.xch, kind)(x, depth)
        return call


def test_halo_span_opens_once_per_exchange():
    """Each ShardExchange call is one par.halo span: three direct calls,
    and every exchange of a sharded srk3_step; the step's outputs the
    same bit for bit with the profiler on and off."""
    mesh = icosahedral_mesh(4, lloyd_iters=1)
    cfg = AtmConfig(config_nvertlevels=6, config_len_disp=1920000.0,
                    config_dt=1200.0)
    grid, state, diag = init_jw(mesh, cfg, case=2)
    carry = init_carry(grid, cfg, state, diag, cfg.config_dt)
    satm = adist.shard_atm_grid(grid, sfc_partition(mesh, 2))
    group = ShardGroup(2, torch.device("cpu"))
    grid_l = satm.local(group, torch.float64)
    carry_l = place(adist.shard_atm_carry(satm, carry), group,
                    torch.float64)
    xch = ShardExchange(satm.smesh, group)
    u, w = carry_l.state.u, carry_l.state.w
    vort = carry_l.sdiag_vort
    _, spans = opened(lambda: (xch.cell(w), xch.edge(u, depth=1),
                               xch.vertex(vort)))
    assert spans == {HALO_SPAN: 3}
    counted = _Counted(xch)
    plain = srk3_step(grid_l, cfg, carry_l, cfg.config_dt, xch=xch)
    traced, spans = opened(lambda: srk3_step(grid_l, cfg, carry_l,
                                             cfg.config_dt, xch=counted))
    assert counted.calls > 50 and spans[HALO_SPAN] == counted.calls
    assert_identical(plain, traced)


def test_ocean_step_spans_and_bitwise_outputs():
    mesh = icosahedral_mesh(4, lloyd_iters=1)
    cfg, grid, state, forcing = og.setup(
        mesh, 6, dataset=synthetic_woa_dataset(nlat=20, nlon=40, ndep=10))
    dt, sw = cfg.config_dt, og.shortwave(grid)

    def step():
        """ocean_global's step with every member due and the trackers."""
        driver = og.analysis_driver(grid, cfg, dt)
        trackers = og.trackers(grid, cfg, state)
        s = ocean_core.ocn_timestep(grid, cfg, state, dt, forcing)
        s = og.bgc(grid, s, dt, sw)
        og.analysis(driver, grid, cfg, s, 0.0, forcing)
        og.particles(trackers, grid, cfg, s, dt)
        return (s, [driver.history[n][-1][1] for n in driver.members],
                [tr.state for tr in trackers])

    plain = step()
    traced, spans = opened(step)
    n_ts = cfg.config_n_ts_iter
    members = {f"ocn.analysis.{n}": 1 for n in available_members()}
    assert len(members) == 19
    assert spans == {
        "ocn.timestep": 1, "ocn.forcing": 1, "ocn.baroclinic": n_ts,
        "ocn.barotropic": n_ts, "ocn.update": n_ts, "ocn.vertical_mix": 1,
        "ocn.vmix_solve": 1,
        "ocn.bgc": 2, "ocn.particles": 5, **members}
    for a, b in zip(plain[1], traced[1]):
        assert a.keys() == b.keys()
    assert_identical(plain, traced)


def test_landice_step_spans_are_its_parts():
    cfg = ld.config("landice_dome_4km")
    grid, state, hydro, _ = ld.setup("landice_dome_4km",
                                     box_hex_mesh(8, 8, 3000.0), cfg,
                                     (500.0, 10000.0), torch.float64, "cpu")
    plain = ld.step(grid, cfg, state, hydro)
    traced, spans = opened(lambda: ld.step(grid, cfg, state, hydro))
    # the SIA path has no hydrology
    assert spans == {p: 1 for p in ld.PARTS if p != "li.hydrology"}
    assert_identical(plain, traced)


def test_seaice_members_open_their_spans():
    cfg = sb.config("seaice_box_10km")
    grid, state, _, _ = sb.setup("seaice_box_10km",
                                 box_hex_mesh(8, 8, 10000.0), cfg,
                                 torch.float64, "cpu")
    names = seaice_analysis.available_members()
    driver = seaice_analysis.SeaiceAnalysisDriver({n: 1.0 for n in names})
    driver.init(grid, cfg)
    _, spans = opened(lambda: driver.compute_all(grid, cfg, state))
    assert spans == {f"si.analysis.{n}": 1 for n in names}
    _, spans = opened(lambda: driver.compute_due(grid, cfg, state, 0.0))
    assert spans == {f"si.analysis.{n}": 1 for n in names}
