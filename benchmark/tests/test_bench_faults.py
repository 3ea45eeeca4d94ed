"""The harness, with its look for a card skipped, drives a run of each
cell at the test size on the CPU with the timed path broken underneath,
and `correct` comes out false for each fault the cell can have: a step
that returns its state unchanged, half of the cells left out of a step,
an answer altered where it is produced (one cell has no chips to
exchange between). The same run unbroken comes out correct."""

import dataclasses
import importlib

import pytest
import torch

from benchmark import run
from benchmark.harness import common

from .conftest import small_params, small_traffic

CPU = torch.device("cpu")
JW = "mpas_tpu_torch.cores.atmosphere.time_integration"
OCEAN = "mpas_tpu_torch.cores.ocean.core"


def half_kept(new, old):
    """new with the second half of every row kept at old's."""
    out = new.clone()
    out[new.shape[0] // 2:] = old[new.shape[0] // 2:]
    return out


def altered(x):
    """x with one value moved by 1% of x's largest magnitude."""
    out = x.clone()
    out.view(-1)[out.numel() // 3] += 0.01 * float(x.abs().max())
    return out


def jw_fault(kind, step):
    def broken(grid, cfg, carry, dt, xch=None):
        if kind == "unchanged":
            return carry
        new = step(grid, cfg, carry, dt, xch=xch)
        s, o = new.state, carry.state
        if kind == "half":
            s = dataclasses.replace(s, **{k: half_kept(getattr(s, k),
                                                       getattr(o, k))
                                          for k in ("u", "w", "theta_m",
                                                    "rho_zz", "scalars")})
        else:
            s = dataclasses.replace(s, u=altered(s.u))
        return dataclasses.replace(new, state=s)
    return broken


def ocean_fault(kind, step):
    def broken(grid, cfg, state, dt, forcing=None, xch=None):
        if kind == "unchanged":
            return state
        new = step(grid, cfg, state, dt, forcing, xch=xch)
        if kind == "half":
            return dataclasses.replace(new, **{
                k: half_kept(getattr(new, k), getattr(state, k))
                for k in ("u", "layerThickness", "tracers", "ubtr")})
        return dataclasses.replace(new, tracers=altered(new.tracers))
    return broken


def run_small(workload, seed=11):
    spec = common.load_spec()
    cell = common.find(spec["workloads"], workload, "w")
    return run.run_cell(spec, workload, seed, 0.5, 0, CPU,
                        small_params(cell["config"]), small_traffic(workload))


CELLS = [w["name"] for w in common.load_spec()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    r = run_small(workload)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, kind, monkeypatch):
    if workload.startswith("jw_120km"):
        mod = importlib.import_module(JW)
        monkeypatch.setattr(mod, "srk3_step", jw_fault(kind, mod.srk3_step))
    else:
        mod = importlib.import_module(OCEAN)
        monkeypatch.setattr(mod, "ocn_timestep",
                            ocean_fault(kind, mod.ocn_timestep))
    r = run_small(workload)
    assert not r["correct"], r["checks"]


def test_an_altered_member_or_particle_is_not_correct(monkeypatch):
    """The analysis cell's own answers, each altered where it is
    produced: a member's output by 1%, every particle's x by 1e-4 of
    itself (some 600 m on the sphere)."""
    an = importlib.import_module("mpas_tpu_torch.cores.ocean.analysis")
    run_member = an.AnalysisDriver._run

    def member(self, name, *args):
        out = run_member(self, name, *args)
        if name == "globalStats":
            out = dict(out, temperatureGlobalAvg=out["temperatureGlobalAvg"]
                       * 1.01)
        return out
    monkeypatch.setattr(an.AnalysisDriver, "_run", member)
    assert not run_small("ocean_global_120km.analysis")["correct"]
    monkeypatch.undo()

    pt = importlib.import_module(
        "mpas_tpu_torch.cores.ocean.analysis.particles")
    step = pt.ParticleTracker.step

    def moved(self, *args, **kwargs):
        new = step(self, *args, **kwargs)
        self.state = dataclasses.replace(new, x=new.x * (1.0 + 1e-4))
        return self.state
    monkeypatch.setattr(pt.ParticleTracker, "step", moved)
    assert not run_small("ocean_global_120km.analysis")["correct"]
