"""ocean_global_120km: MPAS-Ocean's global split-explicit ocean with BGC,
analysis members and particles, composed as mpas_tpu_torch/tools/
ocean_global.py composes it (written out here, so that an edit of that
tool cannot change the mix).

Set-up: init_global_ocean on the 40,962-cell mesh file from a
WOA-shaped 1-degree, 102-level dataset at 60 layers, plus the 8 ecosys
pools of ecosys_profiles at tracer 2 and DIC, ALK at 10, 11 (12 tracers);
float32 on the card. The inputs the seed draws, handed to both sides:
smooth anomalies of the dataset's temperature (decaying below the
surface), salinity and zonal wind stress. A step: core.ocn_timestep
(surface forcing, split_step at dt 900 s, btr 60 s, the implicit
vertical mix) with the init's wind, then bgc.ecosys_step under 250
max(cos lat, 0) W/m2 and bgc.carbon_step with the state's SST and SSS
and a 7 m/s wind; where the traffic runs analysis, every member of
available_members() through an AnalysisDriver due every
analysis_interval_s (and once at t = 0 in set-up) and four
ParticleTrackers (one per vertical treatment, one particle at the centre
of each ocean cell) every step.

The check (benchmark/reference, float64 on the card): the reference runs
its own init, members and trackers from the same file and inputs for as
many steps as the program had made when the window's third step ended,
and is compared: each state field (u, h = layerThickness, ubtr, T, S,
and the 10 BGC pools, each against its own maximum, the worst taken) and
each tracker's positions. Then it takes one step from the program's
state before the sampled step (an analysis step where the traffic runs
analysis): the state's fields again, the members on the program's state
after the step (those that keep no state of their own between calls),
and the trackers from the program's particles before it. Fields and
members compare max |program - reference| / max |reference| (members
the worst output of the worst member, leaving out the outputs float32
cannot give: member_gaps); particles the 99th percentile of the distance
between a particle's two positions in units of the mean cell spacing;
step_k2 each K2 contraction of the sampled step against a float64 einsum
of its own inputs.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness.calls import k2_gap
from benchmark.harness.dataclasses_io import clone, convert
from benchmark.harness.meshfile import load_reference, mesh_path
from benchmark.harness.setup_parts import Parts

VERTICAL_MODES = ("indexLevel", "fixedZLevel", "passiveFloat", "isopycnal")
# members that carry state of their own from call to call: compared only
# on the reference's own trajectory
STATEFUL_MEMBERS = ("timeFilters", "testComputeInterval")


def program_impl():
    from mpas_tpu_torch.cores.ocean import analysis, bgc, core
    from mpas_tpu_torch.cores.ocean.analysis import particles
    from mpas_tpu_torch.cores.ocean.config import OcnConfig
    from mpas_tpu_torch.cores.ocean.init_configs import ecosys_profiles
    from mpas_tpu_torch.cores.ocean.init_global_ocean import (
        init_global_ocean)
    from mpas_tpu_torch.cores.ocean.state import OcnState
    from mpas_tpu_torch.mesh.cache import load_mesh
    from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs
    return SimpleNamespace(
        name="program", core=core, bgc=bgc, analysis=analysis,
        particles=particles, OcnConfig=OcnConfig, OcnState=OcnState,
        ecosys_profiles=ecosys_profiles,
        init_global_ocean=init_global_ocean, load_mesh=load_mesh,
        reconstruct_coeffs=build_reconstruct_coeffs, tf32=None,
        k2_sites=(("mpas_tpu_torch.ops.stencils", "tinydot"),))


def reference_impl():
    from benchmark.reference.ocean import analysis, bgc, core
    from benchmark.reference.ocean.analysis import particles
    from benchmark.reference.ocean.config import OcnConfig
    from benchmark.reference.ocean.init_configs import ecosys_profiles
    from benchmark.reference.ocean.init_global_ocean import (
        init_global_ocean)
    from benchmark.reference.ocean.state import OcnState
    from benchmark.reference.ops import plain
    from benchmark.reference.ops.reconstruct import build_reconstruct_coeffs
    return SimpleNamespace(
        name="reference", core=core, bgc=bgc, analysis=analysis,
        particles=particles, OcnConfig=OcnConfig, OcnState=OcnState,
        ecosys_profiles=ecosys_profiles,
        init_global_ocean=init_global_ocean, load_mesh=load_reference,
        reconstruct_coeffs=build_reconstruct_coeffs, tf32=plain.round_tf32,
        k2_sites=(("benchmark.reference.ops.stencils", "tinydot"),))


def _modes(rng, lat, lon, n):
    """A smooth field of n random modes of amplitude <= 1, on (lat, lon)."""
    f = np.zeros(np.broadcast(lat, lon).shape)
    for _ in range(n):
        a, m, phi, k = rng.uniform(size=4)
        f += (2.0 * a - 1.0) / n * np.cos(lat) \
            * np.sin(np.floor(1.0 + 6.0 * m) * lon + 2.0 * np.pi * phi) \
            * np.cos(np.floor(4.0 * k) * lat)
    return f


def make_inputs(params, seed):
    """The seeded dataset (host numpy, float64): the frozen copy of
    synthetic_woa_dataset at the configuration's grid with the seed's
    anomalies."""
    from benchmark.reference.ocean.init_global_ocean import (
        synthetic_woa_dataset)
    d = params["dataset"]
    ds = synthetic_woa_dataset(nlat=d["nlat"], nlon=d["nlon"],
                               ndep=d["ndep"])
    s = params["seeded_inputs"]
    rng = np.random.default_rng(int(seed))
    la, lo = np.meshgrid(ds["lat"], ds["lon"], indexing="ij")
    decay = np.exp(-ds["depth"] / s["anomaly_depth_m"])[:, None, None]
    ds["temperature"] = ds["temperature"] + s["temperature_k"] * decay \
        * _modes(rng, la, lo, s["modes"])[None]
    ds["salinity"] = ds["salinity"] + s["salinity_psu"] * decay \
        * _modes(rng, la, lo, s["modes"])[None]
    ds["windstress_zonal"] = ds["windstress_zonal"] * (
        1.0 + s["wind_factor"] * _modes(rng, la, lo, s["modes"]))
    return {"dataset": ds}


def host_init(impl, params, traffic):
    """What does not depend on the seed: the mesh."""
    return impl.load_mesh(str(mesh_path(params)))


class OceanCase:
    """One side's run: impl's init from the mesh and the inputs, on
    `device` in `dtype`; step() is one step of the composition."""

    def __init__(self, impl, params, traffic, inputs, device, dtype,
                 tf32=False, host=None, parts=None):
        self.impl, self.device, self.tf32 = impl, device, tf32
        self.k2_sites = impl.k2_sites
        self.params, self.traffic = params, traffic
        parts = parts or Parts(device)
        mesh = host if host is not None else host_init(impl, params,
                                                       traffic)
        parts.mark("mesh_load")
        grid, state, forcing = impl.init_global_ocean(
            mesh, inputs["dataset"], nz=params["layers"])
        h = state.layerThickness.numpy()
        z_mid = -np.cumsum(h, -1) + 0.5 * h
        b = params["bgc"]
        extra = impl.ecosys_profiles(z_mid) + [
            np.full(z_mid.shape, b["dic"]), np.full(z_mid.shape, b["alk"])]
        tracers = torch.cat([state.tracers,
                             torch.from_numpy(np.stack(extra, -1))], -1)
        state = dataclasses.replace(state, tracers=tracers)
        self.cfg = impl.OcnConfig(config_dt=params["dt_s"],
                                  config_btr_dt=params["btr_dt_s"])
        self.dt = params["dt_s"]
        coeffs = impl.reconstruct_coeffs(grid.mesh) \
            if traffic["analysis"] else None
        parts.mark("host_init")
        self.grid = grid.to(device, dtype)
        self.state = state.to(device, dtype)
        self.forcing = forcing.to(device, dtype)
        parts.mark("to_device")
        self.sw = b["sw_peak"] * torch.clamp(
            torch.cos(self.grid.mesh.latCell), min=0.0)
        self.wind = torch.full_like(self.sw, b["wind10_m_s"])
        self.t = 0.0
        self.steps_done = 0
        self.driver = self.trackers = None
        if traffic["analysis"]:
            self.driver = impl.analysis.AnalysisDriver(
                {n: traffic["analysis_interval_s"]
                 for n in impl.analysis.available_members()})
            self.driver.init(self.grid, self.cfg)
            self.trackers = make_trackers(impl, self.grid, self.cfg,
                                          self.state, coeffs, params)
            self.driver.compute_due(self.grid, self.cfg, self.state, 0.0,
                                    forcing=self.forcing)
            parts.mark("analysis_init")

    def step(self):
        if self.tf32:
            with self.impl.tf32():
                self._step()
        else:
            self._step()

    def _step(self):
        i, g, cfg, dt = self.impl, self.grid, self.cfg, self.dt
        b = self.params["bgc"]
        s = i.core.ocn_timestep(g, cfg, self.state, dt, self.forcing)
        s = i.bgc.ecosys_step(s, g, dt, self.sw, index0=b["ecosys_index0"])
        s, _ = i.bgc.carbon_step(s, g, dt, s.tracers[:, 0, 0],
                                 s.tracers[:, 0, 1], self.wind,
                                 b["dic_index"], b["alk_index"])
        self.t += dt
        if self.driver is not None:
            self.driver.compute_due(g, cfg, s, self.t, forcing=self.forcing)
            # the outputs of earlier calls are dropped, as a run that
            # writes them at each output time would: the history holds
            # device tensors and would otherwise grow through the window
            for h in self.driver.history.values():
                del h[:-1]
            step_particles(i, self.trackers, g, cfg, s, dt)
        self.state = s
        self.steps_done += 1

    def checkable(self):
        """Whether the coming step is one the check may sample: an
        analysis step where the traffic runs analysis."""
        if self.driver is None:
            return True
        n = (self.t + self.dt) / self.traffic["analysis_interval_s"]
        return abs(n - round(n)) < 1e-9

    def snapshot(self):
        snap = {"state": clone(self.state), "t": self.t}
        if self.driver is not None:
            snap["members"] = {n: h[-1] for n, h in
                               self.driver.history.items()
                               if h and abs(h[-1][0] - self.t) < 1e-6}
            snap["particles"] = [clone(tr.state) for tr in self.trackers]
        return snap

    def finite(self):
        return all(bool(torch.isfinite(getattr(self.state, k)).all())
                   for k in ("u", "layerThickness", "tracers", "ubtr"))

    def release(self):
        self.grid = self.state = self.forcing = None
        self.driver = self.trackers = None


def ocean_cells(grid):
    """init_global_ocean zeroes the tidal energy flux over land only."""
    return torch.nonzero(grid.tidalEnergyFlux > 0)[:, 0]


def make_trackers(impl, grid, cfg, state, coeffs, params):
    """One ParticleTracker per vertical treatment, one particle at the
    centre of each ocean cell (which starts the walk); the isopycnal
    target is each cell's t=0 density at the isopycnal layer."""
    p = params["particles"]
    m = grid.mesh
    cells = ocean_cells(grid)
    rho = impl.core.equation_of_state(cfg, state.tracers[..., 0],
                                      state.tracers[..., 1])
    depth = torch.full(cells.shape, p["depth_m"], dtype=m.xCell.dtype,
                       device=cells.device)
    extra = {"indexLevel": {}, "fixedZLevel": {"depth": depth},
             "passiveFloat": {"depth": depth},
             "isopycnal": {"target_rho": rho[cells, p["isopycnal_layer"]]}}
    return [impl.particles.ParticleTracker(
        m, m.xCell[cells], m.yCell[cells], layer=p["layer"],
        z0=m.zCell[cells], vertical_mode=mode, coeffs=coeffs, cell0=cells,
        **extra[mode]) for mode in VERTICAL_MODES]


def step_particles(impl, trackers, grid, cfg, state, dt):
    """One RK2 step of every tracker in the state's flow, the cell-centre
    velocity reconstructed once for all of them."""
    rho = impl.core.equation_of_state(cfg, state.tracers[..., 0],
                                      state.tracers[..., 1])
    c1, c2 = grid.mesh.cellsOnEdge[:, 0], grid.mesh.cellsOnEdge[:, 1]
    h = state.layerThickness
    uh = state.u * 0.5 * (h[c1] + h[c2])
    if grid.edgeMask is not None:
        uh = uh * grid.edgeMask
    w = impl.core.thickness_tendency(grid, uh)[2]
    uv = trackers[0].cell_velocity(state.u)
    for tr in trackers:
        tr.step(state.u, dt, layer_thickness=h, w_vert=w, density=rho,
                cell_velocity=uv)


def state_gaps(prefix, got, ref, params):
    """{prefix_field: rel_gap} of u, h, ubtr, T, S, and the worst BGC
    pool."""
    out = {f"{prefix}_{name}": rel_gap(g, r) for name, g, r in (
        ("u", got.u, ref.u),
        ("h", got.layerThickness, ref.layerThickness),
        ("ubtr", got.ubtr, ref.ubtr),
        ("T", got.tracers[..., 0], ref.tracers[..., 0]),
        ("S", got.tracers[..., 1], ref.tracers[..., 1]))}
    out[f"{prefix}_bgc"] = max(
        rel_gap(got.tracers[..., j], ref.tracers[..., j])
        for j in range(params["bgc"]["ecosys_index0"],
                       got.tracers.shape[-1]))
    return out


def member_gaps(got, ref64, ref32, ill=1e-3):
    """(worst gap, outputs left out): max |got - ref64| / max |ref64| over
    a member's outputs, leaving out each output that the reference's own
    float32 evaluation of the same input departs from its float64 one by
    more than `ill` of its largest value (an output float32 cannot give,
    such as the sea-surface height a sum of 60 layer thicknesses less the
    bottom depth yields while it is near zero). A NaN where the other
    side has none, or an output missing, counts as 1."""
    worst, left_out = 0.0, 0
    for k, r in ref64.items():
        if not isinstance(r, torch.Tensor):
            continue
        g = got.get(k)
        if not isinstance(g, torch.Tensor) or g.shape != r.shape \
                or not torch.equal(torch.isnan(g), torch.isnan(r)):
            return 1.0, left_out
        if rel_gap(ref32[k], r) > ill:
            left_out += 1
            continue
        worst = max(worst, rel_gap(g, r))
    return worst, left_out


def rel_gap(got, ref):
    """max |got - ref| / max |ref| over the entries finite in ref; 0
    where ref is all zero and got equals it."""
    r, g = ref.double(), got.double()
    fin = torch.isfinite(r)
    d = float(torch.where(fin, g - r, 0.0).abs().max()) if r.numel() else 0.0
    m = float(torch.where(fin, r, 0.0).abs().max()) if r.numel() else 0.0
    return d / m if m > 0 else (0.0 if d == 0 else 1.0)


def particle_gap(got, ref, spacing, q=0.99):
    """Worst over the trackers of the q-quantile of the distance between
    a particle's two positions, in units of the mesh's mean cell spacing.
    The quantile, not the largest: a particle near a cell's or a layer's
    edge may walk to the other side on a rounding, and then moves with
    another velocity."""
    def xyz(ps):
        return torch.stack([ps.x.double(), ps.y.double(), ps.z3.double()])
    return max(float(torch.quantile((xyz(g) - xyz(r)).norm(dim=0), q))
               for g, r in zip(got, ref)) / spacing


def build(params, traffic, seed, device, control=False, host=None):
    """The run's case: the program in float32, or, for the control, the
    reference in its place in float32 with its K2 contractions in TF32."""
    impl = reference_impl() if control else program_impl()
    parts = Parts(device)
    mesh_path(params)
    parts.mark("mesh_file")
    inputs = make_inputs(params, seed)
    parts.mark("inputs")
    case = OceanCase(impl, params, traffic, inputs, device, torch.float32,
                     tf32=control, host=host, parts=parts)
    case.inputs = inputs
    for _ in range(traffic["warm_steps"]):
        case.step()
    parts.mark("warm_steps")
    case.setup_parts = parts.seconds
    return case


def check(params, traffic, inputs, rec, device, host=None):
    """{name: value} of the numbers compared (module docstring)."""
    impl = reference_impl()
    f64 = torch.float64
    ref = OceanCase(impl, params, traffic, inputs, device, f64, host=host)
    spacing = float(ref.grid.mesh.dcEdge.double().mean())
    for _ in range(rec.start_at):
        ref.step()
    out = state_gaps("start", rec.start["state"], ref.state, params)
    if ref.driver is not None:
        out["start_particles"] = particle_gap(
            rec.start["particles"], [tr.state for tr in ref.trackers],
            spacing)
    # one step from the program's state before the sampled step: the
    # dynamics and BGC, then the members on the program's state after
    # it and the trackers from its particles before it
    driver, trackers = ref.driver, ref.trackers
    ref.driver = None
    classes = {"OcnState": impl.OcnState,
               "ParticleState": impl.particles.ParticleState}
    ref.state = convert(rec.pre["state"], classes, f64)
    ref.t = rec.pre["t"]
    ref.step()
    out.update(state_gaps("step", rec.post["state"], ref.state, params))
    out["step_k2"] = k2_gap(rec.k2_calls)
    if driver is not None:
        post = convert(rec.post["state"], classes, f64)
        post32 = convert(rec.post["state"], classes, torch.float32)
        grid32 = ref.grid.to(device, torch.float32)
        forcing32 = ref.forcing.to(device, torch.float32)
        driver32 = impl.analysis.AnalysisDriver(dict(driver.members))
        driver32.init(grid32, ref.cfg)
        worst, left_out = 0.0, 0
        for n in driver.members:
            if n in STATEFUL_MEMBERS or n not in rec.post["members"]:
                continue
            g, k = member_gaps(
                rec.post["members"][n][1],
                driver._run(n, ref.grid, ref.cfg, post, ref.forcing),
                driver32._run(n, grid32, ref.cfg, post32, forcing32))
            worst, left_out = max(worst, g), left_out + k
        out["step_members"] = worst
        out["members_left_out"] = left_out
        pre = [convert(ps, classes, f64) for ps in rec.pre["particles"]]
        for tr, ps in zip(trackers, pre):
            tr.state = ps
        step_particles(impl, trackers, ref.grid, ref.cfg, post, ref.dt)
        out["step_particles"] = particle_gap(
            rec.post["particles"], [tr.state for tr in trackers], spacing)
    return out


def bytes_per_step(params, traffic):
    """The least bytes one step must move, from the shapes and the stage
    counts of the split-explicit step (never from the program's
    kernels): in each of the baroclinic passes the state (u, h, the
    tracers) read and written once; in each barotropic subcycle the
    barotropic velocity (edges) and the sea-surface height (cells) read
    and written once; BGC: the pools and DIC/ALK read and written once;
    with analysis, the particles' seven values read and written once a
    step and, every analysis_interval_s, the state read once by the
    members."""
    c = params["counts"]
    nc, ne = c["cells"], c["edges"]
    nz, f = params["layers"], params["itemsize"]
    nt = params["tracers"]
    state = ne * nz + nc * nz * (1 + nt)
    s = params["split"]
    total = s["baroclinic_passes"] * 2 * state * f \
        + s["barotropic_subcycles"] * 2 * (ne + nc) * f \
        + 2 * nc * nz * (nt - params["bgc"]["ecosys_index0"]) * f
    if traffic["analysis"]:
        n_particles = len(VERTICAL_MODES) * params["particles"][
            "ocean_cells"]
        total += 2 * 7 * n_particles * f
        total += state * f * params["dt_s"] / traffic["analysis_interval_s"]
    return int(total)
