"""jw_120km: MPAS-A's dry nonhydrostatic dycore on the Jablonowski-
Williamson baroclinic wave (case 2) on the 40,962-cell icosahedral mesh.

The program's path is chip_smoke.py:jw_setup's: init_jw on the mesh file,
float32 on the card, init_carry, then time_integration.srk3_step once a
step (split RK3, 3 dynamics substeps, 2 acoustic substeps; monotonic
transport of the passive scalars). The inputs the seed draws, handed to
both sides in float64 and cast to the program's float32: a JW-style zonal
wind bump of U_BUMP m/s (JW's own shape and radius) at a seeded centre,
added to u and to ru = rho_edge u, and the passive scalar, a seeded sum
of smooth modes between 0.5 and 1.5.

The check (benchmark/reference, float64 on the card): the reference runs
its own init from the same file and inputs, as many steps as the
program had made when the window's third step ended, and is compared
field by field; then it takes one step
from the program's state before the sampled step and is compared with
the program's state after it. Each of u, rho_zz and the scalars gives its
own number, max |program - reference| / max |reference|: start_<field>
and step_<field> (a traffic's limits name those it compares);
step_k2 holds each K2 contraction of the sampled step to a float64 einsum
of its own inputs (benchmark/harness/calls.py).
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import torch

from benchmark.harness.calls import k2_gap
from benchmark.harness.dataclasses_io import clone, convert
from benchmark.harness.meshfile import load_reference, mesh_path
from benchmark.harness.setup_parts import Parts

FIELDS = ("u", "w", "theta_m", "rho_zz", "scalars")
# the fields whose gap the TF32 control moves to 3 x the program's or
# more (PERF.md): w and theta_m sit at their own float32 rounding
COMPARED = ("u", "rho_zz", "scalars")


def program_impl():
    from mpas_tpu_torch.constants import a
    from mpas_tpu_torch.cores.atmosphere import time_integration
    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
    from mpas_tpu_torch.mesh.cache import load_mesh
    return SimpleNamespace(name="program", radius=a, AtmConfig=AtmConfig,
                           init_jw=init_jw, ti=time_integration,
                           load_mesh=load_mesh, tf32=None, k2_sites=(
                               ("mpas_tpu_torch.ops.stencils", "tinydot"),
                               ("mpas_tpu_torch.cores.atmosphere.advection",
                                "tinydot")))


def reference_impl():
    from benchmark.reference.atmosphere import time_integration
    from benchmark.reference.atmosphere.config import AtmConfig
    from benchmark.reference.atmosphere.init_jw import init_jw
    from benchmark.reference.constants import a
    from benchmark.reference.ops import plain
    return SimpleNamespace(name="reference", radius=a, AtmConfig=AtmConfig,
                           init_jw=init_jw, ti=time_integration,
                           load_mesh=load_reference, tf32=plain.round_tf32,
                           k2_sites=(
                               ("benchmark.reference.ops.stencils",
                                "tinydot"),
                               ("benchmark.reference.atmosphere.advection",
                                "tinydot")))


def make_inputs(params, seed, device):
    """The seeded inputs, float64 on `device`, from the mesh file's
    unit-sphere arrays: du (nEdges,) and the scalar (nCells, nz, ns)."""
    mesh = load_reference(mesh_path(params)).to(device, torch.float64)
    s = params["seeded_inputs"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    f64 = dict(dtype=torch.float64, device=device)
    r = torch.rand(4 + 4 * s["scalar_modes"], generator=g, **f64)
    lat_c = math.radians(s["bump_lat_deg"]) * (2.0 * r[0] - 1.0)
    lon_c = 2.0 * math.pi * r[1]
    # JW's perturbation (init_jw.py: u_pert) centred at (lat_c, lon_c)
    arg = torch.sqrt(torch.sin(0.5 * (mesh.latEdge - lat_c)) ** 2
                     + torch.cos(mesh.latEdge) * torch.cos(lat_c)
                     * torch.sin(0.5 * (mesh.lonEdge - lon_c)) ** 2)
    dist = 2.0 * torch.arcsin(torch.clamp(arg, -1.0, 1.0))
    voe = mesh.verticesOnEdge
    dlat = mesh.latVertex[voe[:, 1]] - mesh.latVertex[voe[:, 0]]
    du = s["bump_m_s"] * torch.exp(-(dist / s["bump_radius"]) ** 2) \
        * dlat / mesh.dvEdge
    # the scalar: 1 + sum_j a_j cos(lat) sin(m_j lon + phi_j) cos(k_j lat)
    lat, lon = mesh.latCell[:, None], mesh.lonCell[:, None]
    q = torch.ones_like(lat)
    for j in range(s["scalar_modes"]):
        amp, m, phi, k = r[4 + 4 * j: 8 + 4 * j]
        q = q + s["scalar_amplitude"] * (2.0 * amp - 1.0) * torch.cos(lat) \
            * torch.sin(torch.floor(1.0 + 6.0 * m) * lon + 2.0 * math.pi
                        * phi) * torch.cos(torch.floor(4.0 * k) * lat)
    return {"du": du, "q": q}


def host_init(impl, params, traffic, mesh=None):
    """(cfg, grid, state, diag) of impl's init_jw on the mesh file (or
    `mesh`, read from it), on the host in float64: what does not depend
    on the seed."""
    cfg = impl.AtmConfig(
        config_nvertlevels=traffic["levels"],
        config_len_disp=params["len_disp_m"], config_dt=params["dt_s"],
        config_number_of_sub_steps=params["acoustic_substeps"])
    if mesh is None:
        mesh = impl.load_mesh(str(mesh_path(params)))
    return (cfg, *impl.init_jw(mesh, cfg, case=2,
                               n_scalars=traffic["scalars"],
                               radius=impl.radius))


class JwCase:
    """One side's run: impl's init from the mesh file and the inputs, on
    `device` in `dtype`; step() is one srk3_step."""

    def __init__(self, impl, params, traffic, inputs, device, dtype,
                 tf32=False, host=None):
        self.impl, self.device, self.tf32 = impl, device, tf32
        self.k2_sites = impl.k2_sites
        nz = traffic["levels"]
        self.cfg, grid, state, diag = host or host_init(impl, params,
                                                        traffic)
        self.dt = params["dt_s"]
        self.grid = grid.to(device, dtype)
        state, diag = state.to(device, dtype), diag.to(device, dtype)
        du = inputs["du"].to(dtype)[:, None]
        c = self.grid.mesh.cellsOnEdge
        rho_edge = 0.5 * (state.rho_zz[c[:, 0]] + state.rho_zz[c[:, 1]])
        q = inputs["q"].to(dtype)[:, :, None].expand(-1, nz, traffic[
            "scalars"]).contiguous()
        state = dataclasses.replace(state, u=state.u + du, scalars=q)
        diag = dataclasses.replace(diag, ru=diag.ru + rho_edge * du)
        self.carry = impl.ti.init_carry(self.grid, self.cfg, state, diag,
                                        self.dt)
        self.steps_done = 0

    def step(self):
        if self.tf32:
            with self.impl.tf32():
                self._step()
        else:
            self._step()

    def _step(self):
        self.carry = self.impl.ti.srk3_step(self.grid, self.cfg, self.carry,
                                            self.dt)
        self.steps_done += 1

    def checkable(self):
        return True

    def snapshot(self):
        return clone(self.carry)

    def finite(self):
        return all(bool(torch.isfinite(getattr(self.carry.state, k)).all())
                   for k in FIELDS)

    def release(self):
        self.grid = self.carry = None


def gaps(prefix, got, ref):
    """{prefix_field: max |got - ref| / max |ref|} over COMPARED
    (float64)."""
    out = {}
    for k in COMPARED:
        r = getattr(ref, k).double()
        d = (getattr(got, k).double() - r).abs().max()
        out[f"{prefix}_{k}"] = float(d / r.abs().max())
    return out


def build(params, traffic, seed, device, control=False, host=None):
    """The run's case: the program in float32, or, for the control, the
    reference in its place in float32 with its K2 contractions in TF32;
    host: host_init's result for that side, where the caller has it."""
    impl = reference_impl() if control else program_impl()
    parts = Parts(device)
    path = mesh_path(params)
    parts.mark("mesh_file")
    if host is None:
        mesh = impl.load_mesh(str(path))
        parts.mark("mesh_load")
        host = host_init(impl, params, traffic, mesh)
        parts.mark("host_init")
    inputs = make_inputs(params, seed, device)
    parts.mark("inputs")
    case = JwCase(impl, params, traffic, inputs, device, torch.float32,
                  tf32=control, host=host)
    parts.mark("to_device")
    case.inputs = inputs
    for _ in range(traffic["warm_steps"]):
        case.step()
    parts.mark("warm_steps")
    case.setup_parts = parts.seconds
    return case


def check(params, traffic, inputs, rec, device, host=None):
    """{name: value} of the numbers compared (module docstring); host:
    the reference's host_init, where the caller has it."""
    from benchmark.reference.atmosphere import state as ref_state
    impl = reference_impl()
    ref = JwCase(impl, params, traffic, inputs, device, torch.float64,
                 host=host)
    for _ in range(rec.start_at):
        ref.step()
    out = gaps("start", rec.start.state, ref.carry.state)
    classes = {"AtmCarry": impl.ti.AtmCarry, "AtmState": ref_state.AtmState,
               "AtmDiag": ref_state.AtmDiag}
    ref.carry = convert(rec.pre, classes, torch.float64)
    ref.step()
    out.update(gaps("step", rec.post.state, ref.carry.state))
    out["step_k2"] = k2_gap(rec.k2_calls)
    return out


def bytes_per_step(params, traffic):
    """The least bytes one step must move, from the shapes and the stage
    counts of the split RK3 (never from the program's kernels): in each
    of the dynamics_split_steps x rk_stages dynamics passes the prognostic
    state (u, w, theta_m, rho_zz) read and written once, the metric zz
    read once and the connectivity it gathers by (cellsOnEdge,
    edgesOnCell, as 4-byte indices) read once; in each of the rk_stages
    transport passes the scalars read and written once."""
    c = params["counts"]
    nc, ne, me = c["cells"], c["edges"], c["max_edges"]
    nz, ns = traffic["levels"], traffic["scalars"]
    f = params["itemsize"]
    state = ne * nz + nc * (nz + 1) + 2 * nc * nz
    dyn_pass = f * (2 * state + nc * nz) + 4 * (2 * ne + me * nc)
    transport_pass = f * 2 * nc * nz * ns
    return (params["dynamics_split_steps"] * params["rk_stages"] * dyn_pass
            + params["rk_stages"] * transport_pass)
