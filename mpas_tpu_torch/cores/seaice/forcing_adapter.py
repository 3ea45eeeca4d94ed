"""Sea-ice forcing adapter: framework forcing groups -> SeaiceForcing (port
of mpas_tpu/cores/seaice/forcing_adapter.py).

ref: src/core_seaice/model_forward/mpas_seaice_forcing.F (1,876 LoC):
builds two framework forcing groups — 6-hourly atmospheric (winds, air
temperature, radiation) and monthly climatological oceanic (SST, currents,
heat flux) — with cyclic year wrapping, then maps the interpolated records
onto the coupling fields each timestep. Forcing files are classic netCDF
(a netCDF4 file's xtime is not read, as in the reference package).
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.containers import resolve_device
from mpas_tpu_torch.cores.seaice.state import SeaiceForcing
from mpas_tpu_torch.framework.forcing import ForcingGroup, ForcingStream
from mpas_tpu_torch.framework.timekeeping import Time

# coupling-field names (ref: the atmos_coupling/ocean_coupling pools)
ATM_FIELDS = ("uAirVelocity", "vAirVelocity", "airTemperature",
              "shortwaveDown", "longwaveDown")
OCN_FIELDS = ("uOceanVelocity", "vOceanVelocity", "seaSurfaceTemperature",
              "oceanHeatFlux")


class SeaiceForcingManager:
    """ref: seaice_forcing_init + seaice_forcing_get
    (mpas_seaice_forcing.F). device: where get()'s tensors live (cuda:0
    when None)."""

    def __init__(self, atm_file: str | None = None,
                 ocn_file: str | None = None,
                 atm_fields=ATM_FIELDS, ocn_fields=OCN_FIELDS,
                 cycle_start=None, cycle_duration=None, device=None):
        self.device = resolve_device(device)
        self.groups = []
        if atm_file is not None:
            g = ForcingGroup("seaice_atm", cycle_start=cycle_start,
                             cycle_duration=cycle_duration,
                             device=self.device)
            s = ForcingStream(atm_file, list(atm_fields))
            for f in atm_fields:
                g.add_field(s, f)
            self.groups.append(g)
        if ocn_file is not None:
            g = ForcingGroup("seaice_ocn", cycle_start=cycle_start,
                             cycle_duration=cycle_duration,
                             device=self.device)
            s = ForcingStream(ocn_file, list(ocn_fields))
            for f in ocn_fields:
                g.add_field(s, f, interpolation="linear")
            self.groups.append(g)

    def get(self, model_time: Time, n_cells: int, n_vertices: int,
            dtype=torch.float64) -> SeaiceForcing:
        """Interpolate all groups to model_time and assemble the coupling
        struct (missing fields default to zero, the SST to -1.8 C)."""
        vals = {}
        for g in self.groups:
            vals.update(g.get_forcing(model_time))
        zc = torch.zeros(n_cells, dtype=dtype, device=self.device)
        zv = torch.zeros(n_vertices, dtype=dtype, device=self.device)

        def f(name, default):
            v = vals.get(name)
            return default if v is None else torch.as_tensor(
                v, dtype=dtype, device=self.device)

        return SeaiceForcing(
            uAirVelocity=f("uAirVelocity", zc),
            vAirVelocity=f("vAirVelocity", zc),
            airTemperature=f("airTemperature", zc),
            shortwaveDown=f("shortwaveDown", zc),
            longwaveDown=f("longwaveDown", zc),
            uOceanVelocity=f("uOceanVelocity", zc),
            vOceanVelocity=f("vOceanVelocity", zc),
            seaSurfaceTemperature=f("seaSurfaceTemperature", zc - 1.8),
            oceanHeatFlux=f("oceanHeatFlux", zc),
            sshGradientU=zv, sshGradientV=zv)

    def restart_times(self, model_time: Time) -> dict:
        """ref: mpas_forcing_write_restart_times (mpas_forcing.F:2494)."""
        out = {}
        for g in self.groups:
            out.update(g.restart_times(model_time))
        return out
