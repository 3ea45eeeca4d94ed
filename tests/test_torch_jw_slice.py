"""The port's dry JW slice end to end on the CPU (float64, 642 cells).

The 24-step trajectory is held to the reference's frozen golden at the
golden's own tolerances (tests/test_parity_dycore.py), dry mass to
roundoff, and the package must run without JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
from mpas_tpu_torch.cores.atmosphere.time_integration import (init_carry,
                                                              run_steps,
                                                              srk3_step)
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "jw_case2.npz"
RTOL = 1e-9       # tests/test_parity_dycore.py:27-28
ATOL = 1e-11


@pytest.fixture(scope="module")
def mesh():
    return icosahedral_mesh(8, lloyd_iters=2)


def _setup(mesh, case, dt, **cfg_kw):
    cfg = AtmConfig(config_nvertlevels=10, config_len_disp=960000.0,
                    config_dt=dt, **cfg_kw)
    grid, state, diag = init_jw(mesh, cfg, case=case)
    return grid, cfg, state, init_carry(grid, cfg, state, diag, dt)


def test_jw_trajectory_matches_golden(mesh):
    grid, cfg, _, carry = _setup(mesh, 2, 1200.0,
                                 config_number_of_sub_steps=2)
    out = run_steps(grid, cfg, carry, cfg.config_dt, 24)
    golden = np.load(GOLDEN)
    for key in golden.files:
        g = golden[key]
        v = getattr(out.state, key).numpy()
        assert v.shape == g.shape, key
        err = np.abs(v - g)
        tol = ATOL + RTOL * np.abs(g)
        assert (err <= tol).all(), (
            f"{key}: worst err/tol {float((err / tol).max()):.3g}")


def test_dry_mass_conserved_to_roundoff(mesh):
    grid, cfg, s0, carry = _setup(mesh, 1, 2400.0)
    area = grid.mesh.areaCell[:, None]
    m0 = float((s0.rho_zz * area).sum())
    out = run_steps(grid, cfg, carry, cfg.config_dt, 12)
    m1 = float((out.state.rho_zz * area).sum())
    assert abs(m1 - m0) / m0 < 1e-12
    assert all(bool(torch.isfinite(getattr(out.state, k)).all())
               for k in ("u", "w", "theta_m", "rho_zz", "scalars"))


def test_float32_step_after_to(mesh):
    grid, cfg, _, carry = _setup(mesh, 2, 1200.0)
    cpu, f32 = torch.device("cpu"), torch.float32
    grid, carry = grid.to(cpu, f32), carry.to(cpu, f32)
    assert carry.state.u.dtype == f32 and carry.v.dtype == f32
    assert grid.mesh.edgesOnCell.dtype == torch.int64
    out = srk3_step(grid, cfg, carry, cfg.config_dt)
    assert all(getattr(out.state, k).dtype == f32
               and bool(torch.isfinite(getattr(out.state, k)).all())
               for k in ("u", "w", "theta_m", "rho_zz", "scalars"))


@pytest.mark.parametrize("what", ["mp_wsm6", "mp_thompson", "mp_kessler",
                                  "exchange"])
def test_srk3_step_refuses_unported_paths(mesh, what):
    """Kessler needs (qv, qc, qr), WSM6 six species and Thompson eight;
    the JW state carries one scalar, which the reference rejects with
    ValueError too (Thompson with eight species is not ported, and
    raises NotImplementedError: tests/test_torch_physics.py). The
    exchange hooks are ported (the sharded runner,
    tests/test_torch_distributed.py): identity hooks are accepted and
    leave the step exactly as it is without them."""
    kw = {} if what == "exchange" else {"config_microp_scheme": what}
    grid, cfg, state, carry = _setup(mesh, 2, 1200.0, **kw)
    assert state.scalars.shape[-1] == 1
    if what == "exchange":
        from mpas_tpu_torch.cores.atmosphere.time_integration import NO_XCH
        a = srk3_step(grid, cfg, carry, cfg.config_dt, xch=NO_XCH)
        b = srk3_step(grid, cfg, carry, cfg.config_dt)
        for k in ("u", "w", "theta_m", "rho_zz", "scalars"):
            assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
        return
    with pytest.raises(ValueError):
        srk3_step(grid, cfg, carry, cfg.config_dt)


def test_srk3_step_rejects_unknown_scheme(mesh):
    grid, cfg, _, carry = _setup(mesh, 2, 1200.0,
                                 config_microp_scheme="mp_unknown")
    with pytest.raises(ValueError):
        srk3_step(grid, cfg, carry, cfg.config_dt)


_NO_JAX = """
import sys
BLOCK = ("jax", "jaxlib", "flax", "mpas_tpu")
for m in list(sys.modules):
    if m.split(".")[0] in BLOCK:
        del sys.modules[m]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import mpas_tpu_torch.cores.atmosphere.time_integration
import mpas_tpu_torch.cores.atmosphere.init_supercell
import mpas_tpu_torch.cores.atmosphere.moisture
import mpas_tpu_torch.cores.atmosphere.physics.driver
import mpas_tpu_torch.cores.atmosphere.hooks
import mpas_tpu_torch.cores.atmosphere.physics.manager
import mpas_tpu_torch.cores.atmosphere.physics.rrtmg
import mpas_tpu_torch.cores.atmosphere.physics.wsm6
import mpas_tpu_torch.cores.atmosphere.physics.thompson
import mpas_tpu_torch.cores.atmosphere.physics.mynn_sfc
import mpas_tpu_torch.cores.atmosphere.physics.mynn
import mpas_tpu_torch.cores.atmosphere.physics.gf
import mpas_tpu_torch.cores.atmosphere.physics.kfeta
import mpas_tpu_torch.cores.atmosphere.physics.convection
import mpas_tpu_torch.cores.atmosphere.physics.cam_radiation
import mpas_tpu_torch.cores.atmosphere.physics.o3
import mpas_tpu_torch.cores.atmosphere.physics.oml
import mpas_tpu_torch.cores.atmosphere.physics.urban
import mpas_tpu_torch.cores.atmosphere.diagnostics.manager
import mpas_tpu_torch.ops.reconstruct
import mpas_tpu_torch.tools.mesoref_noon
import mpas_tpu_torch.tools.op_count
import mpas_tpu_torch.mesh.planar
import mpas_tpu_torch.mesh.varres
import mpas_tpu_torch.cores.sw.time_integration
import mpas_tpu_torch.cores.sw.test_cases
import mpas_tpu_torch.cores.sw.global_diagnostics
import mpas_tpu_torch.cores.ocean.core
import mpas_tpu_torch.cores.ocean.init_channel
import mpas_tpu_torch.cores.ocean.vmix
import mpas_tpu_torch.cores.ocean.kpp
import mpas_tpu_torch.ops.matrix
import mpas_tpu_torch.convert
import mpas_tpu_torch.parallel.partition
import mpas_tpu_torch.parallel.layout
import mpas_tpu_torch.parallel.runner
import mpas_tpu_torch.cores.atmosphere.distributed
import mpas_tpu_torch.cores.ocean.distributed
import mpas_tpu_torch.cores.sw.distributed
import mpas_tpu_torch.ops.remap
import mpas_tpu_torch.cores.seaice.config
import mpas_tpu_torch.cores.seaice.state
import mpas_tpu_torch.cores.seaice.variational
import mpas_tpu_torch.cores.seaice.velocity
import mpas_tpu_torch.cores.seaice.advection
import mpas_tpu_torch.cores.seaice.remap
import mpas_tpu_torch.cores.seaice.thermo_vertical
import mpas_tpu_torch.cores.seaice.shortwave_dedd
import mpas_tpu_torch.cores.seaice.mushy
import mpas_tpu_torch.cores.seaice.zsalinity
import mpas_tpu_torch.cores.seaice.ponds
import mpas_tpu_torch.cores.seaice.ridging
import mpas_tpu_torch.cores.seaice.itd
import mpas_tpu_torch.cores.seaice.tracers
import mpas_tpu_torch.cores.seaice.snow
import mpas_tpu_torch.cores.seaice.bgc
import mpas_tpu_torch.cores.seaice.orbital
import mpas_tpu_torch.cores.seaice.column
import mpas_tpu_torch.cores.seaice.init_square
import mpas_tpu_torch.cores.seaice.core
import mpas_tpu_torch.tools.seaice_box
import mpas_tpu_torch.cores.seaice.analysis
import mpas_tpu_torch.cores.seaice.forcing_adapter
import mpas_tpu_torch.cores.seaice.distributed
import mpas_tpu_torch.cores.landice
import mpas_tpu_torch.cores.landice.config
import mpas_tpu_torch.cores.landice.core
import mpas_tpu_torch.cores.landice.init_dome
import mpas_tpu_torch.cores.landice.fo_stokes
import mpas_tpu_torch.cores.landice.thermal_enthalpy
import mpas_tpu_torch.cores.landice.advection_ir
import mpas_tpu_torch.cores.landice.calving
import mpas_tpu_torch.cores.landice.hydro
import mpas_tpu_torch.cores.landice.statistics
import mpas_tpu_torch.cores.landice.external
import mpas_tpu_torch.cores.landice.distributed
import mpas_tpu_torch.mesh.reorder
import mpas_tpu_torch.ops.rbf
import mpas_tpu_torch.ops.spline
import mpas_tpu_torch.ops.tensor
import mpas_tpu_torch.tools.landice_dome
bad = [m for m in sys.modules if m.split(".")[0] in BLOCK]
sys.exit(1 if bad else 0)
"""


def test_package_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
