"""The port's dry JW slice end to end on the CPU (float64, 642 cells).

The 24-step trajectory is held to the reference's frozen golden at the
golden's own tolerances (tests/test_parity_dycore.py), dry mass to
roundoff, and the package must run without JAX.
"""

import dataclasses
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


@pytest.mark.parametrize("what", ["microphysics", "moist", "exchange"])
def test_srk3_step_refuses_unported_paths(mesh, what):
    kw = {"config_microp_scheme": "mp_kessler"} \
        if what == "microphysics" else {}
    grid, cfg, state, carry = _setup(mesh, 2, 1200.0, **kw)
    xch = None
    if what == "moist":
        moist = state.scalars.new_zeros(state.scalars.shape[:2] + (3,))
        carry = dataclasses.replace(
            carry, state=dataclasses.replace(state, scalars=moist))
    if what == "exchange":
        xch = object()
    with pytest.raises(NotImplementedError):
        srk3_step(grid, cfg, carry, cfg.config_dt, xch=xch)


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
import mpas_tpu_torch.convert
bad = [m for m in sys.modules if m.split(".")[0] in BLOCK]
sys.exit(1 if bad else 0)
"""


def test_package_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
