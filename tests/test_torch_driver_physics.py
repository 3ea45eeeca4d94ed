"""The port's command line against the JAX package's run driver with the
atmosphere's physics suite on, in float64 on the CPU: the supercell (init
case 5) on the 144-cell doubly periodic 2-km plane, 10 levels, Kessler
microphysics and config_physics_suite set, so that every step runs
PhysicsConfig() (Kain-Fritsch, YSU, the MM5 surface layer, the slab LSM,
broadband radiation) before the dynamics, as the reference's hook does.

Two legs of 2 steps (dt 12 s), the second a restart, in each package
(tests/test_torch_driver.py has the helpers and the other cores); every
field of every file within 1e-9 x max|ref|. Most of this file's time is
the JAX package's compile of its coupled step.
"""

import pytest
import torch

from tests.test_torch_driver import (assert_same_files, nc_files, port_runner,
                                     run_jax, run_legs)

torch.set_num_threads(1)

CASE = ("hex:12,12,2000",
        ["config_dt = 12.0", "config_nvertlevels = 10",
         "config_len_disp = 2000.0", "config_xnutr = 0.0",
         "config_init_case = 5", "config_microp_scheme = 'mp_kessler'",
         "config_physics_suite = 'mesoscale_reference'"],
        "0:00:24")


@pytest.fixture(scope="module")
def physics_legs(tmp_path_factory):
    d = tmp_path_factory.mktemp("physics")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPAS_TPU_CACHE", str(d / "jax_cache"))
        mp.setenv("MPAS_TPU_TORCH_CACHE", str(d / "torch_cache"))
        yield (run_legs("atmosphere", d / "port", port_runner, CASE),
               run_legs("atmosphere", d / "jax", run_jax, CASE))


def test_cli_with_physics_matches_jax_driver(physics_legs):
    assert_same_files(*physics_legs)


def test_cli_with_physics_restarts(physics_legs):
    port_dir, _ = physics_legs
    assert nc_files(port_dir) == [
        "output.atmosphere.0000-01-01_00.00.00.nc",
        "output.atmosphere.0000-01-01_00.00.24.nc",
        "output.atmosphere.0000-01-01_00.00.48.nc",
        "restart.atmosphere.0000-01-01_00.00.24.nc",
        "restart.atmosphere.0000-01-01_00.00.48.nc"]
    log = (port_dir / "log.atmosphere.0000.out").read_text()
    assert "Restarted from restart stream at 0000-01-01_00:00:24" in log
    assert "completed step 2/2 (0000-01-01_00:00:48)" in log
