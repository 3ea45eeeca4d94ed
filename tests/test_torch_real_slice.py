"""The real-data slice end to end on the CPU (float64, 642 cells, 10
levels, 3 steps): the port's init_real + run_steps against the
reference's init_real + run_steps.

The reference's init_real fills only the indexed advection stencil
(adv_coefs), and its dycore takes the indexed path for such a grid; the
port's dycore has only the factored path. So the port is held to two
reference runs: the indexed one at 1e-9 x max, and the same grid given
the factored tensors by the reference's own builders at 1e-11 x max. On
the terrain grid the factored edge values equal the indexed contraction.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import setup as jsetup
from mpas_tpu.cores.atmosphere import time_integration as jti
from mpas_tpu.cores.atmosphere.config import AtmConfig as JConfig
from mpas_tpu.cores.init_atmosphere import met_reader as jmr
from mpas_tpu.cores.init_atmosphere.real_case import init_real as jinit
from mpas_tpu.mesh.sphere import icosahedral_mesh as jico
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere import advection as tadvection
from mpas_tpu_torch.cores.atmosphere import nhyd as tnhyd
from mpas_tpu_torch.cores.atmosphere import setup as tsetup
from mpas_tpu_torch.cores.atmosphere import time_integration as tti
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig as TConfig
from mpas_tpu_torch.cores.init_atmosphere import met_reader as tmr
from mpas_tpu_torch.cores.init_atmosphere.real_case import init_real
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh as tico
from mpas_tpu_torch.ops import stencils as tstencils
from tests.test_init_real import _synthetic_gfs_full

torch.set_num_threads(1)

N_STEPS = 3
CFG = dict(config_nvertlevels=10, config_dt=1200.0,
           config_len_disp=960000.0)
FIELDS = ("u", "w", "theta_m", "rho_zz", "scalars")
K1_PER_STEP = 12        # 3 substeps x (1 + 1 + 2) acoustic iterations
K2_PER_STEP = 15        # 3 + 9 dynamics + 3 transport (one scalar)


def _flatten(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _flatten(v)
        elif v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = _synthetic_gfs_full(tmp_path_factory.mktemp("met"))
    jc, tc = JConfig(**CFG), TConfig(**CFG)
    jg, js, jd, _ = jinit(jico(8, lloyd_iters=2), jc,
                          jmr.read_met_file(path))
    dt = jc.config_dt

    def jrun(grid):
        gj = jax.tree.map(jnp.asarray, grid)
        carry = jti.init_carry(gj, jc, jax.tree.map(jnp.asarray, js),
                               jax.tree.map(jnp.asarray, jd), dt)
        out = jti.run_steps(gj, jc, carry, dt, N_STEPS)
        return {k: np.asarray(getattr(out.state, k)) for k in FIELDS}

    bmats = jsetup.build_cell_fit_matrices(jg.mesh)
    d2_bmat, d2w = jsetup.build_adv_factored(jg.mesh, bmats)
    own, opp, sside, dv = jsetup.build_adv_cell_tensors(jg.mesh)
    jg_fac = jg.replace(d2_bmat=d2_bmat, d2w=d2w,
                        adv_beta=jc.config_coef_3rd_order, d2w_own=own,
                        d2w_opp=opp, adv_sside=sside, dv_cell=dv)

    grid, state, diag, extras = init_real(tico(8, lloyd_iters=2), tc,
                                          tmr.read_met_file(path))
    carry = tti.init_carry(grid, tc, state, diag, dt)
    out = tti.run_steps(grid, tc, carry, dt, N_STEPS)
    return {"indexed": jrun(jg), "factored": jrun(jg_fac),
            "port": {k: getattr(out.state, k).numpy() for k in FIELDS},
            "start": (grid, state, diag, carry), "cfg": tc,
            "jgrid": jg, "jstart": (js, jd)}


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("ref,tol", [("indexed", 1e-9), ("factored", 1e-11)])
def test_trajectory_matches_the_reference(runs, ref, tol, field):
    got, want = runs["port"][field], runs[ref][field]
    assert np.all(np.isfinite(got))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{field}: {err:.3g} of {scale:.3g}"


def test_reference_grid_converts_and_runs_as_the_port_init(runs):
    """The reference's real-data grid, which lacks the factored tensors,
    converts into a port grid that steps as the port's own init does."""
    jg = runs["jgrid"]
    with pytest.raises(ValueError, match="adv_beta"):
        convert.grid_from_arrays(_flatten(jg))
    grid = convert.grid_from_arrays(_flatten(jg), adv_beta=0.25)
    js, jd = runs["jstart"]
    state = convert.state_from_arrays(_flatten(js))
    diag = convert.diag_from_arrays(_flatten(jd))
    own = runs["start"][0]
    for name in ("d2_bmat", "d2w", "d2w_own", "d2w_opp", "adv_sside",
                 "dv_cell", "zz", "zb_cell", "pressure_base"):
        a, b = getattr(grid, name), getattr(own, name)
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    cfg = runs["cfg"]
    carry = tti.init_carry(grid, cfg, state, diag, cfg.config_dt)
    out = tti.run_steps(grid, cfg, carry, cfg.config_dt, N_STEPS)
    for k in FIELDS:
        got, want = getattr(out.state, k).numpy(), runs["port"][k]
        assert float(np.abs(got - want).max()) \
            <= 1e-11 * float(np.abs(want).max()), k


def test_factored_edge_values_equal_the_indexed_stencil(runs):
    """On the terrain grid, the port's factored (base, third) edge values
    of a cell field equal the indexed adv_coefs contraction."""
    grid = runs["start"][0]
    mesh = grid.mesh
    bmats = tsetup.build_cell_fit_matrices(mesh)
    adv_cells, coefs, coefs3, _ = tsetup.build_adv_coefs(
        mesh, tsetup.build_deriv_two(mesh, bmats), grid.adv_beta)
    psi = torch.from_numpy(np.asarray(grid.zgrid[:, :-1]
                                      + 300.0 * runs["start"][1].theta_m))
    base, third = tadvection.edge_value_parts(grid, psi)
    g = psi.numpy()[adv_cells.astype(np.int64)]          # (nE, N_ADV, K)
    want_base = np.einsum("ej,ejk->ek", coefs, g)
    want_third = np.einsum("ej,ejk->ek", coefs3, g)
    for got, want in ((base, want_base), (third, want_third)):
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= 1e-12 * scale


def test_dry_mass_and_water_are_conserved(runs):
    grid, state, _, _ = runs["start"]
    vol = (grid.vert.dzw[None, :] * grid.mesh.areaCell[:, None]).numpy()
    for name, start, end in (
            ("dry mass", state.rho_zz.numpy(), runs["port"]["rho_zz"]),
            ("qv", (state.rho_zz * state.scalars[..., 0]).numpy(),
             runs["port"]["rho_zz"] * runs["port"]["scalars"][..., 0])):
        m0, m1 = (start * vol).sum(), (end * vol).sum()
        assert abs(m1 - m0) <= 1e-12 * m0, name
    assert runs["port"]["scalars"].min() >= 0.0
    assert np.abs(runs["port"]["u"]).max() < 150.0


def test_kernel_calls_per_step(runs, monkeypatch):
    """One real-data step calls K1 12 times at nz levels and K2 15 times:
    (nC, 6, 6, nz) x 3, (nC, 6, 6, 2 nz) x 9 and (nC, 3, 6, nz) x 3, the
    shapes real_120km's gate counts at 55 levels."""
    calls = collections.Counter()

    def counting(name, fn):
        def call(*args, **kwargs):
            if name == "K1":
                calls[("K1", args[0])] += 1
            else:
                w, x = args[0], args[1]
                calls[("K2", w.shape[1], w.shape[2], x.shape[2])] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tnhyd, "acoustic_cell_update",
                        counting("K1", tnhyd.acoustic_cell_update))
    monkeypatch.setattr(tstencils, "tinydot",
                        counting("K2", tstencils.tinydot))
    monkeypatch.setattr(tadvection, "tinydot",
                        counting("K2", tadvection.tinydot))
    grid, _, _, carry = runs["start"]
    cfg = runs["cfg"]
    tti.srk3_step(grid, cfg, carry, cfg.config_dt)
    nz = cfg.config_nvertlevels
    assert calls == {("K1", nz): K1_PER_STEP, ("K2", 6, 6, nz): 3,
                     ("K2", 6, 6, 2 * nz): 9, ("K2", 3, 6, nz): 3}
    assert sum(v for k, v in calls.items() if k[0] == "K2") == K2_PER_STEP
