"""The port's regional boundary zones and IAU against the reference
package (float64, CPU): the zone masks bit for bit on a limited-area
mesh, the LBC time interpolation, the relaxation-zone nudging and the
specified-zone reset on cells and edges, and the IAU tendencies inside
and after the window, each at 1e-12 of the field's largest value.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import boundaries as jbdy
from mpas_tpu.cores.atmosphere import iau as jiau
from mpas_tpu.mesh.planar import box_hex_mesh as jbox
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere import boundaries as tbdy
from mpas_tpu_torch.cores.atmosphere import iau as tiau
from mpas_tpu_torch.cores.init_atmosphere.surface_lbc import LbcRecord
from mpas_tpu_torch.mesh.planar import box_hex_mesh as tbox

torch.set_num_threads(1)

NZ = 5


def _close(got, want, name, tol=1e-12):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale, name


def _flatten(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def masks():
    jm, tm = jbox(20, 20, 10000.0), tbox(20, 20, 10000.0)
    return jbdy.build_bdy_masks(jm), tbdy.build_bdy_masks(tm), tm


def test_masks_match_the_reference_bit_for_bit(masks):
    jmask, tmask, tm = masks
    for f in dataclasses.fields(tmask):
        got, want = getattr(tmask, f.name), np.asarray(getattr(jmask,
                                                               f.name))
        assert got.shape == want.shape, f.name
        assert np.array_equal(got.numpy(), want), f.name
    assert tmask.bdyMaskCell.dtype == torch.int64
    zones = set(tmask.bdyMaskCell.numpy().tolist())
    assert zones == set(range(tbdy.N_BDY_ZONE + 1))
    moved = tmask.to("cpu", torch.float32)
    assert moved.specCell.dtype == torch.float32
    assert moved.bdyMaskEdge.dtype == torch.int64
    back = convert.bdy_masks_from_arrays(_flatten(jmask))
    for f in dataclasses.fields(tmask):
        assert torch.equal(getattr(back, f.name).to(getattr(tmask,
                                                            f.name).dtype),
                           getattr(tmask, f.name)), f.name


def _fields(tm, seed):
    rng = np.random.default_rng(seed)
    return {"cell": rng.standard_normal((tm.nCells, NZ)),
            "edge": rng.standard_normal((tm.nEdges, NZ)),
            "cell3": rng.standard_normal((tm.nCells, NZ, 2))}


@pytest.mark.parametrize("where", ["cell", "edge", "cell3"])
def test_relax_and_spec_zones_match_the_reference(where, masks):
    jmask, tmask, tm = masks
    field, driving = _fields(tm, 1)[where], _fields(tm, 2)[where]
    on_edges = where == "edge"
    for dt in (12.0, 600.0):
        got = tbdy.relaxzone_tend(tmask, dt, torch.from_numpy(field),
                                  torch.from_numpy(driving), on_edges)
        want = jbdy.relaxzone_tend(jmask, dt, jnp.asarray(field),
                                   jnp.asarray(driving), on_edges)
        _close(got, want, f"relax {where}")
    got = tbdy.speczone_reset(tmask, torch.from_numpy(field),
                              torch.from_numpy(driving), on_edges)
    want = jbdy.speczone_reset(jmask, jnp.asarray(field),
                               jnp.asarray(driving), on_edges)
    _close(got, want, f"spec {where}")
    spec = (tmask.specEdge if on_edges else tmask.specCell).numpy() > 0
    assert np.array_equal(got.numpy()[spec], driving[spec])
    assert np.array_equal(got.numpy()[~spec], field[~spec])


@pytest.mark.parametrize("now", [-100.0, 0.0, 5400.0, 21600.0, 30000.0])
def test_lbc_interp_matches_the_reference(now, masks):
    _, _, tm = masks
    a, b = _fields(tm, 3), _fields(tm, 4)
    t1, t2 = 0.0, 21600.0
    want = jbdy.lbc_interp({k: jnp.asarray(v) for k, v in a.items()},
                           {k: jnp.asarray(v) for k, v in b.items()},
                           t1, t2, now)
    got = tbdy.lbc_interp({k: torch.from_numpy(v) for k, v in a.items()},
                          {k: torch.from_numpy(v) for k, v in b.items()},
                          t1, t2, now)
    for k in a:
        _close(got[k], want[k], k)
    # an LbcRecord of tensors, through the dataclass branch
    rec = [LbcRecord(time=t, lbc_u=torch.from_numpy(x["edge"]),
                     lbc_theta=torch.from_numpy(x["cell"]),
                     lbc_rho=torch.from_numpy(x["cell"]),
                     lbc_w=torch.from_numpy(x["cell"]),
                     lbc_scalars=torch.from_numpy(x["cell3"]))
           for t, x in (("t1", a), ("t2", b))]
    mid = tbdy.lbc_interp(rec[0], rec[1], t1, t2, now)
    assert mid.time == "t1"
    _close(mid.lbc_u, want["edge"], "lbc_u")
    _close(mid.lbc_scalars, want["cell3"], "lbc_scalars")


def test_lbc_record_converts_from_the_reference(masks):
    _, _, tm = masks
    x = _fields(tm, 5)
    from mpas_tpu.cores.init_atmosphere.surface_lbc import LbcRecord as JRec
    j = JRec(time="t", lbc_u=x["edge"], lbc_theta=x["cell"],
             lbc_rho=x["cell"], lbc_w=x["cell"], lbc_scalars=x["cell3"])
    got = convert.lbc_record_from_arrays(dataclasses.asdict(j))
    assert got.time == "t" and np.array_equal(got.lbc_u, x["edge"])


def _increments(tm, seed, qv=True):
    rng = np.random.default_rng(seed)
    d = {"theta_incr": rng.standard_normal((tm.nCells, NZ)),
         "rho_incr": 1e-3 * rng.standard_normal((tm.nCells, NZ)),
         "u_incr": rng.standard_normal((tm.nEdges, NZ)),
         "qv_incr": 1e-4 * rng.standard_normal((tm.nCells, NZ))
         if qv else None}
    return (jiau.IAUIncrements(**d),
            convert.iau_increments_from_arrays(d))


@pytest.mark.parametrize("qv", [True, False])
@pytest.mark.parametrize("elapsed", [0.0, 3600.0, 21599.0, 21600.0,
                                     86400.0])
def test_iau_tendencies_match_the_reference(elapsed, qv, masks):
    _, _, tm = masks
    jinc, tinc = _increments(tm, 6, qv)
    rho = np.random.default_rng(7).uniform(0.5, 1.2, (tm.nCells, NZ))
    cfg_j, cfg_t = jiau.IAUConfig("on"), tiau.IAUConfig("on")
    want = jiau.iau_tendencies(cfg_j, jinc, jnp.asarray(rho), elapsed)
    for el in (elapsed, torch.tensor(elapsed, dtype=torch.float64)):
        got = tiau.iau_tendencies(cfg_t, tinc, torch.from_numpy(rho), el)
        for name, g, w in zip(("rt", "rho", "u", "qv"), got, want):
            if w is None:
                assert g is None
                continue
            assert g.dtype == torch.float64
            if elapsed >= cfg_t.config_IAU_window_length_s:
                assert float(g.abs().max()) == 0.0
                assert float(np.abs(np.asarray(w)).max()) == 0.0
            else:
                _close(g, w, name)
    moved = tinc.to("cpu", torch.float32)
    assert moved.theta_incr.dtype == torch.float32
