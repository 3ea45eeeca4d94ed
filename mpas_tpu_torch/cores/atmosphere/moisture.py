"""Checks of the moist path: a seeded cloud-and-rain start and the dry-air
and water budgets.

The supercell's own warm bubble forms cloud and rain only after some
minutes of model time. `seeded_moisture` puts cloud, rain and a vapour
perturbation into the initial state, so that the first steps already
condense, evaporate, autoconvert and sediment. `masses` gives the two
budgets the moist step must keep.
"""

from __future__ import annotations

import numpy as np
import torch

from mpas_tpu_torch.cores.atmosphere.physics.driver import IDX_QG, IDX_QV

RHO_WATER = 1000.0   # kg/m^3, converts rainnc (m) to kg/m^2


def seeded_moisture(mesh, scalars, seed):
    """(qv, qc, qr) with cloud and rain in a Gaussian blob (6 km e-folding)
    at the domain centre: qc up to 2.5 g/kg on levels 1-6, qr up to 3 g/kg
    on levels 3-9, and qv there scaled by 0.85-1.30, so that the blob holds
    supersaturated and subsaturated cells and cloud above the
    autoconversion threshold. The draws come from numpy's
    default_rng(seed); `mesh` and `scalars` may be numpy, JAX or CPU torch
    arrays. Returns a new float64 CPU tensor."""
    rng = np.random.default_rng(seed)
    sc = np.array(scalars, dtype=np.float64)
    nc, nz, _ = sc.shape
    x, y = np.asarray(mesh.xCell), np.asarray(mesh.yCell)
    blob = np.exp(-((x - x.mean()) ** 2 + (y - y.mean()) ** 2)
                  / 6000.0 ** 2)[:, None]
    lev = np.arange(nz)[None, :]
    sc[:, :, 1] = 2.5e-3 * blob * ((lev >= 1) & (lev <= 6)) \
        * rng.uniform(0.5, 1.0, (nc, nz))
    sc[:, :, 2] = 3e-3 * blob * ((lev >= 3) & (lev <= 9)) \
        * rng.uniform(0.5, 1.0, (nc, nz))
    sc[:, :, 0] *= 1.0 + blob * rng.uniform(-0.15, 0.3, (nc, nz))
    return torch.from_numpy(sc)


def masses(grid, carry):
    """(dry-air mass, total water) in kg, summed in float64 on the carry's
    device. Dry air is rho_zz*dzw*area per layer, the quantity the
    flux-form dycore conserves; total water is that mass times the sum of
    the mixing ratios the state carries among qv, qc, qr, qi, qs, qg
    (scalars 0-5; never the number concentrations of Thompson's 6-7), plus
    the accumulated surface precipitation (rainnc x RHO_WATER x area)."""
    area = grid.mesh.areaCell.double()
    air = carry.state.rho_zz.double() * grid.vert.dzw.double() \
        * area[:, None]
    q = carry.state.scalars.double()[..., IDX_QV:IDX_QG + 1].sum(-1)
    water = (air * q).sum() + (carry.rainnc.double() * RHO_WATER
                               * area).sum()
    return float(air.sum()), float(water)
