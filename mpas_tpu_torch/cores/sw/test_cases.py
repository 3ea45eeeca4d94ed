"""Williamson et al. (1992) shallow-water test cases 1, 2, 5 and 6 (port of
mpas_tpu/cores/sw/test_cases.py).

ref: src/core_sw/mpas_sw_test_cases.F (sw_test_case_1 :116, _2 :230, _5
:366, _6 :534). Host numpy in float64 on a unit-sphere mesh, scaled to the
Earth's radius as the reference does in place (ref: :303-318). Each case
returns (mesh, SWState, h_s) as CPU float64 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.constants import a, gravity, omega, pii
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.mesh.mesh import Mesh


def _np(x):
    return x.numpy()


def _psi_velocity(mesh: Mesh, psi_vertex):
    """u = -(psi(v2) - psi(v1)) / dvEdge: the streamfunction's normal wind,
    discretely divergence-free (ref: :326-333)."""
    v1 = _np(mesh.verticesOnEdge)[:, 0]
    v2 = _np(mesh.verticesOnEdge)[:, 1]
    return -(psi_vertex[v2] - psi_vertex[v1]) / _np(mesh.dvEdge)


def _coriolis(mesh: Mesh, alpha):
    def f(lat, lon):
        return 2.0 * omega * (-np.cos(lon) * np.cos(lat) * np.sin(alpha)
                              + np.sin(lat) * np.cos(alpha))
    return (f(_np(mesh.latEdge), _np(mesh.lonEdge)),
            f(_np(mesh.latVertex), _np(mesh.lonVertex)),
            f(_np(mesh.latCell), _np(mesh.lonCell)))


def _sphere_distance(lat1, lon1, lat2, lon2, radius):
    arg = np.sqrt(np.sin(0.5 * (lat2 - lat1)) ** 2
                  + np.cos(lat1) * np.cos(lat2)
                  * np.sin(0.5 * (lon2 - lon1)) ** 2)
    return 2.0 * radius * np.arcsin(arg)


def _finalize(mesh, u, h, h_s, fE, fV, fC, n_tracers, tracers=None):
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))

    mesh = dataclasses.replace(mesh, fEdge=t(fE), fVertex=t(fV), fCell=t(fC))
    if tracers is None:
        tracers = np.zeros((mesh.nCells, n_tracers))
    return mesh, SWState(u=t(u), h=t(h), tracers=t(tracers)), t(h_s)


def test_case_1(mesh: Mesh, n_tracers: int = 2):
    """Advection of a cosine bell over the pole (ref: :116-228)."""
    mesh = mesh.scaled(a)
    u0 = 2.0 * pii * a / (12.0 * 86400.0)
    h0, theta_c, lambda_c, alpha = 1000.0, 0.0, 3.0 * pii / 2.0, pii / 4.0
    latV, lonV = _np(mesh.latVertex), _np(mesh.lonVertex)
    psi = -a * u0 * (np.sin(latV) * np.cos(alpha)
                     - np.cos(lonV) * np.cos(latV) * np.sin(alpha))
    u = _psi_velocity(mesh, psi)
    r = _sphere_distance(theta_c, lambda_c, _np(mesh.latCell),
                         _np(mesh.lonCell), a)
    h = np.where(r < a / 3.0, (h0 / 2.0) * (1.0 + np.cos(pii * r * 3.0 / a)),
                 h0 / 2.0)
    fE, fV, fC = _coriolis(mesh, alpha)
    return _finalize(mesh, u, h, np.zeros(mesh.nCells), fE, fV, fC, n_tracers)


def test_case_2(mesh: Mesh, alpha: float = 0.0, n_tracers: int = 2):
    """Steady-state nonlinear zonal geostrophic flow (ref: :230-365)."""
    mesh = mesh.scaled(a)
    u0 = 2.0 * pii * a / (12.0 * 86400.0)
    gh0 = 29400.0
    latV, lonV = _np(mesh.latVertex), _np(mesh.lonVertex)
    psi = -a * u0 * (np.sin(latV) * np.cos(alpha)
                     - np.cos(lonV) * np.cos(latV) * np.sin(alpha))
    u = _psi_velocity(mesh, psi)
    fE, fV, fC = _coriolis(mesh, alpha)
    latC, lonC = _np(mesh.latCell), _np(mesh.lonCell)
    h = (gh0 - (a * omega * u0 + 0.5 * u0 ** 2)
         * (-np.cos(lonC) * np.cos(latC) * np.sin(alpha)
            + np.sin(latC) * np.cos(alpha)) ** 2) / gravity
    return _finalize(mesh, u, h, np.zeros(mesh.nCells), fE, fV, fC, n_tracers)


def test_case_5(mesh: Mesh, n_tracers: int = 2):
    """Zonal flow over an isolated mountain (ref: :366-543)."""
    mesh = mesh.scaled(a)
    u0, gh0, hs0 = 20.0, 5960.0 * gravity, 2000.0
    theta_c, lambda_c, rr, alpha = pii / 6.0, 3.0 * pii / 2.0, pii / 9.0, 0.0
    latV, lonV = _np(mesh.latVertex), _np(mesh.lonVertex)
    psi = -a * u0 * (np.sin(latV) * np.cos(alpha)
                     - np.cos(lonV) * np.cos(latV) * np.sin(alpha))
    u = _psi_velocity(mesh, psi)
    fE, fV, fC = _coriolis(mesh, alpha)
    latC = _np(mesh.latCell)
    lonC = np.where(_np(mesh.lonCell) < 0.0, _np(mesh.lonCell) + 2.0 * pii,
                    _np(mesh.lonCell))
    r = np.sqrt(np.minimum(rr ** 2, (lonC - lambda_c) ** 2
                           + (latC - theta_c) ** 2))
    h_s = hs0 * (1.0 - r / rr)
    h = (gh0 - (a * omega * u0 + 0.5 * u0 ** 2)
         * (-np.cos(lonC) * np.cos(latC) * np.sin(alpha)
            + np.sin(latC) * np.cos(alpha)) ** 2) / gravity - h_s
    tr = np.zeros((mesh.nCells, n_tracers))
    tr[:, 0] = 1.0 - r / rr
    if n_tracers > 1:
        r2 = np.sqrt(np.minimum(rr ** 2, (lonC - lambda_c) ** 2
                                + (latC - theta_c - pii / 6.0) ** 2))
        tr[:, 1] = 1.0 - r2 / rr
    return _finalize(mesh, u, h, h_s, fE, fV, fC, n_tracers, tracers=tr)


def test_case_6(mesh: Mesh, n_tracers: int = 2):
    """Rossby-Haurwitz wave (ref: :534-620 and aa/bb/cc :668-724)."""
    mesh = mesh.scaled(a)
    h0, w, K, R = 8000.0, 7.848e-6, 7.848e-6, 4.0
    latV, lonV = _np(mesh.latVertex), _np(mesh.lonVertex)
    psi = -a * a * w * np.sin(latV) \
        + a * a * K * np.cos(latV) ** R * np.sin(latV) * np.cos(R * lonV)
    u = _psi_velocity(mesh, psi)
    fE, fV, fC = _coriolis(mesh, 0.0)
    th, lon = _np(mesh.latCell), _np(mesh.lonCell)
    c = np.cos(th)
    aa = 0.5 * w * (2.0 * omega + w) * c ** 2 + 0.25 * K ** 2 \
        * c ** (2.0 * R) * ((R + 1.0) * c ** 2 + 2.0 * R ** 2 - R - 2.0
                            - 2.0 * R ** 2 * c ** -2.0)
    bb = (2.0 * (omega + w) * K / ((R + 1.0) * (R + 2.0))) * c ** R \
        * ((R ** 2 + 2.0 * R + 2.0) - ((R + 1.0) * c) ** 2)
    cc = 0.25 * K ** 2 * c ** (2.0 * R) * ((R + 1.0) * c ** 2 - R - 2.0)
    h = (gravity * h0 + a * a * aa + a * a * bb * np.cos(R * lon)
         + a * a * cc * np.cos(2.0 * R * lon)) / gravity
    return _finalize(mesh, u, h, np.zeros(mesh.nCells), fE, fV, fC, n_tracers)


SETUPS = {1: test_case_1, 2: test_case_2, 5: test_case_5, 6: test_case_6}
