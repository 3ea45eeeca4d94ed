"""Python driver for the external (C++) velocity-solver interface (port of
mpas_tpu/cores/landice/external.py).

ref: src/core_landice/mode_forward/mpas_li_velocity_external.F (1,269 LoC)
— the Fortran side of the Albany/FELIX coupling: packs MPAS geometry,
calls the Interface_velocity_solver C++ layer, imports normal velocities.
Here the same lifecycle drives tools/velocity_solver/
interface_velocity_solver.cpp through ctypes.

The library is compiled from that source with the Makefile's flags into
build/mpas_tpu_torch/ (gitignored), keyed by a hash of the source and
the flags, at first use; a missing compiler raises. A host library, not
a device kernel: its inputs and outputs are host numpy arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from mpas_tpu_torch.containers import to_host

REPO = Path(__file__).resolve().parents[3]
SOURCE = REPO / "tools" / "velocity_solver" / "interface_velocity_solver.cpp"
BUILD_DIR = REPO / "build" / "mpas_tpu_torch"
# tools/velocity_solver/Makefile's CXXFLAGS, and -shared
CXX_FLAGS = ["-O2", "-std=c++17", "-Wall", "-fPIC", "-shared"]

_ip = ctypes.POINTER(ctypes.c_int)
_dp = ctypes.POINTER(ctypes.c_double)
# the C ABI of interface_velocity_solver.cpp: name -> (restype, argtypes)
_SIGNATURES = {
    "velocity_solver_set_grid_data": (None, [_ip] * 6 + [_dp] * 3),
    "velocity_solver_compute_2d_grid": (ctypes.c_int, [_ip]),
    "velocity_solver_set_parameters": (None, [_dp] * 5),
    "velocity_solver_extrude_3d_grid": (None, [_ip, _dp]),
    "velocity_solver_set_cell_areas": (None, [_dp]),
    "velocity_solver_init_fo": (None, []),
    "velocity_solver_set_fo_options": (None, [_dp, _ip, _ip]),
    "velocity_solver_solve_fo": (None, [_dp, _dp]),
    "velocity_solver_solve_fo_stokes": (None, [_dp, _dp]),
    "velocity_solver_export_fo_velocity": (None, [_dp]),
    "velocity_solver_get_n_triangles": (ctypes.c_int, []),
    "velocity_solver_get_triangles": (None, [_ip, _ip]),
    "velocity_solver_finalize": (None, []),
}


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvelocitysolver-{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the source (if this hash is not built yet); the path."""
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build "
                           f"{SOURCE.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)          # atomic: concurrent builders agree
    return path


@functools.cache
def _lib():
    cdll = ctypes.CDLL(str(build_library()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.restype, fn.argtypes = restype, argtypes
    return cdll


def _i(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.int32))


def _d(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


def _host(x, n=None, name="array"):
    """x as host numpy; with n, its leading length checked against n."""
    a = to_host(x) if hasattr(x, "detach") else np.asarray(x)
    if n is not None and a.shape[:1] != (n,):
        raise ValueError(f"{name} has shape {a.shape}, expected ({n}, ...)")
    return a


class ExternalVelocitySolver:
    """Lifecycle wrapper (ref: li_velocity_external_init/solve/finalize).
    mesh: a port Mesh (its arrays are read back to the host once)."""

    def __init__(self, mesh, n_layers: int, cfg=None):
        lib = _lib()
        self._lib = lib
        self.mesh = mesh
        self.n_layers = n_layers
        cov = _i(_host(mesh.cellsOnVertex))
        coe = _i(_host(mesh.cellsOnEdge))
        xc, yc = _d(_host(mesh.xCell)), _d(_host(mesh.yCell))
        dc = _d(_host(mesh.dcEdge))
        area = _d(_host(mesh.areaCell))
        ratios = _d(np.full(n_layers, 1.0 / n_layers))
        self._keep = (cov, coe, xc, yc, dc, area, ratios)
        lib.velocity_solver_set_grid_data(
            ctypes.byref(ctypes.c_int(mesh.nCells)),
            ctypes.byref(ctypes.c_int(mesh.nEdges)),
            ctypes.byref(ctypes.c_int(mesh.nVertices)),
            ctypes.byref(ctypes.c_int(mesh.vertexDegree)),
            cov.ctypes.data_as(_ip), coe.ctypes.data_as(_ip),
            xc.ctypes.data_as(_dp), yc.ctypes.data_as(_dp),
            dc.ctypes.data_as(_dp))
        if cfg is not None:
            lib.velocity_solver_set_parameters(
                ctypes.byref(ctypes.c_double(cfg.gravity)),
                ctypes.byref(ctypes.c_double(cfg.rho_ice)),
                ctypes.byref(ctypes.c_double(cfg.rho_seawater)),
                ctypes.byref(ctypes.c_double(cfg.config_default_flowParamA)),
                ctypes.byref(ctypes.c_double(cfg.config_flowlaw_exponent)))
        lib.velocity_solver_extrude_3d_grid(
            ctypes.byref(ctypes.c_int(n_layers)),
            ratios.ctypes.data_as(_dp))
        lib.velocity_solver_set_cell_areas(area.ctypes.data_as(_dp))
        lib.velocity_solver_init_fo()

    def set_fo_options(self, beta2: float, picard_iters: int = 10,
                       cg_iters: int = 120):
        """Basal friction + iteration counts for the native FO solve."""
        self._lib.velocity_solver_set_fo_options(
            ctypes.byref(ctypes.c_double(beta2)),
            ctypes.byref(ctypes.c_int(picard_iters)),
            ctypes.byref(ctypes.c_int(cg_iters)))

    def compute_2d_grid(self, vertices_mask) -> int:
        """Triangulate the dynamic-ice region; returns nTriangles."""
        vm = _i(_host(vertices_mask, self.mesh.nVertices, "vertices_mask"))
        return int(self._lib.velocity_solver_compute_2d_grid(
            vm.ctypes.data_as(_ip)))

    def triangles(self):
        n = int(self._lib.velocity_solver_get_n_triangles())
        tri = np.zeros(n * 3, dtype=np.int32)
        tv = np.zeros(n, dtype=np.int32)
        self._lib.velocity_solver_get_triangles(
            tri.ctypes.data_as(_ip), tv.ctypes.data_as(_ip))
        return tri.reshape(n, 3), tv

    def _solve(self, fn, thickness, bed):
        n = self.mesh.nCells
        th = _d(_host(thickness, n, "thickness"))
        bd = _d(_host(bed, n, "bed"))
        fn(th.ctypes.data_as(_dp), bd.ctypes.data_as(_dp))
        out = np.zeros(self.mesh.nEdges * (self.n_layers + 1))
        self._lib.velocity_solver_export_fo_velocity(
            out.ctypes.data_as(_dp))
        return out.reshape(self.mesh.nEdges, self.n_layers + 1)

    def solve_fo(self, thickness, bed):
        """FO solve; returns uNormal (nEdges, nLayers+1), host numpy."""
        return self._solve(self._lib.velocity_solver_solve_fo, thickness,
                           bed)

    def solve_fo_stokes(self, thickness, bed):
        """Full native FO (Blatter-Pattyn) solve: Picard + CG in C++,
        same discretization as fo_stokes.py. Returns uNormal
        (nEdges, nLayers+1), host numpy."""
        return self._solve(self._lib.velocity_solver_solve_fo_stokes,
                           thickness, bed)

    def finalize(self):
        self._lib.velocity_solver_finalize()
