"""Build the CUDA sources in mpas_tpu_torch/csrc into one shared library
with a plain C interface, and load it with ctypes.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/mpas_tpu_torch/<lib>.so csrc/*.cu

The library name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the last build. It is built at first
use, from the checkout's sources only, into build/mpas_tpu_torch/ at the
repository root.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mpas_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    # (device, nC, nz, epssm, dts, inputs[20], outputs[4], stream)
    "mpas_acoustic_cell_update": [ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_double,
                                  ctypes.c_double, _PP, _PP, _P],
    # (device, nC, P, I, K, w, x, out, stream)
    "mpas_tinydot": [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was reused
    log: str               # nvcc/ptxas output of the build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.cache
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"libmpas_kernels-{digest.hexdigest()[:16]}.so"
    build_seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
        path.with_suffix(".log").write_text(log)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, build_seconds=build_seconds,
                         log=log)


def check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
