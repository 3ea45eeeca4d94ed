"""Minimal NetCDF-3 (classic + 64-bit offset) reader/writer, and the
dispatch to the netCDF4/HDF5 reader (port of mpas_tpu/io/netcdf.py).

Stands in for the reference's PIO/netCDF layer (ref: src/framework/
mpas_io.F wraps PIO for pnetcdf/netcdf I/O). scipy.io.netcdf_file handles
the classic format, which is what MPAS grid.nc and output files use, so
files interchange with the reference's. A record (unlimited) dimension
'Time' matches the reference stream convention.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file


def read_netcdf(path: str, variables=None):
    """Read variables + dims + attrs from a NetCDF file into numpy.

    Dispatches on the file magic: classic NetCDF-3 via scipy, netCDF4/HDF5
    ('\\x89HDF') via the pure-python HDF5 parser (io/hdf5.py), as the
    reference's multi-iotype open does (ref: mpas_io.F:144-200)."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic[:4] == b"\x89HDF":
        from mpas_tpu_torch.io.hdf5 import read_hdf5
        return read_hdf5(path, variables)
    out = {}
    with netcdf_file(path, "r", mmap=False) as f:
        dims = dict(f.dimensions)
        names = variables if variables is not None else list(f.variables)
        for name in names:
            arr = np.array(f.variables[name][:])
            # netCDF stores big-endian; torch.from_numpy takes native order
            if arr.dtype.byteorder == ">":
                arr = arr.astype(arr.dtype.newbyteorder("="))
            out[name] = arr
        attrs = dict(f._attributes)
    return out, dims, attrs


def write_netcdf(path: str, dims: dict, variables: dict, attrs: dict = None):
    """Write a NetCDF-3 64-bit-offset file.

    dims: {name: size or None (None = record/unlimited)}.
    variables: {name: (dim_names_tuple, ndarray)}.
    """
    with netcdf_file(path, "w", version=2) as f:
        for k, v in (attrs or {}).items():
            setattr(f, k, v)
        for name, size in dims.items():
            f.createDimension(name, size)
        for name, (dnames, arr) in variables.items():
            arr = np.asarray(arr)
            # scipy netcdf supports int32/float32/float64/char
            if arr.dtype == np.int64:
                arr = arr.astype(np.int32)
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            var = f.createVariable(name, arr.dtype, dnames)
            var[:] = arr


def append_record(path_vars: dict, rec_arrays: dict):
    """Accumulate records in memory before a write (scipy's netcdf_file
    has no true append)."""
    for k, v in rec_arrays.items():
        path_vars.setdefault(k, []).append(np.asarray(v))
