"""The card's peaks and the two hand kernels' byte counts: the yardstick
of every roofline and `step_mfu`.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense rates, at the
700 W power limit). The byte counts are frozen copies of the port's
`kernels/acoustic.py:bytes_moved` and `kernels/tinydot.py:bytes_moved`
(each input read once, each output written once), so that a change to the
program cannot move them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}   # outside the tensor cores
L2_BYTES = 50e6


def bound_s(nbytes: float, flops: float = 0.0, dtype: str = "float32"):
    """(seconds, "bytes" or "flops"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")


def k1_bytes(nc: int, nz: int, itemsize: int) -> int:
    """K1 (acoustic_cell_update): 6 level and 12 interface inputs read
    once, 2 level and 2 interface outputs written once a column, plus the
    two (nz,) columns cofrz and rdzw."""
    return itemsize * (nc * (8 * nz + 14 * (nz + 1)) + 2 * nz)


def k2_bytes(nc: int, P: int, I: int, K: int, itemsize: int) -> int:
    """K2 (tinydot, cpi,cik->cpk): w and x read once, out written once."""
    return itemsize * nc * (P * I + I * K + P * K)
