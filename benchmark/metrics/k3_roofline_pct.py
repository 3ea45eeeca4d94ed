"""k3_roofline_pct: K3 (csrc/vmix.cu through kernels/vmix.py), the ocean's
implicit vertical-mix column solve, over the traced window: the sum of
each launch's byte bound over the sum of its device times. A launch's
bound is k3_bytes below over the HBM rate; shapes whose bytes fit the
50 MB L2 are left out of the share. The label wraps the solve that the
ocean core calls; a program without it (an older tree) opens no such
label, and the metric gives nothing."""

import importlib

from benchmark.harness.peaks import HBM_BYTES_PER_S, L2_BYTES

CORE = "mpas_tpu_torch.cores.ocean.core"


def k3_bytes(n: int, nz: int, ntr: int, itemsize: int) -> int:
    """K3 (vmix_solve) on n columns of nz levels and ntr right-hand sides:
    the field read and written, the thickness, the nz-1 interface
    diffusivities and the level mask read once (a frozen copy of
    kernels/vmix.py:bytes_moved)."""
    return itemsize * n * (2 * nz * ntr + 3 * nz - 1)


def label(field, *args, **kwargs):
    n, nz = field.shape[:2]
    ntr = field.shape[2] if field.dim() == 3 else 1
    return f"k3:{n}x{nz}x{ntr}:{field.element_size()}"


def _spans():
    try:
        core = importlib.import_module(CORE)
    except ImportError:
        return ()
    return ((CORE, "vmix_solve", label),) if hasattr(core, "vmix_solve") \
        else ()


SPANS = _spans()


def read(ctx):
    bound = dev = 0.0
    for name, (n, seconds) in ctx.trace.device_s_by_span("k3:").items():
        shape, itemsize = name[3:].split(":")
        cols, nz, ntr = (int(v) for v in shape.split("x"))
        nbytes = k3_bytes(cols, nz, ntr, int(itemsize))
        if nbytes >= L2_BYTES:
            bound += n * nbytes / HBM_BYTES_PER_S
            dev += seconds
    return 100.0 * bound / dev if dev > 0.0 else None
