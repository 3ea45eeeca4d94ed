"""k2_roofline_pct: K2 (csrc/tinydot.cu through kernels/tinydot.py) over
the traced window: the sum of each launch's byte bound over the sum of
its device times. A launch's bound is benchmark/harness/peaks.py's
k2_bytes over the HBM rate; shapes whose bytes fit the 50 MB L2 (the
ocean's barotropic K = 1, the atmosphere's (3, 6, 26)) are left out of
the share."""

from benchmark.harness.peaks import HBM_BYTES_PER_S, L2_BYTES, k2_bytes


def label(w, x, *args, **kwargs):
    nc, P, I = w.shape
    return f"k2:{nc}x{P}x{I}x{x.shape[2]}:{w.element_size()}"


SPANS = (("mpas_tpu_torch.ops.stencils", "tinydot", label),
         ("mpas_tpu_torch.cores.atmosphere.advection", "tinydot", label))


def read(ctx):
    bound = dev = 0.0
    for name, (n, seconds) in ctx.trace.device_s_by_span("k2:").items():
        shape, itemsize = name[3:].split(":")
        nc, P, I, K = (int(v) for v in shape.split("x"))
        nbytes = k2_bytes(nc, P, I, K, int(itemsize))
        if nbytes >= L2_BYTES:
            bound += n * nbytes / HBM_BYTES_PER_S
            dev += seconds
    return 100.0 * bound / dev if dev > 0.0 else None
