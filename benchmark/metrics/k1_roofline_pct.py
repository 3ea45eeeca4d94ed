"""k1_roofline_pct: K1 (csrc/acoustic.cu through kernels/acoustic.py)
over the traced window: the sum of each launch's byte bound over the sum
of its device times. A launch's bound is benchmark/harness/peaks.py's
k1_bytes over the HBM rate; shapes whose bytes fit the 50 MB L2 are left
out of the share (an L2-resident launch could read over 100%)."""

from benchmark.harness.peaks import HBM_BYTES_PER_S, L2_BYTES, k1_bytes


def label(nz, epssm, dts, rs_pre, *args, **kwargs):
    return f"k1:{rs_pre.shape[0]}x{nz}:{rs_pre.element_size()}"


SPANS = (("mpas_tpu_torch.cores.atmosphere.nhyd", "acoustic_cell_update",
          label),)


def read(ctx):
    bound = dev = 0.0
    for name, (n, seconds) in ctx.trace.device_s_by_span("k1:").items():
        shape, itemsize = name[3:].split(":")
        nc, nz = (int(v) for v in shape.split("x"))
        nbytes = k1_bytes(nc, nz, int(itemsize))
        if nbytes >= L2_BYTES:
            bound += n * nbytes / HBM_BYTES_PER_S
            dev += seconds
    return 100.0 * bound / dev if dev > 0.0 else None
