"""dyn_tend_ms_per_step: device ms a step of the kernels launched inside
the dycore terms (nhyd.compute_dyn_tend, as srk3_step calls it)."""

SPANS = (("mpas_tpu_torch.cores.atmosphere.time_integration",
          "compute_dyn_tend", "compute_dyn_tend"),)


def read(ctx):
    if "compute_dyn_tend" not in ctx.trace.spans:
        return None
    return 1e3 * ctx.trace.device_s_in("compute_dyn_tend") / ctx.steps
