"""ocean_dyn_ms_per_step: device ms a step of the kernels launched inside
the ocean's dynamics (core.ocn_timestep: surface forcing, the
split-explicit step, the implicit vertical mix)."""

SPANS = (("mpas_tpu_torch.cores.ocean.core", "ocn_timestep",
          "ocn_timestep"),)


def read(ctx):
    if "ocn_timestep" not in ctx.trace.spans:
        return None
    return 1e3 * ctx.trace.device_s_in("ocn_timestep") / ctx.steps
