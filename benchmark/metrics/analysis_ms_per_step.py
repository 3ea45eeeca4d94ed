"""analysis_ms_per_step: device ms a step of the kernels launched inside
the ocean's analysis layer: the due members (AnalysisDriver.compute_due)
and the particle trackers (ParticleTracker.cell_velocity and .step)."""

SPANS = (("mpas_tpu_torch.cores.ocean.analysis",
          "AnalysisDriver.compute_due", "analysis"),
         ("mpas_tpu_torch.cores.ocean.analysis.particles",
          "ParticleTracker.cell_velocity", "analysis"),
         ("mpas_tpu_torch.cores.ocean.analysis.particles",
          "ParticleTracker.step", "analysis"))


def read(ctx):
    if "analysis" not in ctx.trace.spans:
        return None
    return 1e3 * ctx.trace.device_s_in("analysis") / ctx.steps
