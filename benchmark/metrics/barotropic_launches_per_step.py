"""barotropic_launches_per_step: kernels a step launched inside the
program's barotropic subcycles (its ocn.barotropic spans): the host
dispatch that capturing or fusing the subcycle loop would cut. The
program opens the spans itself."""

SPANS = ()
SPAN = "ocn.barotropic"


def read(ctx):
    if SPAN not in ctx.trace.spans:
        return None
    launches, _ = ctx.trace.device_s_by_span(SPAN).get(SPAN, (0, 0.0))
    return launches / ctx.steps
