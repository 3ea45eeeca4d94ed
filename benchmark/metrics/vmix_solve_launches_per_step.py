"""vmix_solve_launches_per_step: kernels a step launched inside the
program's implicit vertical-mix solves (its ocn.vmix_solve spans): the
host dispatch of the ocean's column solves, two where each solve is one
kernel. The program opens the spans itself; a program without them (an
older tree) gives nothing."""

SPANS = ()
SPAN = "ocn.vmix_solve"


def read(ctx):
    if SPAN not in ctx.trace.spans:
        return None
    launches, _ = ctx.trace.device_s_by_span(SPAN).get(SPAN, (0, 0.0))
    return launches / ctx.steps
