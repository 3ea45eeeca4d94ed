"""barotropic_ms_per_step: device ms a step of the operations launched
inside the program's barotropic subcycles: its ocn.barotropic spans, one
per outer pass of cores/ocean/core.py:split_step (the subcycle loop
through the 'finalBtrFields' exchange). The program opens the spans
itself."""

SPANS = ()
SPAN = "ocn.barotropic"


def read(ctx):
    if SPAN not in ctx.trace.spans:
        return None
    return 1e3 * ctx.trace.device_s_in(SPAN) / ctx.steps
