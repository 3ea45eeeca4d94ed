"""bgc_ms_per_step: device ms a step of the operations launched inside
the program's ocean biogeochemistry: its ocn.bgc spans
(cores/ocean/bgc.py: ecosys_step and carbon_step). The program opens the
spans itself."""

SPANS = ()
SPAN = "ocn.bgc"


def read(ctx):
    if SPAN not in ctx.trace.spans:
        return None
    return 1e3 * ctx.trace.device_s_in(SPAN) / ctx.steps
