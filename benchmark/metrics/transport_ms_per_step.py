"""transport_ms_per_step: device ms a step of the operations launched
inside the program's scalar transport: its atm.transport span, once a
step (cores/atmosphere/time_integration.py: the three RK stages of
advance_scalars / advance_scalars_mono with the step's mean mass fluxes).
The program opens the span itself."""

SPANS = ()
SPAN = "atm.transport"


def read(ctx):
    if SPAN not in ctx.trace.spans:
        return None
    return 1e3 * ctx.trace.device_s_in(SPAN) / ctx.steps
