"""acoustic_ms_per_step: device ms a step of the operations launched
inside the program's acoustic substeps: its atm.acoustic spans, one per
RK stage of every dynamics substep (cores/atmosphere/time_integration.py:
set_smlstep_pert_variables, the acoustic_step loop with K1, and
divergence_damping_3d). The program opens the spans itself."""

SPANS = ()
SPAN = "atm.acoustic"


def read(ctx):
    if SPAN not in ctx.trace.spans:
        return None
    return 1e3 * ctx.trace.device_s_in(SPAN) / ctx.steps
