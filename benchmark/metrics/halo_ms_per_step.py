"""halo_ms_per_step: device ms a step of the operations launched inside
the program's halo exchanges, its par.halo spans (parallel/runner.py:
ShardExchange, one span an exchange of a cell, edge or vertex field: the
gathers of the values to send, the NCCL send and receive kernels, the
splice), on the trace of the rank that sets the pace. An NCCL kernel's
time includes its wait for the slower peer. The program opens the spans
itself; a program without them (an older tree) gives nothing."""

SPANS = ()
SPAN = "par.halo"


def read(ctx):
    if SPAN not in ctx.trace.spans:
        return None
    return 1e3 * ctx.trace.device_s_in(SPAN) / ctx.steps
