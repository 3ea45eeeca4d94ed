"""halo_exchanges_per_step: the program's halo exchanges a step, its
par.halo spans opened in the traced window over the steps (parallel/
runner.py:ShardExchange, one a cell, edge or vertex exchange), on the
trace of the rank that sets the pace: the count that batching a stage's
exchanges would cut. A program without the span (an older tree) gives
nothing."""

SPANS = ()
SPAN = "par.halo"


def read(ctx):
    spans = ctx.trace.spans.get(SPAN)
    if not spans:
        return None
    lo, hi = ctx.trace.window
    return sum(1 for start, _ in spans if lo <= start <= hi) / ctx.steps
