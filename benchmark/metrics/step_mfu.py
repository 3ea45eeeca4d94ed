"""step_mfu: the whole step's share of the card's roofline. The least
time a step could take is its counted bytes (the configuration's
bytes_per_step: from shapes and stage counts, never from the program's
kernels) over the HBM rate; the share is that over the traced window's
mean step time. No operation count is kept, so the bytes bound it."""

from benchmark.harness.peaks import bound_s

SPANS = ()


def read(ctx):
    least, _ = bound_s(ctx.bytes_per_step)
    return 100.0 * least / (ctx.trace.window_s / ctx.steps)
