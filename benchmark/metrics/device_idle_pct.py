"""device_idle_pct: the share of the traced window in which no operation
ran on the card, from the window's one timeline."""

SPANS = ()


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
