"""launches_per_step: kernels the card ran in the traced window, per step
(the step driver's host dispatch: every launch costs host time)."""

SPANS = ()


def read(ctx):
    return ctx.trace.kernel_count() / ctx.steps
